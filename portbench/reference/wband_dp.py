"""Plain reference of the W-band family: a frozen copy of the port's plain
``dp_core`` and its staging (``phasm_tpu_torch/overlap/extend.py``, itself
the bit-identical twin of the JAX reference's ``dp_core``), which imports
nothing of the program.

The band of a pair is the W diagonals d0 - W/2 .. d0 + W/2 - 1 around its
seed diagonal; a cell packs (cost, start offset) so one min keeps the
cheaper path and, on ties, the earlier start.  Endpoints: row la in the
band at each column, and column lb (the best cell, smallest band offset on
ties); among them the least cost, then the longer alignment.  Every 128
columns the band minimum feeds the two-grid WINDOW statistic.  Costs of
2^15 or more count as no endpoint.
"""
from __future__ import annotations

import torch

BIG = 1 << 15
BIGK = 1 << 30
WINDOW = 256


def dp_core(a2, b2, la, lb, d0, band: int, jcap=None):
    """The W-band DP.  a2 [B, J + W] band-aligned a codes,
    b2 [B, J] (any integer type); la/lb/d0 [B].  Returns int64 (cost, i0,
    a_end, b_end, win).  ``jcap`` [B], where given, is each pair's own
    column bucket (<= J): its columns from jcap on count as past its b, as
    if the pair ran alone at J = jcap.

    The column loop stops after the batch's longest b: past a pair's lb
    every cell is invalid, no endpoint fires and no window is in its cap,
    so the skipped columns change nothing."""
    B, J = b2.shape
    W = band
    la, lb, d0 = la.long(), lb.long(), d0.long()
    dev = b2.device
    lw = max(7, (W - 1).bit_length())
    pack = 1 << lw
    BIGPW = (1 << 15) * pack
    iota_w = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    half = W // 2
    d0c, lac, lbc = d0[:, None], la[:, None], lb[:, None]
    base = d0 - half  # i0 = s_rel + base

    i_at_j0 = d0c + iota_w - half
    P = torch.where((i_at_j0 >= 0) & (i_at_j0 <= lac), iota_w, BIGPW)
    win_cap = torch.minimum(lb, la - d0 - half)
    lb_run = lb  # the columns each pair runs
    if jcap is not None:
        lb_run = torch.minimum(lb, jcap.long())
        win_cap = torch.minimum(win_cap, jcap.long())
    lbc = lb_run[:, None]

    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    bcost, blen, bi0, bie, bje = zero + int(BIG), zero - 1, zero, zero, zero
    wprev, wmax, wprev2, wmax2 = zero, zero, zero, zero
    big_col = torch.full((B, 1), BIGPW, dtype=torch.int64, device=dev)
    wpk = iota_w * pack

    def key(p, w):
        """Endpoint key cost << (lw+1) | (W-1 - w + s_rel) of packed cells."""
        return torch.where(p < BIGPW, ((p >> lw) << (lw + 1)) + (W - 1 - w + (p & (pack - 1))), BIGK)

    def consider(j, cand_key, w_sel, mask):
        nonlocal bcost, blen, bi0, bie, bje
        ck = torch.where(mask, cand_key, BIGK)
        cost = ck >> (lw + 1)
        mid = ck & ((1 << (lw + 1)) - 1)
        i0 = mid - (W - 1) + w_sel + base
        i_end = torch.minimum(d0 + (j + 1) + w_sel - half, la)
        alen = (i_end - i0) + (j + 1)
        better = (ck < BIGK) & ((cost < bcost) | ((cost == bcost) & (alen > blen)))
        bcost = torch.where(better, cost, bcost)
        blen = torch.where(better, alen, blen)
        bi0 = torch.where(better, i0, bi0)
        bie = torch.where(better, i_end, bie)
        bje = torch.where(better, zero + (j + 1), bje)

    ncols = min(J, int(lb_run.max())) if B else 0
    end_cols = set(lb.tolist())  # columns j + 1 where some pair's b ends
    w_la0 = la - d0 + half - 1  # band cell on row la at column j: w_la0 - j
    for j in range(ncols):
        sub = (a2[:, j : j + W] != b2[:, j : j + 1]) * pack
        up = torch.cat([P[:, 1:], big_col], dim=1) + pack
        x = torch.minimum(P + sub, up) - wpk
        Pn = torch.cummin(x, dim=1).values + wpk  # left dependency
        i_cell = i_at_j0 + (j + 1)
        valid = (i_cell >= 0) & (i_cell <= lac) & (j < lbc)
        P = torch.where(valid, Pn.clamp(max=BIGPW), BIGPW)

        # endpoint i == la: the one band cell on row la, when in the band
        w_la = w_la0 - j
        in_band = (w_la >= 0) & (w_la < W)
        w_la = w_la.clamp(0, W - 1)
        k_la = key(P.gather(1, w_la[:, None])[:, 0], w_la)
        consider(j, k_la, w_la, in_band & (k_la < BIGK))
        # endpoint j + 1 == lb: best cell of the final column, smallest w on ties
        if j + 1 in end_cols:
            key1 = key(P, iota_w)
            k_be = key1.min(dim=1).values
            w_be = torch.where(key1 == k_be[:, None], iota_w, W).min(dim=1).values
            consider(j, k_be, w_be, (lb == j + 1) & (k_be < BIGK))

        if (j + 1) % (WINDOW // 2) == 0:  # windowed-divergence probe
            colmin = (P >> lw).min(dim=1).values
            in_cap = (j + 1) <= win_cap
            if (j + 1) % WINDOW == 0:
                wmax = torch.where(in_cap, torch.maximum(wmax, colmin - wprev), wmax)
                wprev = colmin
            else:
                if j + 1 != WINDOW // 2:  # half-size first span: not scored
                    wmax2 = torch.where(
                        in_cap, torch.maximum(wmax2, colmin - wprev2), wmax2
                    )
                wprev2 = colmin
    return bcost, bi0, bie, bje, torch.maximum(wmax, wmax2)


def stage_pairs(codes, lengths, a_oid, b_oid, d0, W: int, J: int):
    """Band windows of each pair, gathered on the codes' device:
    a2[p, t] = a[d0 + t - W/2] for t < J + W (254 outside the read) and
    b2[p, j] = b[j] for j < J (255 past lb), both uint8 [M, *]; la, lb
    int32 [M].  Rows stay pairs-major, one pair's window contiguous."""
    a_oid, b_oid = a_oid.long(), b_oid.long()
    la, lb = lengths[a_oid >> 1], lengths[b_oid >> 1]
    LA = codes.shape[1]
    dev = codes.device
    flat = codes.reshape(-1)
    ai = d0.long()[:, None] + torch.arange(J + W, device=dev)[None, :] - W // 2
    a_ok = (ai >= 0) & (ai < la.long()[:, None])
    a2 = torch.where(a_ok, flat[a_oid[:, None] * LA + ai.clamp(0, LA - 1)], 254)
    jj = torch.arange(J, device=dev)[None, :]
    b_ok = jj < lb.long()[:, None]
    b2 = torch.where(b_ok, flat[b_oid[:, None] * LA + jj.clamp(max=LA - 1)], 255)
    return a2, b2, la.to(torch.int32), lb.to(torch.int32)


def wband_pairs(codes, lengths, a_oid, b_oid, d0, W: int, J: int, jcap=None):
    """The W-band family's answer for each pair: (cost, i0, iend, jend,
    win) int64 [B].  codes [2N, LA] uint8 oriented rows, lengths [N];
    ``jcap`` [B] (<= J) each pair's own column bucket, J for all if None."""
    a2, b2, la, lb = stage_pairs(codes, lengths, a_oid, b_oid, d0, W, J)
    return dp_core(a2, b2, la, lb, d0, W, jcap)
