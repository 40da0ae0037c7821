"""Plain reference of the Myers family: the banded semi-global edit DP that
the Myers bit-vector kernels compute, written out cell by cell in torch.

It imports nothing of the program.  The band of a pair is the Myers
window: K_of(W) 32-row words below a boundary row, anchored at word
``fwd_anchor(d0, W)`` and shifted down one word after every 32 columns
while the pair has columns left.  Per column j (consuming b[j]):

  D'[0] = D[0] + 1                                    (the boundary row)
  D'[r] = min(D[r-1] + (a[row_r - 1] != b[j]), D[r] + 1, D'[r-1] + 1)

with free start in a (every row 0 at column 0), rows outside [1, la]
holding a code that matches nothing, and the rows a shift brings in
starting one above the row over them.  The forward pass takes the best
endpoint on row la (each column) or in column lb (rows 0..la), cost first,
then the larger i + j, the earlier candidate on a full tie; every 128
columns the band minimum over rows 0..la feeds the two-grid WINDOW
statistic.  The reverse pass runs the same DP over the reversed consumed
prefixes, anchored at (iend, jend) with D[row, 0] = |row|, in a window of
K_of(W) + 3 words, and recovers the start as the row of least cost at
column jend, the largest on ties.  Returns int64 (cost, i0, iend, jend,
win), cost = BIG where the forward pass found no endpoint.
"""
from __future__ import annotations

import torch

WB = 32
BIG = 1 << 15
MBIG = 1 << 28
PAD = 4
WINDOW = 256


def K_of(W: int) -> int:
    return -(-(W + 63) // WB) + 1


def _fdiv(x, m: int):
    return torch.div(x, m, rounding_mode="floor")


def fwd_anchor(d0, W: int):
    return _fdiv(d0 - W // 2, WB) - 1


def _window_codes(rows, first, length, n: int, flat, LA: int):
    """[B, n] codes of row ``rows`` at positions first .. first + n - 1,
    PAD outside [0, length)."""
    pos = first[:, None] + torch.arange(n, device=first.device)[None, :]
    ok = (pos >= 0) & (pos < length[:, None])
    got = flat[rows[:, None] * LA + pos.clamp(0, LA - 1)].long()
    return torch.where(ok, got, PAD)


def _step(D, achars, bj, act, iota):
    """One column of the DP on [B, R + 1] rows (row 0 the boundary)."""
    sub = (achars != bj[:, None]).to(D.dtype)
    x = torch.cat([D[:, :1] + 1, torch.minimum(D[:, :-1] + sub, D[:, 1:] + 1)], dim=1)
    Dn = torch.cummin(x - iota, dim=1).values + iota
    return torch.where(act[:, None], Dn, D)


def _shift(D, act_s, shift_in):
    """Move the window one word down where act_s."""
    Dn = torch.cat([D[:, WB:], D[:, -1:] + shift_in], dim=1)
    return torch.where(act_s[:, None], Dn, D)


def forward(flat, LA: int, lengths, a_oid, b_oid, d0, W: int, jcap):
    """(cost, iend, jend, win) int64; cost MBIG where no endpoint.  jcap
    [B] is each pair's column bucket: it runs columns j < min(lb, jcap)."""
    dev = d0.device
    B = d0.shape[0]
    K = K_of(W)
    R = K * WB
    la, lb = lengths[a_oid >> 1].long(), lengths[b_oid >> 1].long()
    top = WB * fwd_anchor(d0, W)  # absolute row of the boundary
    iota = torch.arange(R + 1, device=dev)[None, :]
    shift_in = torch.arange(1, WB + 1, device=dev)[None, :]
    D = torch.zeros(B, R + 1, dtype=torch.int64, device=dev)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    bc, bsum, bi, bj = zero + MBIG, zero - (1 << 30), zero.clone(), zero.clone()
    wprev, wmax, wprev2, wmax2 = zero, zero, zero, zero
    win_cap = torch.minimum(torch.minimum(lb, la - d0 - W // 2), jcap)
    lb_run = torch.minimum(lb, jcap)
    nblk = jcap // WB  # the blocks each pair's bucket holds

    def consider(cost, iend, jend, mask):
        nonlocal bc, bsum, bi, bj
        s = iend + jend
        better = mask & ((cost < bc) | ((cost == bc) & (s > bsum)))
        bc = torch.where(better, cost, bc)
        bsum = torch.where(better, s, bsum)
        bi = torch.where(better, iend, bi)
        bj = torch.where(better, jend, bj)

    ncols = int(lb_run.max()) if B else 0
    bT = _window_codes(b_oid, zero, lb, max(ncols, 1), flat, LA).T.contiguous()
    for blk in range(-(-ncols // WB)):
        achars = _window_codes(a_oid, top, la, R, flat, LA)
        r_la = la - top
        la_in = (r_la >= 0) & (r_la <= R)
        r_la = r_la.clamp(0, R)[:, None]
        for j in range(blk * WB, min(ncols, (blk + 1) * WB)):
            act = j < lb_run
            D = _step(D, achars, bT[j], act, iota)
            consider(D.gather(1, r_la)[:, 0], la, zero + (j + 1), act & la_in)
        if blk % 4 == 3:  # band minimum at column (blk + 1) * 32
            rows = top[:, None] + iota
            bm = torch.where((rows >= 0) & (rows <= la[:, None]), D, MBIG).min(dim=1).values
            in_cap = (blk + 1) * WB <= win_cap
            if blk % 8 == 7:
                wmax = torch.where(in_cap, torch.maximum(wmax, bm - wprev), wmax)
                wprev = bm
            else:
                if blk != 3:  # the half-size first span is not scored
                    wmax2 = torch.where(in_cap, torch.maximum(wmax2, bm - wprev2), wmax2)
                wprev2 = bm
        act_s = ((blk + 1) * WB < lb) & (blk < nblk)
        D = _shift(D, act_s, shift_in)
        top = torch.where(act_s, top + WB, top)

    # column lb, for pairs whose b ends inside the bucket
    rows = top[:, None] + iota
    costs = torch.where((rows >= 0) & (rows <= la[:, None]), D, MBIG)
    m1 = costs.min(dim=1).values
    row = torch.where(costs == m1[:, None], rows, -(1 << 40)).max(dim=1).values
    consider(m1, row, lb, (m1 < MBIG) & (lb <= jcap))
    return bc, bi, bj, torch.maximum(wmax, wmax2)


def reverse(flat, LA: int, a_oid, b_oid, d0, iend, jend, W: int):
    """Start recovery: (cost, best reverse row) int64 of the DP anchored at
    (iend, jend) over the reversed prefixes a[:iend], b[:jend]."""
    dev = d0.device
    B = d0.shape[0]
    Kr = K_of(W) + 3
    R = Kr * WB
    base = WB * fwd_anchor(d0, W)
    top = WB * (_fdiv((iend - jend) - base - WB * K_of(W), WB) - 1)
    iota = torch.arange(R + 1, device=dev)[None, :]
    shift_in = torch.arange(1, WB + 1, device=dev)[None, :]
    D = (top[:, None] + iota).abs()
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    ncols = int(jend.max()) if B else 0
    # reversed b: rb[j] = b[jend - 1 - j]
    jj = torch.arange(max(ncols, 1), device=dev)[None, :]
    src = jend[:, None] - 1 - jj
    rbT = torch.where(src >= 0, flat[b_oid[:, None] * LA + src.clamp(0, LA - 1)].long(), PAD).T.contiguous()
    for blk in range(-(-ncols // WB)):
        # row top + r (r >= 1) reads the reversed a at top + r - 1: a[iend - top - r]
        x = top[:, None] + torch.arange(R, device=dev)[None, :]
        srcs = iend[:, None] - 1 - x
        ok = (x >= 0) & (srcs >= 0)
        achars = torch.where(ok, flat[a_oid[:, None] * LA + srcs.clamp(0, LA - 1)].long(), PAD)
        for j in range(blk * WB, min(ncols, (blk + 1) * WB)):
            D = _step(D, achars, rbT[j], j < jend, iota)
        act_s = (blk + 1) * WB < jend
        D = _shift(D, act_s, shift_in)
        top = torch.where(act_s, top + WB, top)
    rows = top[:, None] + iota
    costs = torch.where((rows >= 0) & (rows <= iend[:, None]), D, MBIG)
    bc = costs.min(dim=1).values
    br = torch.where(costs == bc[:, None], rows, -(1 << 40)).max(dim=1).values
    return bc, br


def myers_pairs(codes, lengths, a_oid, b_oid, d0, W: int, J: int, jcap=None):
    """The Myers family's answer for each pair: (cost, i0, iend, jend, win)
    int64 [B].  codes [2N, LA] uint8 oriented rows, lengths [N] per read;
    ``jcap`` [B] (<= J) each pair's own column bucket, J for all if None."""
    LA = codes.shape[1]
    flat = codes.reshape(-1)
    a_oid, b_oid, d0 = a_oid.long(), b_oid.long(), d0.long()
    jcap = torch.full_like(d0, J) if jcap is None else jcap.long()
    cost_f, iend, jend, win = forward(flat, LA, lengths, a_oid, b_oid, d0, W, jcap)
    cost_r, best_row = reverse(flat, LA, a_oid, b_oid, d0, iend, jend, W)
    i0 = torch.where(jend == 0, iend, iend - best_row)
    cost_r = torch.where(jend == 0, 0, cost_r)
    ok = cost_f < MBIG
    z = torch.zeros_like(cost_f)
    return (torch.where(ok, cost_r, BIG), torch.where(ok, i0, z), torch.where(ok, iend, z),
            torch.where(ok, jend, z), torch.where(ok, win, z))
