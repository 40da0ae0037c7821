"""Plain PyTorch Myers bit-vector block-band pair core.

Twin of ``phasm_tpu.overlap.myers._myers_pair_core`` (``_fwd_prep``,
``myers_fwd_core``, ``_rev_prep``, ``myers_rev_core``) with the same
contract: ``(cost, i0, iend, jend, win)``, ``cost == BIG`` when the forward
pass finds no endpoint.  It is the CPU path of the Myers family and the
on-card reference that kernels 1 and 2 (``csrc/myers.cu``) are held to.

torch has no uint32 add, shift, not or compare on the CPU, so every 32-bit
band word is carried in an int64 and masked with ``MASK``.  Codes >= 4 never
match (plane 4 of every match-mask word is zero).

One liberty, exact by construction: the column loop stops after the batch's
longest b (``lb.max()``).  Past a pair's own lb every column is inactive,
every shift is gated off and no window is still in its cap, so the skipped
blocks change nothing.
"""
from __future__ import annotations

import torch

from phasm_tpu.overlap.extend import BIG
from phasm_tpu.overlap.myers import MBIG, WB, K_of, fwd_anchor, rev_K, rev_anchor

MASK = 0xFFFFFFFF
PAD = 4  # code that never matches


def _word_step(Eq, Pv, Mv, hp, hn):
    """One Myers word update on masked int64 words.  Returns (VP', VN',
    Ph and Mh before their shift, carry-out hp, carry-out hn)."""
    Xv = Eq | Mv
    Eq2 = Eq | hn
    Xh = ((((Eq2 & Pv) + Pv) & MASK) ^ Pv) | Eq2
    Ph = Mv | (MASK ^ (Xh | Pv))
    Mh = Pv & Xh
    hout_p = Ph >> 31
    hout_n = Mh >> 31
    Phs = ((Ph << 1) & MASK) | hp
    Mhs = ((Mh << 1) & MASK) | hn
    VP = Mhs | (MASK ^ (Xv | Phs))
    VN = Phs & Xv
    return VP, VN, Ph, Mh, hout_p, hout_n


def popcount32(x):
    """SWAR popcount of int64 tensors holding 32-bit words."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def _bits(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _build_peq(win, NBLK: int):
    """win [B, NBLK*32] codes -> peq [NBLK, 5, B] match-mask words (bit t of
    word w: win[32w + t] == plane); plane 4 is all-zero for PAD codes."""
    B = win.shape[0]
    winT = win.T.reshape(NBLK, WB, B)
    t = _bits(WB, win.device)[None, :, None]
    planes = [((winT == c).long() << t).sum(dim=1) for c in range(4)]
    planes.append(torch.zeros_like(planes[0]))
    return torch.stack(planes, dim=1)


def _band_runs(VP, VN, s_top):
    """Row values below the band anchor: [K*32, B], runs[r] = value at rel
    row anchor + r + 1 (prefix sum of the vertical delta bits)."""
    K, B = VP.shape
    t = _bits(WB, VP.device)[None, :, None]
    bp = (VP[:, None, :] >> t) & 1
    bn = (VN[:, None, :] >> t) & 1
    return s_top[None, :] + torch.cumsum((bp - bn).reshape(K * WB, B), dim=0)


def _select_eq(pq, code):
    """pq [K, 5, B], code [B] (clamped to <= 4) -> Eq words [K, B]."""
    K, _, B = pq.shape
    return pq.gather(1, code.view(1, 1, B).expand(K, 1, B)).squeeze(1)


def fwd_prep(a_rows, b_rows, la, lb, d0, W: int, J: int):
    """Forward window (twin of ``_fwd_prep``): (peq [NBLK, 5, B],
    b2T [J, B], la_rel [B], m0 [B]), all int64."""
    B, LA = a_rows.shape
    dev = a_rows.device
    NBLK = J // WB + K_of(W)
    R = NBLK * WB
    m0 = fwd_anchor(d0, W)
    absr = m0[:, None] * WB + _bits(R, dev)[None, :]
    ok = (absr >= 0) & (absr < la[:, None])
    win = torch.where(ok, a_rows.gather(1, absr.clamp(0, LA - 1)), PAD)
    peq = _build_peq(win, NBLK)
    LB = b_rows.shape[1]
    jcol = _bits(J, dev)[None, :]
    b_src = b_rows.gather(1, jcol.clamp(max=LB - 1).expand(B, J))
    b2T = torch.where((jcol < lb[:, None]) & (jcol < LB), b_src, PAD).T
    return peq, b2T.contiguous(), la - m0 * WB, m0


def rev_prep(a_rows, b_rows, la, lb, iend, jend, d0, W: int, J: int):
    """Reverse window over the reversed consumed prefixes (twin of
    ``_rev_prep``): (peq_r [NBLKr, 5, B], b2T_r [J, B], row_off [B])."""
    B, LA = a_rows.shape
    dev = a_rows.device
    NBLKr = J // WB + rev_K(W)
    Rr = NBLKr * WB
    m0r = rev_anchor(iend, jend, d0, W)
    absrr = m0r[:, None] * WB + _bits(Rr, dev)[None, :]
    src = iend[:, None] - 1 - absrr  # a index of reversed-prefix char absrr
    ok = (absrr >= 0) & (absrr < iend[:, None]) & (src < la[:, None])
    win = torch.where(ok, a_rows.gather(1, src.clamp(0, LA - 1)), PAD)
    peq_r = _build_peq(win, NBLKr)
    LB = b_rows.shape[1]
    jcol = _bits(J, dev)[None, :]
    src_b = jend[:, None] - 1 - jcol
    okb = (jcol < jend[:, None]) & (src_b >= 0) & (src_b < lb[:, None])
    b2T_r = torch.where(okb, b_rows.gather(1, src_b.clamp(0, LB - 1)), PAD).T
    return peq_r, b2T_r.contiguous(), m0r * WB


def _n_blocks(lb, NB: int) -> int:
    """Blocks that can still change any pair's state (see module doc)."""
    if lb.numel() == 0:
        return 0
    return min(NB, -(-int(lb.max()) // WB))


def _shift_band(VP, VN, act_s):
    """Uniform one-word band shift, per-pair gated."""
    VPs = torch.cat([VP[1:], torch.full_like(VP[:1], MASK)], dim=0)
    VNs = torch.cat([VN[1:], torch.zeros_like(VN[:1])], dim=0)
    return torch.where(act_s, VPs, VP), torch.where(act_s, VNs, VN)


def fwd_core(peq, b2T, la_rel, la, lb, d0, W: int):
    """Forward pass (twin of ``myers_fwd_core``).  Returns int64 (cost,
    iend_rel, jend, win) [B] with iend_rel in anchor-relative rows."""
    K = K_of(W)
    J, B = b2T.shape
    NB = J // WB
    assert J % WB == 0 and J % 128 == 0, "jmax must be 128-aligned"
    dev = b2T.device
    i64 = dict(dtype=torch.int64, device=dev)

    win_cap = torch.minimum(lb, la - d0 - W // 2)
    kla = (la_rel - 1).clamp(min=0) // WB
    tla = (la_rel - 1).clamp(min=0) % WB
    neg_floor = la_rel - la
    karange = torch.arange(K, **i64)[:, None]

    VP = torch.zeros(K, B, **i64)
    VN = torch.zeros(K, B, **i64)
    zero = torch.zeros(B, **i64)
    s_top, s_bot = zero.clone(), zero.clone()
    below = la_rel > K * WB
    s_la = torch.where((la_rel >= 0) & (la_rel <= K * WB), 0, MBIG)
    bc, bn = zero + MBIG, zero + (1 << 30)
    bi, bj = zero.clone(), zero.clone()
    wprev, wmax, wprev2, wmax2 = zero, zero, zero, zero

    def consider(cost, iend_rel, jend, mask):
        nonlocal bc, bn, bi, bj
        negsum = -(iend_rel + jend)
        better = mask & ((cost < bc) | ((cost == bc) & (negsum < bn)))
        bc = torch.where(better, cost, bc)
        bn = torch.where(better, negsum, bn)
        bi = torch.where(better, iend_rel, bi)
        bj = torch.where(better, jend, bj)

    codes = b2T.clamp(max=PAD)
    for blk in range(_n_blocks(lb, NB)):
        pq = peq[blk : blk + K]
        at_la = karange == (kla - blk)[None, :]  # word slot holding row la
        in_win = (la_rel >= blk * WB) & (la_rel <= (blk + K) * WB) & ~below
        la_is_anchor = la_rel == blk * WB
        for u in range(WB):
            j = blk * WB + u
            active = j < lb
            Eq = _select_eq(pq, codes[j])
            hp, hn = active.long(), zero
            nvp, nvn, phs, mhs = [], [], [], []
            for k in range(K):
                vpk, vnk, ph, mh, hp, hn = _word_step(Eq[k], VP[k], VN[k], hp, hn)
                nvp.append(vpk)
                nvn.append(vnk)
                phs.append(ph)
                mhs.append(mh)
            # horizontal delta at row la: pre-shift bit tla of its word
            d = ((torch.stack(phs) >> tla) & 1) - ((torch.stack(mhs) >> tla) & 1)
            dla = torch.where(at_la, d, 0).sum(dim=0)
            VP = torch.where(active, torch.stack(nvp), VP)
            VN = torch.where(active, torch.stack(nvn), VN)
            s_top = s_top + active.long()
            s_bot = s_bot + torch.where(active, hp - hn, 0)
            dla = torch.where(la_is_anchor, 1, dla)
            upd = active & in_win
            s_la = s_la + torch.where(upd, dla, 0)
            consider(s_la, la_rel, zero + (j + 1), upd & (s_la < MBIG))

        if blk % 4 == 3:  # windowed band-min marks at jj = (blk+1)*32
            anchor_ok = (blk * WB >= neg_floor) & (blk * WB <= la_rel)
            runs = _band_runs(VP, VN, s_top)
            rel = blk * WB + 1 + torch.arange(K * WB, **i64)[:, None]
            ok = (rel >= neg_floor[None, :]) & (rel <= la_rel[None, :])
            bm = torch.where(ok, runs, MBIG).min(dim=0).values
            bm = torch.minimum(bm, torch.where(anchor_ok, s_top, MBIG))
            in_cap = (blk + 1) * WB <= win_cap
            if blk % 8 == 7:  # jj % 256 == 0
                wmax = torch.where(in_cap, torch.maximum(wmax, bm - wprev), wmax)
                wprev = bm
            else:
                if blk != 3:  # jj == 128: half-size first span, not scored
                    wmax2 = torch.where(
                        in_cap, torch.maximum(wmax2, bm - wprev2), wmax2
                    )
                wprev2 = bm

        # uniform shift at block end, per-pair gated (freezes at own lb)
        act_s = (blk + 1) * WB < lb
        d_top = popcount32(VP[0]) - popcount32(VN[0])
        s_top = torch.where(act_s, s_top + d_top, s_top)
        VP, VN = _shift_band(VP, VN, act_s)
        s_bot = torch.where(act_s, s_bot + WB, s_bot)
        # la enters through the new bottom word: D[bot - x] = D[bot] - x
        edge = (blk + 1 + K) * WB
        enter = below & act_s & (la_rel <= edge)
        s_la = torch.where(enter, s_bot - (edge - la_rel), s_la)
        below = below & ~enter

    # final-column extraction from each pair's frozen band state
    reached_end = lb <= J
    m_fr = torch.clamp((lb - 1).clamp(min=0) // WB, max=NB - 1)
    anchor_rel = m_fr * WB
    runs = _band_runs(VP, VN, s_top)
    rel = anchor_rel[None, :] + 1 + torch.arange(K * WB, **i64)[:, None]
    rel = torch.cat([anchor_rel[None, :], rel], dim=0)
    vals = torch.cat([s_top[None, :], runs], dim=0)
    ok = (rel >= neg_floor[None, :]) & (rel <= la_rel[None, :])
    costs = torch.where(ok, vals, MBIG)
    m1 = costs.min(dim=0).values
    negsum = -(rel + lb[None, :])
    m2 = torch.where(costs == m1[None, :], negsum, 1 << 30).min(dim=0).values
    consider(m1, -m2 - lb, lb, (m1 < MBIG) & reached_end)
    return bc, bi, bj, torch.maximum(wmax, wmax2)


def rev_core(peq, b2T, row_off, la, lb, W: int):
    """Anchored-end reverse pass (twin of ``myers_rev_core``); la = i_end,
    lb = j_end.  Returns int64 (cost_rev, best_row_abs)."""
    K = rev_K(W)
    J, B = b2T.shape
    NB = J // WB
    dev = b2T.device
    i64 = dict(dtype=torch.int64, device=dev)

    # anchored start: D[row, 0] = |row|; VP where the next row is > 0
    offs = torch.arange(K * WB, **i64).reshape(K, WB)
    nxt = row_off[None, None, :] + offs[:, :, None] + 1  # [K, 32, B]
    t = _bits(WB, dev)[None, :, None]
    VP = ((nxt > 0).long() << t).sum(dim=1)
    VN = ((nxt <= 0).long() << t).sum(dim=1)
    s_top = row_off.abs()
    zero = torch.zeros(B, **i64)

    codes = b2T.clamp(max=PAD)
    for blk in range(_n_blocks(lb, NB)):
        pq = peq[blk : blk + K]
        for u in range(WB):
            active = (blk * WB + u) < lb
            Eq = _select_eq(pq, codes[blk * WB + u])
            hp, hn = active.long(), zero
            nvp, nvn = [], []
            for k in range(K):
                vpk, vnk, _, _, hp, hn = _word_step(Eq[k], VP[k], VN[k], hp, hn)
                nvp.append(vpk)
                nvn.append(vnk)
            VP = torch.where(active, torch.stack(nvp), VP)
            VN = torch.where(active, torch.stack(nvn), VN)
            s_top = s_top + active.long()
        act_s = (blk + 1) * WB < lb
        d_top = popcount32(VP[0]) - popcount32(VN[0])
        s_top = torch.where(act_s, s_top + d_top, s_top)
        VP, VN = _shift_band(VP, VN, act_s)

    # frozen-state extraction: min cost, tie -> LARGEST reverse row
    m_fr = (lb - 1).clamp(min=0) // WB
    runs = _band_runs(VP, VN, s_top)
    rel = m_fr[None, :] * WB + 1 + torch.arange(K * WB, **i64)[:, None]
    rel = torch.cat([(m_fr * WB)[None, :], rel], dim=0)
    vals = torch.cat([s_top[None, :], runs], dim=0)
    row_abs = rel + row_off[None, :]
    ok = (row_abs >= 0) & (row_abs <= la[None, :])
    costs = torch.where(ok, vals, MBIG)
    bc = costs.min(dim=0).values
    br = torch.where(costs == bc[None, :], row_abs, -(1 << 30)).max(dim=0).values
    return bc, br


def fwd_rows(a_rows, b_rows, la, lb, d0, W: int, J: int):
    """Forward pass on gathered int64 rows: (cost_f, iend, jend, win) with
    iend absolute (rows of a)."""
    peq, b2T, la_rel, m0 = fwd_prep(a_rows, b_rows, la, lb, d0, W, J)
    cost, iend_rel, jend, win = fwd_core(peq, b2T, la_rel, la, lb, d0, W)
    return cost, iend_rel + m0 * WB, jend, win


def rev_rows(a_rows, b_rows, la, lb, d0, iend, jend, W: int, J: int):
    """Start recovery on gathered int64 rows: (cost_rev, best_row)."""
    peq_r, b2T_r, row_off = rev_prep(a_rows, b_rows, la, lb, iend, jend, d0, W, J)
    return rev_core(peq_r, b2T_r, row_off, iend, jend, W)


def combine(cost_f, iend, jend, win, cost_r, best_row):
    """Pair-core epilogue: start i0 = iend - best_row, degenerate jend == 0,
    and the BIG sentinel for pairs without a forward endpoint."""
    i0 = iend - best_row
    cost_r = torch.where(jend == 0, 0, cost_r)
    i0 = torch.where(jend == 0, iend, i0)
    valid = cost_f < MBIG
    z = torch.zeros_like(cost_f)
    return (
        torch.where(valid, cost_r, int(BIG)),
        torch.where(valid, i0, z),
        torch.where(valid, iend, z),
        torch.where(valid, jend, z),
        torch.where(valid, win, z),
    )


def pair_core(a_rows, b_rows, la, lb, d0, W: int, J: int):
    """Twin of ``myers._myers_pair_core`` on gathered int64 rows."""
    cost_f, iend, jend, win = fwd_rows(a_rows, b_rows, la, lb, d0, W, J)
    cost_r, best_row = rev_rows(a_rows, b_rows, la, lb, d0, iend, jend, W, J)
    return combine(cost_f, iend, jend, win, cost_r, best_row)


def _rows(codes, lengths, a_oid, b_oid, d0):
    a_oid, b_oid = a_oid.long(), b_oid.long()
    return (
        codes[a_oid].long(), codes[b_oid].long(),
        lengths[a_oid >> 1].long(), lengths[b_oid >> 1].long(), d0.long(),
    )


def _i32(xs):
    return tuple(x.to(torch.int32) for x in xs)


def fwd_plain(codes, lengths, a_oid, b_oid, d0, W: int, J: int):
    """Kernel 1's contract in plain torch, from the resident read matrix:
    (cost_f, iend, jend, win) int32."""
    return _i32(fwd_rows(*_rows(codes, lengths, a_oid, b_oid, d0), W, J))


def rev_plain(codes, lengths, a_oid, b_oid, d0, iend, jend, W: int, J: int):
    """Kernel 2's contract in plain torch: (cost_rev, best_row) int32."""
    rows = _rows(codes, lengths, a_oid, b_oid, d0)
    return _i32(rev_rows(*rows, iend.long(), jend.long(), W, J))
