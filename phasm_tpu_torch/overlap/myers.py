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

from phasm_tpu_torch.overlap.extend import BIG

# -- window geometry: copies of the reference's ``phasm_tpu.overlap.myers``
# constants and anchors (the kernels and the plain core both use them) --

WB = 32
MBIG = 1 << 28  # invalid sentinel (costs can legitimately exceed extend.BIG)


def K_of(W: int) -> int:
    """Words per window: +63 absorbs anchor/phase quantization, +1 word of
    top margin keeps the +-W/2 band strictly interior."""
    return -(-(W + 63) // WB) + 1


def fwd_anchor(d0, W: int):
    """m0: the pair's window anchor block (row 32*m0; may be negative)."""
    return (d0 - W // 2) // WB - 1


def rev_anchor(i_end, j_end, d0, W: int):
    """Reverse-window anchor block m0r.

    Forward path positions satisfy i - j in [base - 31, base + 32K]
    (base = 32 * m0_fwd), so reverse diagonals i' - j' = dc - (i - j)
    (dc = i_end - j_end) lie in [dc - base - 32K, dc - base + 31];
    anchoring one margin word below the floor with K' = K + 5 words keeps
    the whole forward window strictly interior."""
    Kf = K_of(W)
    base = WB * fwd_anchor(d0, W)
    return ((i_end - j_end) - base - WB * Kf) // WB - 1


def rev_K(W: int) -> int:
    """Reverse-window width: K_of + 3 words.

    Containment argument (rev_anchor): forward diagonals span
    32*(K_of + 1) bits; the reverse range adds <= 31 bits of floor
    quantization plus the one anchor margin word below the floor — so
    K_of + 3 words strictly contain every forward-window path, and the
    reverse pass can neither miss a min-cost path nor an equal-cost
    smaller-start tie.  Round 2 shipped K_of + 5 (two spare words =
    +25% reverse-kernel work); the tightening was validated bit-identical
    against K_of + 5 on ~20k fuzz pairs incl. adversarial d0/lb extremes
    (round 4)."""
    return K_of(W) + 3


BK = 32  # table fetch-block size (words); residual barrel = 5 levels


BKB = 128  # packed-b fetch-row size (words); residual barrel = 7 levels


def tab2_geometry(W: int, J: int) -> tuple[int, int, int]:
    """(GF, GR, GB): fetch rows for the fwd peq window, rev peq window,
    and rev packed-b window.  Span = residual + words consumed."""
    gf = -(-(J // WB + K_of(W) + BK - 1) // BK)
    gr = -(-(J // WB + rev_K(W) + 1 + BK - 1) // BK)
    gb = -(-(J // 16 + 1 + BKB - 1) // BKB)
    return gf, gr, gb


JWMAX = 128  # widest packed-b fwd window ever routed to the myers kernels
# (J <= 2048 under the scoped-VMEM gate; J/16 <= 128)

# -- the plain core --

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


# -- the table tier: twins of the reference's ``build_myers_tables``,
# ``fwd_prep_tab`` and ``rev_prep_tab`` (``phasm_tpu/overlap/myers.py``).
# Whole-read tables are built once per oriented matrix; each batch then
# cuts its pairs' forward and reverse windows out of them.  The reference
# cuts them with a logarithmic barrel shift (a TPU workaround for slow
# per-row-offset gathers); here one per-pair gather takes its place and
# gives the same words.  Window words are int32 holding uint32 bits. --

_TABLE_CHUNK_CELLS = 1 << 24  # bounds the int64 temporaries of a table build

F_TAB = 16  # table front-pad words (the reference's bound: F_TAB >=
# K_of(W) + 4 keeps every forward shift and reverse word offset >= 0)


def table_words(LA: int) -> tuple[int, int]:
    """(PW, BW): peq words and packed-b words per table row for width LA."""
    PW = F_TAB + (LA + WB - 1) // WB + 2
    BW = (LA + 15) // 16 + 2
    return PW, BW


def to_u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit words -> int32 with the same bit pattern."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def match_mask_table(
    rows: torch.Tensor, lens: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """[n, L] uint8 codes + [n] valid lengths -> [n, ceil(L/32), 4] int32
    (uint32 bits): bit t of word w, plane c <=> x[32w + t] == c and
    32w + t < lens, where x is the row (reverse=False) or the row reversed
    within its own length (x[f] = row[lens - 1 - f]).  Positions outside a
    read never match."""
    n, L = rows.shape
    PW = -(-L // WB)
    out = torch.empty((n, PW, 4), dtype=torch.int32, device=rows.device)
    t = torch.arange(WB, dtype=torch.int64, device=rows.device)
    pos = torch.arange(PW * WB, device=rows.device).view(1, PW, WB)
    f = torch.arange(L, device=rows.device)[None, :]
    step = max(1, _TABLE_CHUNK_CELLS // (PW * WB))
    for s in range(0, n, step):
        x = rows[s : s + step]
        ln = lens[s : s + step]
        if reverse:
            x = x.gather(1, (ln[:, None] - 1 - f).clamp(min=0))
        x = torch.nn.functional.pad(x, (0, PW * WB - L)).view(-1, PW, WB)
        valid = pos < ln.view(-1, 1, 1)
        planes = [
            (((x == c) & valid).long() << t).sum(dim=-1) for c in range(4)
        ]
        out[s : s + step] = to_u32_bits(torch.stack(planes, dim=-1))
    return out


def _pack_codes(rows: torch.Tensor, BW: int) -> torch.Tensor:
    """[n, L] codes -> [n, BW] int32: 2 bits a code (code & 3), 16 a word,
    zero past L."""
    n, L = rows.shape
    out = torch.empty((n, BW), dtype=torch.int32, device=rows.device)
    sh = 2 * torch.arange(16, dtype=torch.int64, device=rows.device)
    step = max(1, _TABLE_CHUNK_CELLS // (BW * 16))
    for s in range(0, n, step):
        x = torch.nn.functional.pad(rows[s : s + step], (0, BW * 16 - L))
        v = (x.long() & 3).view(-1, BW, 16)
        out[s : s + step] = to_u32_bits((v << sh).sum(dim=-1))
    return out


def build_myers_tables(oriented: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Whole-read window tables, built once per oriented matrix on its
    device (twin of the reference's ``build_myers_tables``).

    oriented [n_o, LA] uint8 codes (row 2r = read r forward, 2r+1 revcomp);
    lengths [n_reads] int32.  Returns dict:
      peq [n_o, 8, PW] int32 (uint32 bits): planes 0..3 the forward match
          masks (bit t of word w: a[32(w - F_TAB) + t] == c, zero outside
          [0, la)); planes 4..7 the same over flip rows flip[f] = a[LA-1-f],
          reversed within LA (not within the read's own length, as
          ``match_mask_table(reverse=True)`` is), zero off the read;
      bpk [n_o, 2, BW] int32: 2-bit packed codes, 16 a word, plane 0 the
          row, plane 1 the flip row, with positions off the read as code 0.
    """
    n_o, LA = oriented.shape
    PW, _ = table_words(LA)
    dev = oriented.device
    la_row = lengths.long()[torch.arange(n_o, device=dev) // 2]
    pos = torch.arange(LA, device=dev)[None, :]
    masked = torch.where(pos < la_row[:, None], oriented, PAD).to(torch.uint8)
    flip = masked.flip(1)
    nw = -(-LA // WB)
    whole = torch.full_like(la_row, LA)  # PAD codes never match
    peq = torch.zeros((n_o, 8, PW), dtype=torch.int32, device=dev)
    for half, rows in enumerate((masked, flip)):
        peq[:, 4 * half : 4 * half + 4, F_TAB : F_TAB + nw] = (
            match_mask_table(rows, whole).permute(0, 2, 1)
        )
    BW = table_words(LA)[1]
    bpk = torch.stack([_pack_codes(masked, BW), _pack_codes(flip, BW)], dim=1)
    return {"peq": peq, "bpk": bpk}


def _table_words(tab, oid, plane0: int, nplanes: int, start, n: int):
    """Words start + k (k < n) of planes plane0 .. plane0 + nplanes - 1 of
    table rows oid: [n, nplanes, B] int32, zero outside the row (the
    reference's zero pad)."""
    _, P, PW = tab.shape
    dev = tab.device
    w = start.long()[None, :] + torch.arange(n, device=dev)[:, None]  # [n, B]
    rows = oid.long()[None, :] * P + plane0 + torch.arange(nplanes, device=dev)[:, None]
    idx = rows[None] * PW + w.clamp(0, PW - 1)[:, None, :]
    ok = ((w >= 0) & (w < PW))[:, None, :]
    return torch.where(ok, tab.reshape(-1)[idx], 0)


def fwd_fetch(peq_tab, bpk_tab, a_oid, b_oid, sfw, W: int, J: int):
    """Kernel 5's function (``scripts/myers_dma_proto.py::make_fwd_fetch``):
    peq_f[k, c, p] = peq_tab[a_oid[p], c, sfw[p] + k] for k < NBLK and
    bpk_f[w, p] = bpk_tab[b_oid[p], 0, w] for w < J/16, words past a row
    being 0.  Returns ([NBLK, 4, B], [J/16, B]) int32."""
    return (
        _table_words(peq_tab, a_oid, 0, 4, sfw, J // WB + K_of(W)),
        _table_words(bpk_tab, b_oid, 0, 1, torch.zeros_like(sfw), J // 16)[:, 0],
    )


def fwd_prep_tab(peq_tab, bpk_tab, a_oid, b_oid, la, d0, W: int, J: int):
    """Forward window from the tables (twin of the reference's
    ``fwd_prep_tab``, which takes the pairs' gathered rows instead of the
    tables and oids): (peq_f [NBLK, 4, B], bpk_f [J/16, B], la_rel, m0)."""
    m0 = fwd_anchor(d0.long(), W)
    peq_f, bpk_f = fwd_fetch(peq_tab, bpk_tab, a_oid, b_oid, m0 + F_TAB, W, J)
    return peq_f, bpk_f, la.long() - m0 * WB, m0


def funnel_bits(x, delta):
    """out[w] = (x[w] >> delta) | (x[w+1] << (32 - delta)) on 32-bit words
    in int64 (axis 0), per-pair delta in [0, 32) on the last axis.  Output
    has one fewer word than x."""
    d = delta.long()[(None,) * (x.ndim - 1)]
    lo = x[:-1] >> d
    hi = torch.where(d == 0, 0, (x[1:] << (32 - d)) & MASK)
    return lo | hi


def rev_prep_tab(peq_tab, bpk_tab, a_oid, b_oid, LA: int, iend, jend, d0, W: int, J: int):
    """Reverse window (anchored-end start recovery) from the tables (twin
    of the reference's ``rev_prep_tab``, over tables and oids).

    Window word k bit t = flip-plane bit at off + 32k + t, off = (LA - iend)
    + 32*m0r: a per-pair word gather plus one bit funnel.  Words k < -m0r
    lie below the reversed prefix and are zero.  Returns (peq_r [NBLKr, 4,
    B] int32, bpk_r [J/16, B] int32, row_off [B] int64)."""
    iend, jend = iend.long(), jend.long()
    NBLKr = J // WB + rev_K(W)
    m0r = rev_anchor(iend, jend, d0.long(), W)
    obit = (LA - iend) + m0r * WB + F_TAB * WB
    x = _table_words(peq_tab, a_oid, 4, 4, obit // WB, NBLKr + 1).long() & MASK
    peq_r = funnel_bits(x, obit % WB)
    k = torch.arange(NBLKr, device=x.device)[:, None, None]
    peq_r = to_u32_bits(torch.where(k < -m0r[None, None, :], 0, peq_r))
    # packed reversed-b window: code j = flip-b code at cb + j, cb = LA - jend
    cb = LA - jend
    JW = J // 16
    bx = _table_words(bpk_tab, b_oid, 1, 1, cb // 16, JW + 1)[:, 0].long() & MASK
    bpk_r = to_u32_bits(funnel_bits(bx, 2 * (cb % 16)))
    return peq_r, bpk_r, m0r * WB


def _window_peq(peq_w):
    """[N, 4, B] int32 window words -> [N, 5, B] int64 words as the cores
    take them (plane 4, the PAD plane, all zero)."""
    x = peq_w.long() & MASK
    return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)


def unpack_b(bpk_w, J: int):
    """[J/16, B] packed window -> [J, B] int64 codes 0..3.  Packing turned
    PAD into code 0; the cores gate every column j >= lb off, so it is
    never read (the reference's own argument for its packed windows)."""
    sh = 2 * torch.arange(16, dtype=torch.int64, device=bpk_w.device)[None, :, None]
    return ((bpk_w.long()[:, None, :] >> sh) & 3).reshape(J, -1)


def fwd_win_plain(la, lb, d0, peq_f, bpk_f, W: int, J: int):
    """The window-fed kernel 1's contract in plain torch: the forward core
    fed a fetched window; (cost_f, iend_rel, jend, win) int32, iend_rel
    relative to the anchor row 32*m0."""
    la, lb, d0 = la.long(), lb.long(), d0.long()
    la_rel = la - fwd_anchor(d0, W) * WB
    return _i32(fwd_core(_window_peq(peq_f), unpack_b(bpk_f, J), la_rel, la, lb, d0, W))


def rev_win_plain(row_off, iend, jend, peq_r, bpk_r, W: int, J: int):
    """The window-fed kernel 2's contract in plain torch: (cost_rev,
    best_row) int32."""
    return _i32(rev_core(
        _window_peq(peq_r), unpack_b(bpk_r, J), row_off.long(), iend.long(), jend.long(), W
    ))


# -- the tab2 tier: twins of the reference's ``build_myers_tables_blocked``
# (``phasm_tpu/overlap/myers.py``) and of the window cuts inside its tab2
# kernels (``myers_pallas.py``: the coarse-row gathers of
# ``myers_pallas_compute_tab2``, then ``_residual_barrel`` and, in the
# reverse kernel, the bit funnel, the below-prefix mask and the packed-b
# funnel).  The blocked table holds the table tier's words in 128-word
# rows; each pair fetches the few rows its window covers and shifts the
# residual.  The windows equal ``fwd_prep_tab`` / ``rev_prep_tab``'s. --

# row-count paddings: the largest J routed to the tab2 kernels is 2048, so
# GF / GR <= 4 and GB <= 2; +1 slack
_PAD_PEQ_BLOCKS = 5
_PAD_BPK_BLOCKS = 3


def blocked_counts(LA: int) -> tuple[int, int]:
    """(NBb, NBc): per-read fetch-row counts of the blocked tables."""
    PW, BW = table_words(LA)
    return -(-PW // BK) + _PAD_PEQ_BLOCKS, -(-BW // BKB) + _PAD_BPK_BLOCKS


def tab2_offsets(n_o: int, LA: int) -> tuple[int, int, int]:
    """(rev_peq, bpk_f, bpk_r) row offsets inside the combined table."""
    NBb, NBc = blocked_counts(LA)
    return n_o * NBb, 2 * n_o * NBb, 2 * n_o * NBb + n_o


def build_myers_tables_blocked(oriented: torch.Tensor, lengths: torch.Tensor) -> dict:
    """Blocked window tables as one combined [N_rows, 128] int32 (uint32
    bits) tensor on oriented's device (twin of the reference's
    ``build_myers_tables_blocked``).  Row spaces:

      [0, n_o*NBb)            forward peq blocks: row r*NBb + g holds words
                              [g*BK, (g+1)*BK) of planes 0..3 word-major
                              (lane w*4 + c = word g*BK + w, plane c);
      [.., 2*n_o*NBb)         the same over the flip rows;
      [.., + n_o)             packed forward b codes, words [0, JWMAX);
      [.., + n_o*NBc)         packed flip b codes, BKB-word rows.

    The words are ``build_myers_tables``' (same F_TAB anchoring, masking
    and chunked build), zero past each read's PW peq words and BW packed
    words."""
    n_o, LA = oriented.shape
    PW, BW = table_words(LA)
    NBb, NBc = blocked_counts(LA)
    t = build_myers_tables(oriented, lengths)
    peq = torch.nn.functional.pad(t["peq"], (0, NBb * BK - PW))

    def blocks(p):  # [n_o, 4, NBb*BK] -> [n_o*NBb, BK*4], word-major
        return p.reshape(n_o, 4, NBb, BK).permute(0, 2, 3, 1).reshape(n_o * NBb, BK * 4)

    bpk_f = torch.nn.functional.pad(t["bpk"][:, 0], (0, max(JWMAX - BW, 0)))[:, :JWMAX]
    bpk_r = torch.nn.functional.pad(t["bpk"][:, 1], (0, NBc * BKB - BW)).reshape(n_o * NBc, BKB)
    return {"win": torch.cat([blocks(peq[:, :4]), blocks(peq[:, 4:]), bpk_f, bpk_r])}


def residual_barrel(x, srem, n_out: int):
    """out[w] = x[w + srem] for w < n_out along axis 0, zeros shifted in
    past x's end; per-pair srem >= 0 on the last axis.  The reference's
    in-kernel barrel (``myers_pallas._residual_barrel``) as one gather."""
    n = x.shape[0]
    idx = torch.arange(n_out, device=x.device)[:, None] + srem.long()[None, :]
    idx = idx.view((n_out,) + (1,) * (x.ndim - 2) + (x.shape[-1],)).expand((n_out,) + x.shape[1:])
    return torch.where(idx < n, x.gather(0, idx.clamp(max=n - 1)), 0)


def _tab2_rows(win, LA: int):
    """(n_o, NBb, NBc) of a blocked table built at width LA."""
    NBb, NBc = blocked_counts(LA)
    return win.shape[0] // (2 * NBb + 1 + NBc), NBb, NBc


def _fetch_blocks(win, first, lo: int, hi: int, G: int):
    """Rows clip(first + g, lo, hi) for g < G of the blocked table, the
    reference's coarse gather: [B, G, 128] int32."""
    rows = first.long()[:, None] + torch.arange(G, device=win.device)[None, :]
    return win[rows.clamp(lo, hi)]


def _peq_words(slab):
    """[B, G, 128] word-major peq rows -> [G*BK, 4, B] words."""
    B, G, _ = slab.shape
    return slab.reshape(B, G * BK, 4).permute(1, 2, 0)


def fwd_prep_tab2(win, lengths, a_oid, b_oid, d0, LA: int, W: int, J: int):
    """Forward window from the blocked table (the reference's tab2 forward
    cut: rows s32 .. s32 + GF - 1 of the pair's a, clipped to the forward
    region, then the residual barrel by srem = s % 32, s = m0 + F_TAB; the
    b codes are row OFF_BF + b_oid).  Returns ``fwd_prep_tab``'s (peq_f
    [NBLK, 4, B] int32, bpk_f [J/16, B] int32, la_rel, m0)."""
    n_o, NBb, _ = _tab2_rows(win, LA)
    GF = tab2_geometry(W, J)[0]
    OFF_R, OFF_BF, _ = tab2_offsets(n_o, LA)
    m0 = fwd_anchor(d0.long(), W)
    s = m0 + F_TAB
    slab = _fetch_blocks(win, a_oid.long() * NBb + s // BK, 0, OFF_R - 1, GF)
    peq_f = residual_barrel(_peq_words(slab), s % BK, J // WB + K_of(W))
    bpk_f = win[OFF_BF + b_oid.long(), : J // 16].T.contiguous()
    la = lengths.long()[a_oid.long() >> 1]
    return peq_f, bpk_f, la - m0 * WB, m0


def rev_prep_tab2(win, a_oid, b_oid, LA: int, iend, jend, d0, W: int, J: int):
    """Reverse window from the blocked table (the reference's tab2 reverse
    cut): rows q32 .. q32 + GR - 1 of the pair's flip peq, clipped to that
    region, the residual barrel by qrem, the bit funnel by delta, words k <
    -m0r zeroed; the flip b rows c128 .. c128 + GB - 1 (clipped), the
    barrel by crem and the funnel by db.  Returns ``rev_prep_tab``'s (peq_r
    [NBLKr, 4, B] int32, bpk_r [J/16, B] int32, row_off)."""
    n_o, NBb, NBc = _tab2_rows(win, LA)
    _, GR, GB = tab2_geometry(W, J)
    OFF_R, OFF_BF, OFF_BR = tab2_offsets(n_o, LA)
    iend, jend = iend.long(), jend.long()
    NBLKr, JW = J // WB + rev_K(W), J // 16
    m0r = rev_anchor(iend, jend, d0.long(), W)
    q0 = ((LA - iend) + m0r * WB + F_TAB * WB) // WB
    delta = (LA - iend) % WB  # obit % 32: m0r and F_TAB add whole words
    slab = _fetch_blocks(win, OFF_R + a_oid.long() * NBb + q0 // BK, OFF_R, OFF_BF - 1, GR)
    x = residual_barrel(_peq_words(slab), q0 % BK, NBLKr + 1).long() & MASK
    k = torch.arange(NBLKr, device=win.device)[:, None, None]
    peq_r = to_u32_bits(torch.where(k < -m0r[None, None, :], 0, funnel_bits(x, delta)))
    cbw = (LA - jend) // 16
    bslab = _fetch_blocks(win, OFF_BR + b_oid.long() * NBc + cbw // BKB, OFF_BR, win.shape[0] - 1, GB)
    z = residual_barrel(bslab.reshape(-1, GB * BKB).T, cbw % BKB, JW + 1).long() & MASK
    bpk_r = to_u32_bits(funnel_bits(z, 2 * ((LA - jend) % 16)))
    return peq_r, bpk_r, m0r * WB


def fwd_tab2_plain(win, lengths, a_oid, b_oid, d0, LA: int, W: int, J: int):
    """The tab2 kernel 1's contract in plain torch: ``fwd_prep_tab2`` then
    the window-fed core; (cost_f, iend_rel, jend, win) int32."""
    peq_f, bpk_f, _, _ = fwd_prep_tab2(win, lengths, a_oid, b_oid, d0, LA, W, J)
    la = lengths[a_oid.long() >> 1]
    lb = lengths[b_oid.long() >> 1]
    return fwd_win_plain(la, lb, d0, peq_f, bpk_f, W, J)


def rev_tab2_plain(win, a_oid, b_oid, LA: int, iend, jend, d0, W: int, J: int):
    """The tab2 kernel 2's contract in plain torch: ``rev_prep_tab2`` then
    the window-fed core; (cost_rev, best_row) int32."""
    peq_r, bpk_r, row_off = rev_prep_tab2(win, a_oid, b_oid, LA, iend, jend, d0, W, J)
    return rev_win_plain(row_off, iend, jend, peq_r, bpk_r, W, J)
