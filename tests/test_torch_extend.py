"""Port W-band extension (phasm_tpu_torch.overlap.extend) == the JAX
reference: the plain dp_core twin against ``extend.dp_core`` and the
``banded_overlap_np`` oracle at every band the engine uses, against the
segmented Pallas kernel in interpret mode, and the port's kernel routing
against the reference extender's predicates.
"""
import numpy as np
import pytest
import torch

from phasm_tpu.overlap import extend as E
from phasm_tpu_torch.overlap import extend as X
from phasm_tpu_torch.overlap.routing import route
from phasm_tpu_torch.state import DeviceReads

from test_myers import as_oriented, random_overlap_case
from torch_cases import edited_pairs, resident_pairs

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x)).long()


@pytest.mark.parametrize("W", [20, 64, 96, 128, 200, 256, 512])
def test_plain_dp_core_matches_reference(W):
    rng = np.random.default_rng(100 + W)
    a, b, la, lb, d0 = random_overlap_case(rng, B=5, la_max=300, err=0.1)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    d0 = d0.astype(np.int32)
    J = 512
    a2, b2, laa, lbb = E.prepare_pair_tensors(oriented, lengths, a_oid, b_oid, d0, W, J)
    want = E._get_jit_batch()(a2, b2, laa, lbb, d0, W)
    # the port's own band prep gives the reference's band tensors
    pa2, pb2, pla, plb = X.stage_pairs(
        torch.from_numpy(oriented), torch.from_numpy(lengths), _t(a_oid), _t(b_oid), _t(d0), W, J
    )
    assert np.array_equal(pa2.numpy(), a2) and np.array_equal(pb2.numpy(), b2)
    got = [x.numpy() for x in X.dp_core(pa2, pb2, pla, plb, _t(d0), W)]
    for n, w, g in zip(("cost", "i0", "iend", "jend", "win"), want, got):
        assert np.array_equal(np.asarray(w), g), (W, n, np.asarray(w), g)
    for p in range(a.shape[0]):
        i0, ie, _, je, c = E.banded_overlap_np(a[p, : la[p]], b[p, : lb[p]], int(d0[p]), W)
        assert (c, i0, ie, je) == tuple(int(x[p]) for x in got[:4])
    # the kernel wrapper runs this plain version on a CPU read set
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    before = X.wband_launches
    wrapped = X.wband(reads, _t(a_oid), _t(b_oid), _t(d0), W, J)
    assert all(np.array_equal(w.numpy(), g) for w, g in zip(wrapped, got))
    assert X.wband_launches == before


def test_plain_dp_core_matches_pallas_seg_interpret():
    """The segmented Pallas W-band kernel (interpret mode, as
    tests/test_overlap.py runs it) against the plain twin."""
    rng = np.random.default_rng(3)
    la = lb = 300
    W, SEG, NSEG = 16, 128, 3
    oriented = np.zeros((4, 512), dtype=np.uint8)
    g = rng.integers(0, 4, 500).astype(np.uint8)
    oriented[0, :la] = g[:la]
    b = g[100 : 100 + lb].copy()
    noise = rng.random(lb) < 0.05
    oriented[2, :lb] = np.where(noise, (b + rng.integers(1, 4, lb)) % 4, b)
    lengths = np.array([la, lb], dtype=np.int32)
    M = 128
    a_oid = np.zeros(M, dtype=np.int64)
    b_oid = np.full(M, 2, dtype=np.int64)
    d0 = np.full(M, 100, dtype=np.int32)
    cols = SEG * NSEG
    _, b2, laa, lbb = E.prepare_pair_tensors(oriented, lengths, a_oid, b_oid, d0, W, cols)
    tt = np.arange(NSEG * (SEG + W))
    ai = d0[:, None] + (tt // (SEG + W))[None, :] * SEG + (tt % (SEG + W))[None, :] - W // 2
    a_rows = oriented[a_oid]
    a2s = np.where((ai >= 0) & (ai < laa[:, None]), a_rows[np.arange(M)[:, None], np.clip(ai, 0, 511)], 254)
    run = E._make_pallas_extend_seg(W, SEG, NSEG, 128, interpret=True)
    want = np.asarray(run(
        d0[None, :], laa[None, :], lbb[None, :],
        np.ascontiguousarray(a2s.T).astype(np.int32),
        np.ascontiguousarray(b2.T).astype(np.int32),
    ))
    got = X.wband_plain(
        torch.from_numpy(oriented), torch.from_numpy(lengths), _t(a_oid), _t(b_oid), _t(d0), W, cols
    )
    for r in range(5):
        assert np.array_equal(want[r], got[r].numpy()), r


def test_routing_matches_reference_predicates():
    """Myers iff the reference extender routes (W, J) to a Myers tier
    (tab2 or tab); every other bucket goes to a dp_core-equivalent family:
    kernel 3 at every band the reference runs the segmented Pallas kernel
    for (W <= PALLAS_MAX_BAND, any W) and up to 512, the plain dp_core
    above 512, where the reference has no kernel either."""
    ref = E.DeviceExtender(
        np.zeros((2, 128), dtype=np.uint8), np.array([100], dtype=np.int32),
        band=64, backend="myers_pallas",
    )
    for W in (20, 64, 96, 128, 200, 256, 512, 1024):
        for J in (1024, 2048, 4096, 8192, 12288, 16384):
            myers = ref._is_tab2_run(W, J) or ref._is_tab_run(W, J)
            fam = route("myers_pallas", W, J)
            assert (fam == "myers") == myers, (W, J, fam)
            if not myers:
                assert fam == ("wband" if W <= 512 else "dp_core"), (W, J, fam)
            assert route("pallas", W, J) == ("wband" if W <= 512 else "dp_core")
            assert route("jnp", W, J) == "dp_core"
    assert route("myers_pallas", 64, 8192) == "myers"
    assert route("myers_pallas", 64, 12288) == "wband"
    assert route("myers_pallas", 96, 12288) == "wband"


def _mk_pairs(seed0: int, n: int, W: int):
    """``n`` pairs from tests/test_overlap.py's generator, packed into the
    batch API's (oriented, lengths, a_oid, b_oid, d0) contract."""
    from test_overlap import _mk_pair

    rows = []
    for s in range(seed0, seed0 + n):
        rng = np.random.default_rng(s)
        la, lb = int(rng.integers(120, 250)), int(rng.integers(120, 250))
        ovl = int(rng.integers(40, min(la, lb)))
        err = float(rng.choice([0.0, 0.05, 0.15]))
        a, b, d0 = _mk_pair(rng, la, lb, ovl, err, int(rng.integers(-8, 9)))
        rows.append((a, b, max(d0, 0)))
    LA = max(max(len(a), len(b)) for a, b, _ in rows)
    A = np.full((n, LA), 9, dtype=np.uint8)
    Bm = np.full((n, LA), 9, dtype=np.uint8)
    for p, (a, b, _) in enumerate(rows):
        A[p, : len(a)], Bm[p, : len(b)] = a, b
    la = np.array([len(a) for a, _, _ in rows])
    lb = np.array([len(b) for _, b, _ in rows])
    oriented, lengths, a_oid, b_oid = as_oriented(A, Bm, la, lb)
    return oriented, lengths, a_oid, b_oid, np.array([d for *_, d in rows], dtype=np.int32)


def _same_result(want, got):
    for f in ("a_start", "a_end", "b_start", "b_end", "diffs", "win_cost"):
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.dtype == np.int32 and np.array_equal(w, g), f


def test_prepare_pair_tensors_matches_reference():
    """Byte for byte, including a bucket wider than the read matrix (the
    reference pads b rows there)."""
    rng = np.random.default_rng(21)
    a, b, la, lb, d0 = random_overlap_case(rng, B=7, la_max=300, err=0.1)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    d0 = d0.astype(np.int32)
    for W, J in ((32, 256), (64, 512), (128, 1024)):
        want = E.prepare_pair_tensors(oriented, lengths, a_oid, b_oid, d0, W, J)
        got = X.prepare_pair_tensors(oriented, lengths, a_oid, b_oid, d0, W, J, device="cpu")
        for w, g in zip(want, got):
            assert g.dtype == torch.from_numpy(w).dtype and np.array_equal(w, g.numpy()), (W, J)


@pytest.mark.parametrize("W", [32, 64, 128])
def test_banded_overlap_batch_matches_reference(W):
    """The batch entry point's plain path == the reference's jnp batch on
    tests/test_overlap.py's pair generator; the kernel-4 entry point on a
    CPU device runs it and counts no launch."""
    batch = _mk_pairs(10 * W, 6, W)
    want = E.banded_overlap_batch(*batch, band=W, jmax=256)
    _same_result(want, X.banded_overlap_batch(*batch, band=W, jmax=256, device="cpu"))
    before = X.wband_dense_launches
    _same_result(want, X.banded_overlap_cuda(*batch, band=W, jmax=256, device="cpu"))
    assert X.wband_dense_launches == before


def test_banded_overlap_batch_matches_pallas_interpret():
    """One 150-bp case at W = 32 against the single-shot Pallas kernel in
    interpret mode, as tests/test_overlap.py runs it."""
    from test_overlap import _mk_pair

    rng = np.random.default_rng(100)
    a, b, d0 = _mk_pair(rng, 150, 160, int(rng.integers(50, 140)), 0.08, int(rng.integers(-4, 5)))
    oriented = np.zeros((4, 256), dtype=np.uint8)
    oriented[0, :150], oriented[2, :160] = a, b
    args = (oriented, np.array([150, 160], dtype=np.int32), np.array([0]), np.array([2]),
            np.array([d0], dtype=np.int32))
    want = E.banded_overlap_pallas(*args, band=32, jmax=256, interpret=True)
    got = X.banded_overlap_batch(*args, band=32, jmax=256, device="cpu")
    _same_result(want, got)
    assert int(got.diffs[0]) < int(E.BIG)


@pytest.mark.parametrize("band,jmax", [(129, 1024), (64, 1001), (64, 32768)])
def test_banded_overlap_cuda_rejects_outside_its_contract(band, jmax):
    """W <= 128 (the 7-bit w key field), jmax % 8 == 0, jmax < 32768: the
    reference single-shot kernel's contract, checked on any device."""
    batch = _mk_pairs(0, 2, 64)
    with pytest.raises(ValueError):
        X.banded_overlap_cuda(*batch, band=band, jmax=jmax, device="cpu")


def _kernel4_design_plain(a2, b2, la, lb, d0, W: int, quiet):
    """dp_core's column loop as kernel 4 runs it: the recurrence with the
    BIG clamp but no validity mask, and the two endpoint tests only in the
    8-column steps that ``quiet`` [B, J // 8] does not clear, with the
    kernel's guards (j < lb at i == la; rows <= la at j + 1 == lb)."""
    B, J = b2.shape
    la, lb, d0 = la.long(), lb.long(), d0.long()
    lw = max(7, (W - 1).bit_length())
    pack, half = 1 << lw, W // 2
    BIGPW = (1 << 15) * pack
    iota_w = torch.arange(W)[None, :]
    i_at_j0 = d0[:, None] + iota_w - half
    P = torch.where((i_at_j0 >= 0) & (i_at_j0 <= la[:, None]), iota_w, BIGPW)
    win_cap = torch.minimum(lb, la - d0 - half)
    zero = torch.zeros(B, dtype=torch.int64)
    best = [zero + int(X.BIG), zero - 1, zero, zero, zero]  # cost, alen, i0, iend, jend
    wprev, wmax, wprev2, wmax2 = zero, zero, zero, zero

    def key(p, w):
        return torch.where(p < BIGPW, ((p >> lw) << (lw + 1)) + (W - 1 - w + (p & (pack - 1))), X.BIGK)

    def consider(j, ck, w_sel, mask):
        cost, mid = ck >> (lw + 1), ck & ((1 << (lw + 1)) - 1)
        i0 = mid - (W - 1) + w_sel + d0 - half
        i_end = torch.minimum(d0 + (j + 1) + w_sel - half, la)
        alen = (i_end - i0) + (j + 1)
        better = mask & (ck < X.BIGK) & ((cost < best[0]) | ((cost == best[0]) & (alen > best[1])))
        for k, v in enumerate((cost, alen, i0, i_end, zero + (j + 1))):
            best[k] = torch.where(better, v, best[k])

    for j in range(J):
        sub = (a2[:, j : j + W] != b2[:, j : j + 1]).long() * pack
        up = torch.cat([P[:, 1:], torch.full((B, 1), BIGPW)], dim=1) + pack
        x = torch.minimum(P + sub, up) - iota_w * pack
        P = (torch.cummin(x, dim=1).values + iota_w * pack).clamp(max=BIGPW)
        ends = ~quiet[:, j // 8]
        w_la = la - (d0 + (j + 1) - half)
        k_la = key(P.gather(1, w_la.clamp(0, W - 1)[:, None])[:, 0], w_la)
        consider(j, k_la, w_la, ends & (w_la >= 0) & (w_la < W) & (j < lb))
        key1 = torch.where(i_at_j0 + (j + 1) <= la[:, None], key(P, iota_w), X.BIGK)
        k_be = key1.min(dim=1).values
        w_be = torch.where(key1 == k_be[:, None], iota_w, W).min(dim=1).values
        consider(j, k_be, w_be, ends & (lb == j + 1))
        if (j + 1) % (X.WINDOW // 2) == 0:
            colmin = (P >> lw).min(dim=1).values
            in_cap = (j + 1) <= win_cap
            if (j + 1) % X.WINDOW == 0:
                wmax = torch.where(in_cap, torch.maximum(wmax, colmin - wprev), wmax)
                wprev = colmin
            else:
                if j + 1 != X.WINDOW // 2:
                    wmax2 = torch.where(in_cap, torch.maximum(wmax2, colmin - wprev2), wmax2)
                wprev2 = colmin
    return best[0], best[2], best[3], best[4], torch.maximum(wmax, wmax2)


@pytest.mark.parametrize("W", [20, 64, 128, 256, 512])
def test_kernel4_quiet_steps_fire_no_endpoint(W):
    """The W-band body's design (kernels 3 and 4) on the CPU, at each of
    kernel 3's width classes: in the 8-column steps that
    dense_quiet_steps clears, dp_core's masks let neither endpoint fire;
    and dp_core's loop run as the kernel runs it (no validity mask, endpoint
    tests only outside quiet steps, or in every step, as a warp-mate's steps
    may force) gives dp_core's outputs on pairs with negative d0, d0 near
    la, short a and short b."""
    rng = np.random.default_rng(7 + W)
    J = 512
    # at W = 512 a pair has columns past its live ones only where b runs
    # over 256 columns past a's end: longer reads make such pairs
    a, b, la, lb, d0 = edited_pairs(rng, 10, 300 if W <= 256 else 1200, W)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    a2, b2, la_t, lb_t = X.stage_pairs(
        torch.from_numpy(oriented), torch.from_numpy(lengths), _t(a_oid), _t(b_oid), _t(d0), W, J
    )
    d = _t(d0)
    quiet = X.dense_quiet_steps(la_t, lb_t, d, W, J)
    assert quiet.shape == (10, J // 8) and bool(quiet.any()) and not bool(quiet.all())
    # dp_core's masks at every column of a quiet step the pair still runs
    jj = torch.arange(J)[None, :]
    half = W // 2
    lac, lbc = la_t.long()[:, None], lb_t.long()[:, None]
    i_lo = d[:, None] + jj + 1 - half  # row of band cell 0 after column jj
    w_la = lac - i_lo
    la_fires = (w_la >= 0) & (w_la < W) & (jj < lbc)
    lb_fires = (jj + 1 == lbc) & (i_lo <= lac) & (i_lo + W - 1 >= 0)  # a valid cell
    # between its live columns and min(J, lb) a pair's band lies on a row past la
    live, ncol = X.dense_live_cols(la_t, lb_t, d, W, J)[:, None], lbc.clamp(max=J)
    assert bool((live < ncol).any())
    assert bool(((jj < live) | (jj >= ncol) | (i_lo > lac)).all())
    q_cols = quiet.repeat_interleave(8, dim=1) & (jj < ncol)
    assert not bool((q_cols & (la_fires | lb_fires)).any())
    want = [x.long() for x in X.dp_core(a2, b2, la_t, lb_t, d, W)]
    for q in (quiet, torch.zeros_like(quiet)):
        got = _kernel4_design_plain(a2, b2, la_t, lb_t, d, W, q)
        for n, w_, g in zip(("cost", "i0", "iend", "jend", "win"), want, got):
            assert torch.equal(w_, g), (W, n)


def _resident_windows(oriented, a_oid, b_oid, d0, W: int, J: int):
    """The band windows kernel 3 reads from the resident matrix: a2[p, t] is
    the matrix byte at offset a_oid * LA + d0 - W/2 + t and b2[p, j] the one
    at b_oid * LA + j, each offset clamped into the matrix, so outside a read
    they hold its row's zero pad, a neighbouring row or the matrix's first
    or last byte, never 254 / 255.  Also returns the unclamped a offsets."""
    flat = torch.from_numpy(oriented).reshape(-1)
    LA = oriented.shape[1]
    t = torch.arange(J + W)[None, :]
    ai = _t(a_oid)[:, None] * LA + _t(d0)[:, None] - W // 2 + t
    bi = _t(b_oid)[:, None] * LA + t[:, :J]
    n = flat.numel()
    return flat[ai.clamp(0, n - 1)], flat[bi.clamp(0, n - 1)], ai


@pytest.mark.parametrize("W", [20, 64, 200, 256, 512])
def test_out_of_read_codes_change_nothing(W):
    """Kernel 3's code source on the CPU: dp_core on the windows the kernel
    reads (the matrix's own bytes outside each read, at offsets clamped into
    it, no 254 / 255 pads) gives wband_plain's outputs, on pairs on row 0
    with d0 < W/2, on the last row (windows off both ends of the matrix),
    with negative d0, d0 near la, short a and short b."""
    rng = np.random.default_rng(40 + W)
    J = 512
    oriented, lengths, a_oid, b_oid, d0 = resident_pairs(rng, 10, 300, W)
    codes, lens = torch.from_numpy(oriented), torch.from_numpy(lengths)
    a, b, d = (_t(x) for x in (a_oid, b_oid, d0))
    a2, b2, ai = _resident_windows(oriented, a_oid, b_oid, d0, W, J)
    assert int(ai.min()) < 0 and int(ai.max()) >= oriented.size
    staged_a2, staged_b2, la, lb = X.stage_pairs(codes, lens, a, b, d, W, J)
    assert bool((staged_a2 == 254).any()) and bool((staged_b2 == 255).any())
    assert int(a2.max()) < 254 and int(b2.max()) < 254  # no pad codes
    want = X.wband_plain(codes, lens, a, b, d, W, J)
    assert int((want[0] < int(X.BIG)).sum()) >= 5  # real alignments, not only misses
    got = X.dp_core(a2, b2, la, lb, d, W)
    for n, w_, g in zip(("cost", "i0", "iend", "jend", "win"), want, got):
        assert torch.equal(w_.long(), g), (W, n)


def test_column_order_moved_groups_alike_at_both_key_widths():
    """column_order, in overlap.extend (kernels 1, 2 and 4 launch in
    it; myers_cuda takes it from there): one-byte (J <= 8192) and two-byte
    keys group by 32-column blocks alike, most blocks first, and the wide
    key orders block counts past 255."""
    from phasm_tpu_torch.overlap import myers_cuda as MC

    assert MC.column_order is X.column_order
    rng = np.random.default_rng(5)
    cols = torch.from_numpy(rng.integers(0, 8192, 3000).astype(np.int32))
    blocks = (cols.clamp(max=8191) >> 5).long()
    narrow, wide = X.column_order(cols, 8192), X.column_order(cols, 16384)
    for order in (narrow, wide):
        assert order.dtype == torch.int64
        assert torch.equal(order.sort().values, torch.arange(cols.numel()))
    assert torch.equal(blocks[narrow], blocks[wide])
    assert bool((blocks[narrow][1:] <= blocks[narrow][:-1]).all())
    long_cols = torch.from_numpy(rng.integers(0, 20000, 3000).astype(np.int32))
    long_blocks = (long_cols.clamp(max=16383) >> 5).long()
    got = long_blocks[X.column_order(long_cols, 16384)]
    assert torch.equal(got, long_blocks.sort(descending=True).values) and int(got[0]) == 511
