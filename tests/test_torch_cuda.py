"""CUDA kernels (phasm_tpu_torch/csrc) == their plain torch versions on
the card, integer for integer, on the random cases of tests/test_myers.py.

Needs a CUDA card and nvcc (the kernels build at first use); skips
without a card.  Run on the card, whose machine has no JAX (so skip
tests/conftest.py, which imports it):
    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from phasm_tpu_torch._build import index_tensors
from phasm_tpu_torch.overlap import extend as X
from phasm_tpu_torch.overlap import myers as plain
from phasm_tpu_torch.overlap import myers_cuda as MC
from phasm_tpu_torch.overlap.engine import DeviceExtender
from phasm_tpu_torch.state import DeviceReads, MyersBlockedTables, MyersTables

from test_myers import as_oriented, random_overlap_case
from torch_cases import edited_pairs, resident_pairs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_reads():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def make(seed, B=64, la_max=700, err=0.1, cut=False):
        """cut: b lengths cut to 0..71 on the first pairs and to random
        lengths on the next 32, so loops end inside a column group and
        before the first block's end."""
        rng = np.random.default_rng(seed)
        a, b, la, lb, d0 = random_overlap_case(rng, B=B, la_max=la_max, err=err)
        if cut:
            short = [1, 7, 3, 9, 0, 8, 33, 71][:B]
            lb[: len(short)] = short
            lb[8:40] = np.minimum(lb[8:40], rng.integers(10, 400, lb[8:40].shape[0]))
        oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
        reads = DeviceReads.from_arrays(oriented, lengths, "cuda")
        return reads, index_tensors(reads.device, a_oid, b_oid, d0)

    return make


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


# K_of(W) = 4..7 and rev_K(W) = 7..10; one pair, a warp and one more, many
# warps; pairs that end inside the last 1024 columns at J = 2048
MYERS_W = [20, 64, 96, 128]
MYERS_B = [1, 33, 200]
MYERS_J = [1024, 2048]
# b lengths: some past J at J = 1024, some past 1024 at J = 2048
LA_MAX = {1024: 1124, 2048: 1748}


def _myers_case(cuda_reads, W, B, J):
    """Mixed pair lengths (some under 8 columns or off the 8-column groups)
    in an oriented matrix whose width is no multiple of 16."""
    reads, idx = cuda_reads(1000 * W + 10 * B + J // 1024, B=B, la_max=LA_MAX[J], cut=True)
    assert reads.codes.shape[1] % 16 != 0
    return reads, idx


@pytest.mark.parametrize("J", MYERS_J)
@pytest.mark.parametrize("B", MYERS_B)
@pytest.mark.parametrize("W", MYERS_W)
def test_myers_kernels_match_plain(cuda_reads, W, B, J):
    """Kernels 1 and 2 (pairs launched in column order) == their plain
    versions; the same batch in reversed pair order gives the same
    per-pair outputs."""
    reads, (a, b, d) = _myers_case(cuda_reads, W, B, J)
    n0, r0 = MC.myers_fwd_launches, MC.myers_rev_launches
    fwd = MC.myers_fwd(reads, a, b, d, W, J)
    _equal(fwd, plain.fwd_plain(reads.codes, reads.lengths, a, b, d, W, J))
    ie, je = fwd[1], fwd[2]
    rev = MC.myers_rev(reads, a, b, d, ie, je, W, J)
    _equal(rev, plain.rev_plain(reads.codes, reads.lengths, a, b, d, ie, je, W, J))
    assert (MC.myers_fwd_launches, MC.myers_rev_launches) == (n0 + 1, r0 + 1)
    flip = [t.flip(0).contiguous() for t in (a, b, d, ie, je)]
    _equal(MC.myers_fwd(reads, *flip[:3], W, J), [t.flip(0) for t in fwd])
    _equal(MC.myers_rev(reads, *flip, W, J), [t.flip(0) for t in rev])


def test_myers_kernels_match_plain_past_8192(cuda_reads):
    """Kernels 1 and 2 at W = 128, J = 16384, where column_order's key is two
    bytes wide: b lengths up to ~12,000 give block counts past 255."""
    W, J = 128, 16384
    reads, (a, b, d) = cuda_reads(16384, B=40, la_max=12000, err=0.05)
    assert int((reads.lengths[b.long() >> 1] >> 5).max()) > 255
    fwd = MC.myers_fwd(reads, a, b, d, W, J)
    _equal(fwd, plain.fwd_plain(reads.codes, reads.lengths, a, b, d, W, J))
    ie, je = fwd[1], fwd[2]
    _equal(MC.myers_rev(reads, a, b, d, ie, je, W, J),
           plain.rev_plain(reads.codes, reads.lengths, a, b, d, ie, je, W, J))


# kernel 3's width classes (8 x 8, 8 x 16, 16 x 16, 32 x 16 lanes x cells),
# each at its full band and at bands that leave cells past the band
WBAND_W = [1, 20, 33, 64, 65, 96, 128, 129, 200, 256, 300, 512]


def _resident_case(seed, B, W, la_max, err=0.1):
    """resident_pairs on the card: pairs on row 0 with d0 < W/2 and on the
    last row (windows off both ends of the matrix), LA no multiple of 8,
    negative d0, d0 near la, lb under 8 and off the 8-column steps, short a."""
    rng = np.random.default_rng(seed)
    oriented, lengths, a_oid, b_oid, d0 = resident_pairs(rng, B, la_max, W, err)
    assert oriented.shape[1] % 8 != 0
    reads = DeviceReads.from_arrays(oriented, lengths, "cuda")
    return reads, index_tensors(reads.device, a_oid, b_oid, d0)


def _wband_matches(reads, idx, W, J):
    """Kernel 3 == its plain version, and the batch in reversed pair order
    gives the same per-pair outputs."""
    a, b, d = idx
    want = X.wband_plain(reads.codes, reads.lengths, a, b, d, W, J)
    n0 = X.wband_launches
    _equal(X.wband(reads, a, b, d, W, J), want)
    flip = [t.flip(0).contiguous() for t in (a, b, d)]
    _equal(X.wband(reads, *flip, W, J), [t.flip(0) for t in want])
    assert X.wband_launches == n0 + 2


@pytest.mark.parametrize("J", [1003, 1024])
@pytest.mark.parametrize("W", WBAND_W)
def test_wband_kernel_matches_plain(cuda_reads, W, J):
    """Kernel 3 on every width class, full and odd bands, and at a J that is
    no multiple of 8: random pairs, then edited pairs at the matrix's edges."""
    reads, idx = cuda_reads(W + 1, B=32, la_max=500)
    _wband_matches(reads, idx, W, J)
    reads, idx = _resident_case(10 * W + J, 40, W, 900)
    _wband_matches(reads, idx, W, J)


@pytest.mark.parametrize("J", [12288, 16384])
@pytest.mark.parametrize("W", [64, 128, 256, 512])
def test_wband_kernel_matches_plain_at_long_buckets(cuda_reads, W, J):
    """Kernel 3 at the long column buckets (c3's J = 12288, round-2's
    16384: column_order's two-byte key) on b rows past 8192 columns."""
    reads, idx = _resident_case(J + W, 24, W, J - 1000, err=0.05)
    assert int(reads.lengths.max()) > 8192
    _wband_matches(reads, idx, W, J)


def test_kernels_reject_what_they_do_not_take(cuda_reads):
    reads, (a, b, d) = cuda_reads(1, B=4, la_max=200)
    with pytest.raises(ValueError):
        MC.myers_fwd(reads, a.long(), b, d, 64, 1024)
    with pytest.raises(ValueError):
        MC.myers_fwd(reads, a, b, d, 256, 1024)
    with pytest.raises(ValueError):
        X.wband(reads, a, b, d, 513, 1024)
    a2, b2, la, lb = X.stage_pairs(reads.codes, reads.lengths, a, b, d, 64, 1024)
    n0 = X.wband_dense_launches
    for bad in ((a2, b2, la, lb, d, 129), (a2.long(), b2, la, lb, d, 64),
                (a2, b2[:, :1001].contiguous(), la, lb, d, 64), (a2, b2, la.long(), lb, d, 64)):
        with pytest.raises(ValueError):
            X.wband_dense(*bad)
    assert X.wband_dense_launches == n0


@pytest.mark.parametrize("W", [20, 96, 200, 300, 512])
def test_extender_runs_every_kernel_band_through_the_kernel(cuda_reads, W):
    """Bands of every width class, full and not, at a long bucket (W-band
    routing) reach kernel 3 on the card, not the plain version, on pairs at
    the matrix's edges."""
    reads, (a, b, d) = _resident_case(7 + W, 16, W, 500)
    ext = DeviceExtender(reads, band=64, backend="myers_pallas")
    n0 = X.wband_launches
    out, M = ext.extend_async(a.cpu().numpy(), b.cpu().numpy(), d.cpu().numpy(), 12288, band=W)
    assert X.wband_launches == n0 + 1 and M == a.shape[0]
    _equal(out, X.wband_plain(reads.codes, reads.lengths, a, b, d, W, 12288))


def _dense_case(seed, B, W, J, la_max, err=0.1):
    """Edited pairs on the card: (reads, (a, b, d), staged a2, b2, la, lb)."""
    rng = np.random.default_rng(seed)
    a, b, la, lb, d0 = edited_pairs(rng, B, la_max, W, err)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    reads = DeviceReads.from_arrays(oriented, lengths, "cuda")
    a_, b_, d_ = index_tensors(reads.device, a_oid, b_oid, d0)
    return reads, (a_, b_, d_), X.stage_pairs(reads.codes, reads.lengths, a_, b_, d_, W, J)


def _dense_matches(reads, idx, staged, W, J):
    """Kernel 4 == its plain version == kernel 3, and the batch in reversed
    pair order gives the same per-pair outputs."""
    a, b, d = idx
    a2, b2, la, lb = staged
    want = X.wband_dense_plain(a2, b2, la, lb, d, W)
    _equal(want, X.wband(reads, a, b, d, W, J))
    flip = [t.flip(0).contiguous() for t in (a2, b2, la, lb, d)]
    n0 = X.wband_dense_launches
    _equal(X.wband_dense(a2, b2, la, lb, d, W), want)
    _equal(X.wband_dense(*flip, W), [t.flip(0) for t in want])
    assert X.wband_dense_launches == n0 + 2


DENSE_W = [1, 20, 33, 64, 65, 100, 128]


@pytest.mark.parametrize("J", [256, 1024])
@pytest.mark.parametrize("B", [1, 3, 5, 40])
@pytest.mark.parametrize("W", DENSE_W)
def test_wband_dense_kernel_matches_plain_and_kernel_3(cuda_reads, W, B, J):
    """Kernel 4 on staged windows == its plain version == kernel 3 on the
    same pairs (both compute dp_core's function at W <= 128), on ragged
    warps of edited pairs:
    negative d0, d0 near la, b lengths under 8 and off the multiples of 8,
    a shorter than the band."""
    reads, idx, staged = _dense_case(100 * W + 10 * B + J // 256, B, W, J, 300 if J == 256 else 900)
    _dense_matches(reads, idx, staged, W, J)


@pytest.mark.parametrize("W", [64, 128])
def test_wband_dense_kernel_matches_plain_at_12288(cuda_reads, W):
    """Kernel 4 at c3's column bucket, J = 12288, on b rows up to ~11,000."""
    reads, idx, staged = _dense_case(12289 + W, 40, W, 12288, 12000, err=0.05)
    assert int(staged[3].max()) > 8192
    _dense_matches(reads, idx, staged, W, 12288)


def test_wband_dense_kernel_takes_unaligned_windows(cuda_reads):
    """Windows whose rows start off an 8-byte boundary take the byte-load
    path, with every step masked, and give the same outputs."""
    W, J = 64, 1024
    reads, (a, b, d), (a2, b2, la, lb) = _dense_case(17, 40, W, J, 900)
    want = X.wband_dense_plain(a2, b2, la, lb, d, W)
    shifted = []
    for t in (a2, b2):
        buf = torch.empty(t.numel() + 8, dtype=torch.uint8, device=t.device)
        view = buf[3 : 3 + t.numel()].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 8 == 3
        shifted.append(view)
    _equal(X.wband_dense(*shifted, la, lb, d, W), want)


def test_banded_overlap_cuda_matches_batch(cuda_reads):
    """The entry point from host arrays: kernel 4 == the plain batch."""
    reads, (a, b, d) = cuda_reads(3, B=50, la_max=700)
    args = (reads.codes.cpu().numpy(), reads.lengths.cpu().numpy(),
            a.cpu().numpy(), b.cpu().numpy(), d.cpu().numpy())
    got = X.banded_overlap_cuda(*args, band=64, jmax=1024)
    want = X.banded_overlap_batch(*args, band=64, jmax=1024)
    for f in ("a_start", "a_end", "b_start", "b_end", "diffs", "win_cost"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# -- the Myers table tier: kernel 5 and the window-fed kernels 1 and 2 --


@pytest.mark.parametrize("B", [0, 1, 1000])
def test_fwd_fetch_kernel_matches_plain(cuda_reads, B):
    """Kernel 5 == its plain gather, windows running past the table rows'
    end (700-bp reads, J = 1024) and a pair count that is no multiple of
    anything; B = 0 launches nothing."""
    W, J = 64, 1024
    reads, (a, b, d) = cuda_reads(100 + B, B=max(B, 1), la_max=700)
    a, b, d = a[:B], b[:B], d[:B]
    tables = MyersTables.from_reads(reads)
    sfw = (plain.fwd_anchor(d, W) + plain.F_TAB).int()
    NBLK = J // 32 + plain.K_of(W)
    if B == 1000:
        assert bool((sfw + NBLK > tables.peq.shape[2]).any())
    n0 = MC.myers_fwd_fetch_launches
    got = MC.myers_fwd_fetch(tables, a, b, sfw, W, J)
    assert MC.myers_fwd_fetch_launches == n0 + (B > 0)
    assert got[0].shape == (NBLK, 4, B) and got[1].shape == (J // 16, B)
    _equal(got, MC.myers_fwd_fetch_plain(tables, a, b, sfw, W, J))


@pytest.mark.parametrize("J", MYERS_J)
@pytest.mark.parametrize("B", MYERS_B)
@pytest.mark.parametrize("W", MYERS_W)
def test_window_kernels_match_resident_and_plain(cuda_reads, W, B, J):
    """Window-fed kernels 1 and 2 on kernel 5's and rev_prep_tab's windows
    == the resident kernels on the same pairs == their plain versions."""
    reads, (a, b, d) = _myers_case(cuda_reads, W, B, J)
    tables = MyersTables.from_reads(reads)
    la, lb = reads.lengths[a.long() >> 1], reads.lengths[b.long() >> 1]
    m0 = plain.fwd_anchor(d, W)
    peq_f, bpk_f = MC.myers_fwd_fetch(tables, a, b, (m0 + plain.F_TAB).int(), W, J)
    n0, r0 = MC.myers_fwd_win_launches, MC.myers_rev_win_launches
    cost, iend_rel, jend, win = MC.myers_fwd_win(la, lb, d, peq_f, bpk_f, W, J)
    iend = (iend_rel + 32 * m0).int()
    _equal((cost, iend, jend, win), MC.myers_fwd(reads, a, b, d, W, J))
    _equal((cost, iend_rel, jend, win), plain.fwd_win_plain(la, lb, d, peq_f, bpk_f, W, J))
    peq_r, bpk_r, row_off = plain.rev_prep_tab(
        tables.peq, tables.bpk, a, b, tables.LA, iend, jend, d, W, J
    )
    rev = MC.myers_rev_win(row_off.int(), iend, jend, peq_r, bpk_r, W, J)
    _equal(rev, MC.myers_rev(reads, a, b, d, iend, jend, W, J))
    _equal(rev, plain.rev_win_plain(row_off, iend, jend, peq_r, bpk_r, W, J))
    assert (MC.myers_fwd_win_launches, MC.myers_rev_win_launches) == (n0 + 1, r0 + 1)


def test_compute_tab_matches_myers_pair(cuda_reads):
    """The table tier's entry point == the resident pair path, on tensors
    and from host arrays."""
    reads, (a, b, d) = cuda_reads(9, B=80, la_max=1200)
    tables = MyersTables.from_reads(reads)
    _equal(MC.myers_compute_tab(tables, reads.lengths, a, b, d, 64, 2048),
           MC.myers_pair(reads, a, b, d, 64, 2048))
    args = (reads.codes.cpu().numpy(), reads.lengths.cpu().numpy(),
            a.cpu().numpy(), b.cpu().numpy(), d.cpu().numpy())
    got = MC.myers_overlap_batch_tab(*args, band=128, jmax=1024)
    want = MC.myers_overlap_batch(*args, band=128, jmax=1024)
    for f in ("a_start", "a_end", "b_start", "b_end", "diffs", "win_cost"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_tab_kernels_reject_what_they_do_not_take(cuda_reads):
    reads, (a, b, d) = cuda_reads(2, B=4, la_max=200)
    tables = MyersTables.from_reads(reads)
    W, J = 64, 1024
    sfw = (plain.fwd_anchor(d, W) + plain.F_TAB).int()
    n0 = MC.myers_fwd_fetch_launches
    for bad in ((a.long(), b, sfw, W, J), (a, b, sfw, 256, J), (a, b, sfw, W, 1000),
                (a, b[:3], sfw, W, J)):
        with pytest.raises(ValueError):
            MC.myers_fwd_fetch(tables, *bad)
    assert MC.myers_fwd_fetch_launches == n0
    peq_f, bpk_f = MC.myers_fwd_fetch(tables, a, b, sfw, W, J)
    la, lb = reads.lengths[a.long() >> 1], reads.lengths[b.long() >> 1]
    for bad in ((la, lb, d, peq_f[:-1], bpk_f), (la, lb, d, peq_f, bpk_f.long()),
                (la, lb, d, peq_f, bpk_f, 128)):
        with pytest.raises(ValueError):
            MC.myers_fwd_win(*bad[:5], bad[5] if len(bad) > 5 else W, J)
    with pytest.raises(ValueError):
        MC.myers_compute_tab(tables, reads.lengths, a, b, d, 256, J)


# -- the Myers tab2 tier: kernels 1 and 2 in their tab2 bodies --


@pytest.mark.parametrize("J", [1024, 2048])
@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("B", [0, 1, 1000])
def test_tab2_kernels_match_plain_and_myers_pair(cuda_reads, B, W, J):
    """The tab2 kernels == fwd_tab2_plain / rev_tab2_plain == the resident
    pair path, b lengths past J on some pairs; B = 0 launches nothing."""
    reads, (a, b, d) = cuda_reads(200 + B + W + J, B=max(B, 1), la_max=LA_MAX[J], cut=True)
    a, b, d = a[:B], b[:B], d[:B]
    t2 = MyersBlockedTables.from_reads(reads)
    n0, r0 = MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches
    fwd = MC.myers_fwd_tab2(t2, reads.lengths, a, b, d, W, J)
    _equal(fwd, plain.fwd_tab2_plain(t2.win, reads.lengths, a, b, d, t2.LA, W, J))
    iend = (fwd[1] + 32 * plain.fwd_anchor(d, W)).int()
    rev = MC.myers_rev_tab2(t2, a, b, d, iend, fwd[2], W, J)
    _equal(rev, plain.rev_tab2_plain(t2.win, a, b, t2.LA, iend, fwd[2], d, W, J))
    assert (MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches) == (n0 + (B > 0), r0 + (B > 0))
    _equal(MC.myers_compute_tab2(t2, reads.lengths, a, b, d, W, J),
           MC.myers_pair(reads, a, b, d, W, J))


@pytest.mark.parametrize("J", [1024, 2048])
@pytest.mark.parametrize("W", MYERS_W)
def test_tab2_bodies_match_plain_on_either_side_of_the_rule(cuda_reads, W, J):
    """Both tab2 bodies == fwd_tab2_plain / rev_tab2_plain: 1,000 pairs run
    the slab body (several lanes a pair), the same pairs repeated until the
    rule picks one pair a thread for both passes run that (the reverse pass
    in column order); each call steps each launch count by one."""
    reads, (a, b, d) = cuda_reads(900 + W + J, B=1000, la_max=LA_MAX[J], cut=True)
    t2 = MyersBlockedTables.from_reads(reads)
    want_f = plain.fwd_tab2_plain(t2.win, reads.lengths, a, b, d, t2.LA, W, J)
    iend = (want_f[1] + 32 * plain.fwd_anchor(d, W)).int()
    want_r = plain.rev_tab2_plain(t2.win, a, b, t2.LA, iend, want_f[2], d, W, J)
    many = next(n for n in range(2, 100)
                if all(MC.tab2_body(1000 * n, W, J, rev) == "thread" for rev in (False, True)))
    for copies, body in ((1, "slab"), (many, "thread")):
        B = 1000 * copies
        assert all(MC.tab2_body(B, W, J, rev).split()[0] == body for rev in (False, True))
        ac, bc, dc, ic, jc = (t.repeat(copies) for t in (a, b, d, iend, want_f[2]))
        n0, r0 = MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches
        _equal(MC.myers_fwd_tab2(t2, reads.lengths, ac, bc, dc, W, J), [w.repeat(copies) for w in want_f])
        _equal(MC.myers_rev_tab2(t2, ac, bc, dc, ic, jc, W, J), [w.repeat(copies) for w in want_r])
        assert (MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches) == (n0 + 1, r0 + 1)


def test_tab2_kernels_reject_what_they_do_not_take(cuda_reads):
    reads, (a, b, d) = cuda_reads(3, B=4, la_max=200)
    t2 = MyersBlockedTables.from_reads(reads)
    n0 = MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches
    for args, W, J in (
        ((t2, reads.lengths, a, b, d), 64, 4096),
        ((t2, reads.lengths, a, b, d), 256, 1024),
        ((t2, reads.lengths, a.long(), b, d), 64, 1024),
        ((t2, reads.lengths, a.cpu(), b, d), 64, 1024),
        ((t2, reads.lengths.cpu(), a, b, d), 64, 1024),
        ((MyersBlockedTables(t2.win[:-1], t2.LA, t2.n_o), reads.lengths, a, b, d), 64, 1024),
    ):
        with pytest.raises(ValueError):
            MC.myers_compute_tab2(*args, W, J)
    with pytest.raises(ValueError):
        MC.myers_rev_tab2(t2, a, b, d, d.long(), d, 64, 1024)
    assert (MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches) == n0
    args = (reads.codes.cpu().numpy(), reads.lengths.cpu().numpy(),
            a.cpu().numpy(), b.cpu().numpy(), d.cpu().numpy())
    got = MC.myers_overlap_batch_tab2(*args, band=64, jmax=1024)
    want = MC.myers_overlap_batch(*args, band=64, jmax=1024)
    for f in ("a_start", "a_end", "b_start", "b_end", "diffs", "win_cost"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
