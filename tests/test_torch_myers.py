"""Port Myers path (phasm_tpu_torch.overlap.myers / myers_cuda) == the JAX
reference: the plain torch pair core against ``myers._myers_pair_core``,
``myers_oracle`` and one interpret-mode Pallas case, bit for bit; the
match-mask-table window arithmetic that kernels 1 and 2 use against the
plain prep's windows; and the CPU wrappers' routing to the plain version.

Inputs come from numpy with fixed seeds (tests/test_myers.py generators).
"""
import numpy as np
import pytest
import torch

from phasm_tpu.overlap import myers as M
from phasm_tpu.overlap import myers_pallas as MP
from phasm_tpu_torch.overlap import myers as TM
from phasm_tpu_torch.overlap import myers_cuda as MC
from phasm_tpu_torch.state import DeviceReads, match_mask_table

from test_myers import as_oriented, random_overlap_case

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers

NAMES = ("cost", "i0", "iend", "jend", "win")


def _port(a, b, la, lb, d0, W, J):
    t = lambda x: torch.from_numpy(np.asarray(x)).long()  # noqa: E731
    return [x.numpy() for x in TM.pair_core(t(a), t(b), t(la), t(lb), t(d0), W, J)]


def _check_vs_reference(a, b, la, lb, d0, W, J):
    want = M._myers_pair_core(
        a, b, la.astype(np.int32), lb.astype(np.int32), d0.astype(np.int32), W, J
    )
    got = _port(a, b, la, lb, d0, W, J)
    for n, w, g in zip(NAMES, want, got):
        assert np.array_equal(np.asarray(w), g), (n, np.asarray(w), g)
    for p in range(a.shape[0]):  # and the scalar oracle
        i0, ie, _, je, c, wn = M.myers_oracle(a[p, : la[p]], b[p, : lb[p]], int(d0[p]), W)
        assert (c, i0, ie, je, wn) == tuple(int(x[p]) for x in got)
    return got


@pytest.mark.parametrize("W", [64, 128])
def test_plain_core_matches_reference(W):
    rng = np.random.default_rng(40 + W)
    for err in (0.02, 0.12, 0.25):
        a, b, la, lb, d0 = random_overlap_case(rng, B=5, la_max=320, err=err)
        _check_vs_reference(a, b, la, lb, d0, W, 512)


def test_plain_core_long_pairs_cross_window_marks():
    rng = np.random.default_rng(9)
    a, b, la, lb, d0 = random_overlap_case(rng, B=4, la_max=480, err=0.08, lb_extra=40)
    _check_vs_reference(a, b, la, lb, d0, 64, 640)


def test_plain_core_edge_small_and_degenerate():
    """Short reads, d0 at the edges, exact copies, all-mismatch pairs."""
    rng = np.random.default_rng(1)
    B, LA, LB = 6, 96, 128
    a = np.full((B, LA), 9, dtype=np.uint8)
    b = np.full((B, LB), 9, dtype=np.uint8)
    la = np.array([40, 96, 64, 50, 33, 96], dtype=np.int64)
    lb = np.array([40, 30, 64, 128, 1, 96], dtype=np.int64)
    d0 = np.array([0, 90, 2, 45, 0, 0], dtype=np.int64)
    for p in range(B):
        a[p, : la[p]] = rng.integers(0, 4, la[p])
    b[0, :40] = a[0, :40]
    b[1, :30] = rng.integers(0, 4, 30)
    b[2, :64] = (a[2, 2:66] + 1) % 4
    b[3, :128] = np.concatenate([a[3, 45:50], rng.integers(0, 4, 123)])
    b[4, :1] = a[4, :1]
    b[5, :96] = a[5, :96]
    _check_vs_reference(a, b, la, lb, d0, 64, 128)


def test_plain_core_matches_pallas_interpret():
    """One small case against the Pallas Myers kernels in interpret mode
    (padded to the kernels' 1024-pair block with benign pairs)."""
    rng = np.random.default_rng(3)
    a, b, la, lb, d0 = random_overlap_case(rng, B=6, la_max=200, err=0.1)
    pad = MP.BLK_ROWS * 128 - 6
    a = np.pad(a, ((0, pad), (0, 0)), constant_values=9)
    b = np.pad(b, ((0, pad), (0, 0)), constant_values=9)
    a[6:, 0] = 0
    la = np.pad(la, (0, pad), constant_values=1)
    lb = np.pad(lb, (0, pad))
    d0 = np.pad(d0, (0, pad))
    want = MP.myers_pallas_pair_core(
        a, b, la.astype(np.int32), lb.astype(np.int32), d0.astype(np.int32),
        64, 256, interpret=True,
    )
    got = _port(a, b, la, lb, d0, 64, 256)
    for n, w, g in zip(NAMES, want, got):
        assert np.array_equal(np.asarray(w), g), n


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def _funnel(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh) on uint32 numpy words."""
    lo, hi = lo.astype(np.uint64), hi.astype(np.uint64)
    return (((hi << np.uint64(32)) | lo) >> np.uint64(sh)).astype(np.uint32)


@pytest.mark.parametrize("W", [64, 128])
def test_kernel_table_windows_match_plain_prep(W):
    """The Eq words kernels 1 and 2 read (forward: table word m0 + q;
    reverse: two reversed-table words joined by a funnel shift, zero below
    the reversed prefix) equal the plain prep's windows word for word."""
    rng = np.random.default_rng(11 + W)
    J = 512
    a, b, la, lb, d0 = random_overlap_case(rng, B=6, la_max=300, err=0.1)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    codes = torch.from_numpy(oriented)
    row_len = torch.from_numpy(lengths).long().repeat_interleave(2)
    tf = _u32(match_mask_table(codes, row_len))
    tr = _u32(match_mask_table(codes, row_len, reverse=True))
    PW = tf.shape[1]

    def word(tab, o, w):
        return tab[o, w] if 0 <= w < PW else np.zeros(4, np.uint32)

    t = lambda x: torch.from_numpy(np.asarray(x)).long()  # noqa: E731
    A, Bm = codes[t(a_oid)].long(), codes[t(b_oid)].long()
    LA_, LB_, D0 = t(la), t(lb), t(d0)
    peq, b2T, la_rel, m0 = TM.fwd_prep(A, Bm, LA_, LB_, D0, W, J)
    _, iend_rel, jend, _ = TM.fwd_core(peq, b2T, la_rel, LA_, LB_, D0, W)
    iend = iend_rel + m0 * M.WB
    peq_r, _, row_off = TM.rev_prep(A, Bm, LA_, LB_, iend, jend, D0, W, J)
    peq, peq_r = _u32(peq.to(torch.int32)), _u32(peq_r.to(torch.int32))
    for p in range(a.shape[0]):
        o = int(a_oid[p])
        for q in range(peq.shape[0]):
            assert np.array_equal(word(tf, o, int(m0[p]) + q), peq[q, :4, p]), (p, q)
        m0r, ie = int(row_off[p]) // M.WB, int(iend[p])
        for q in range(peq_r.shape[0]):
            wr = m0r + q
            if wr < 0:
                want = np.zeros(4, np.uint32)
            else:
                bit = int(la[p]) - ie + M.WB * wr
                w0, sh = bit >> 5, bit & 31
                want = _funnel(word(tr, o, w0), word(tr, o, w0 + 1), sh)
            assert np.array_equal(want, peq_r[q, :4, p]), (p, q)


def test_cpu_wrappers_run_the_plain_version():
    """On CPU tensors the kernel wrappers run the plain core (and count no
    launch); the pair path equals the reference's myers_overlap_batch."""
    rng = np.random.default_rng(5)
    a, b, la, lb, d0 = random_overlap_case(rng, B=5, la_max=260, err=0.08)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    before = (MC.myers_fwd_launches, MC.myers_rev_launches)
    want = M.myers_overlap_batch(
        oriented, lengths, a_oid, b_oid, d0.astype(np.int32), band=64, jmax=512
    )
    got = MC.myers_overlap_batch(
        oriented, lengths, a_oid, b_oid, d0, band=64, jmax=512, device="cpu"
    )
    for f in ("a_start", "a_end", "b_start", "b_end", "diffs", "win_cost"):
        assert np.array_equal(np.asarray(getattr(want, f)), getattr(got, f)), f
    assert (MC.myers_fwd_launches, MC.myers_rev_launches) == before
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    assert reads.peq_fwd is None and reads.peq_rev is None
