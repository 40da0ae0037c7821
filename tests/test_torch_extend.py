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
from phasm_tpu_torch.state import DeviceReads

from test_myers import as_oriented, random_overlap_case

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
    pa2, pb2, pla, plb, pd0 = X.band_tensors(
        torch.from_numpy(oriented), torch.from_numpy(lengths), _t(a_oid), _t(b_oid), _t(d0), W, J
    )
    assert np.array_equal(pa2.numpy(), a2) and np.array_equal(pb2.numpy(), b2)
    got = [x.numpy() for x in X.dp_core(pa2, pb2, pla, plb, pd0, W)]
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
            fam = X.route("myers_pallas", W, J)
            assert (fam == "myers") == myers, (W, J, fam)
            if not myers:
                assert fam == ("wband" if W <= 512 else "dp_core"), (W, J, fam)
            assert X.route("pallas", W, J) == ("wband" if W <= 512 else "dp_core")
            assert X.route("jnp", W, J) == "dp_core"
    assert X.route("myers_pallas", 64, 8192) == "myers"
    assert X.route("myers_pallas", 64, 12288) == "wband"
    assert X.route("myers_pallas", 96, 12288) == "wband"
