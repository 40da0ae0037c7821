"""Port Myers table tier == the JAX reference, bit for bit: the whole-read
tables (``build_myers_tables``), the forward and reverse window cuts
(``fwd_prep_tab`` / ``rev_prep_tab``), kernel 5's plain version against
the TPU kernel ``scripts/myers_dma_proto.py::make_fwd_fetch`` in interpret
mode, and the entry point ``myers_compute_tab`` (plain chain on the CPU)
against the reference's pair core, the port's ``myers_pair`` and one
interpret-mode ``myers_pallas_compute_tab`` case.

Inputs come from numpy with fixed seeds (tests/test_myers.py and
tests/test_myers_pallas.py generators); every comparison is exact.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phasm_tpu.overlap import myers as M
from phasm_tpu.overlap import myers_pallas as MP
from phasm_tpu_torch import configs
from phasm_tpu_torch.overlap import myers as TM
from phasm_tpu_torch.overlap import myers_cuda as MC
from phasm_tpu_torch.state import DeviceReads, MyersTables

from test_myers import random_overlap_case
from test_myers_pallas import _as_oriented

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("cost", "i0", "iend", "jend", "win")
# the reference's jnp functions, jitted: eager they cost seconds a call here
_ref_core = jax.jit(M._myers_pair_core, static_argnums=(5, 6))
_ref_fwd_prep = jax.jit(M.fwd_prep_tab, static_argnums=(4, 5))
_ref_rev_prep = jax.jit(M.rev_prep_tab, static_argnums=(2, 6, 7))


def _load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def _edge_case():
    """The pairs of test_myers_pallas.test_tab_prep_matches_gather_edges
    (d0 = 0 so m0 = -2, d0 near la, lb > J = 256, a 1-bp b, short a) and two
    exact copies ending at iend = 252 and 253: with the oriented width 700
    their reverse funnel deltas (700 - iend) % 32 are 0 and 31."""
    rng = np.random.default_rng(5)
    B, LA, LB = 10, 256, 700
    a = np.full((B, LA), 9, dtype=np.uint8)
    b = np.full((B, LB), 9, dtype=np.uint8)
    la = np.array([200, 256, 64, 250, 33, 96, 256, 128, 252, 253], dtype=np.int64)
    lb = np.array([200, 30, 64, 128, 1, 96, 700, 60, 212, 193], dtype=np.int64)
    d0 = np.array([0, 220, 2, 245, 0, 0, 10, 100, 40, 60], dtype=np.int64)
    for p in range(B):
        a[p, : la[p]] = rng.integers(0, 4, la[p])
    b[0, :200] = np.concatenate([a[0, :150], rng.integers(0, 4, 50)])
    b[1, :30] = a[1, 220:250]
    b[2, :64] = (a[2, 2:66] + 1) % 4
    b[3, :5] = a[3, 245:250]
    b[4, :1] = a[4, :1]
    b[5, :96] = a[5, :96]
    b[6, :700] = rng.integers(0, 4, 700)
    b[7, :60] = a[7, 100:160]
    b[8, :212] = a[8, 40:252]
    b[9, :193] = a[9, 60:253]
    return a, b, la, lb, d0


def _case(W: int):
    """Random pairs and the edge pairs in one batch (one call of the
    reference's eager pair core costs seconds)."""
    parts = [random_overlap_case(np.random.default_rng(60 + W), B=10, la_max=300), _edge_case()]

    def rows(i):
        L = max(p[i].shape[1] for p in parts)
        return np.vstack([np.pad(p[i], ((0, 0), (0, L - p[i].shape[1])), constant_values=9) for p in parts])

    return rows(0), rows(1), *(np.concatenate([p[i] for p in parts]) for i in (2, 3, 4))


def _tables(oriented, lengths):
    """(reference tables dict, port MyersTables, port DeviceReads) of one
    oriented matrix."""
    ref = M.build_myers_tables(jnp.asarray(oriented), jnp.asarray(lengths))
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    return ref, MyersTables.from_reads(reads), reads


def test_build_myers_tables_matches_reference():
    """Ragged lengths (1 bp to the full width), a width that is not a
    multiple of 32 or 16, code-4 bases inside reads and filler past them."""
    rng = np.random.default_rng(21)
    n_reads, LA = 9, 203
    lengths = np.concatenate([[1, LA, 32, 33], rng.integers(2, LA, n_reads - 4)]).astype(np.int32)
    oriented = np.full((2 * n_reads, LA), 9, dtype=np.uint8)
    for o in range(2 * n_reads):
        n = lengths[o // 2]
        row = rng.integers(0, 4, n).astype(np.uint8)
        row[rng.random(n) < 0.05] = 4
        oriented[o, :n] = row
    ref = M.build_myers_tables(jnp.asarray(oriented), jnp.asarray(lengths))
    got = MyersTables.from_reads(DeviceReads.from_arrays(oriented, lengths, "cpu"))
    assert got.peq.dtype == torch.int32 and got.bpk.dtype == torch.int32 and got.LA == LA
    assert np.array_equal(_u32(ref["peq"]), _u32(got.peq.numpy()))
    assert np.array_equal(np.asarray(ref["bpk"]), got.bpk.numpy())
    assert got.nbytes == got.peq.numel() * 4 + got.bpk.numel() * 4


@pytest.mark.parametrize("W", [64, 128])
def test_prep_tab_matches_reference(W):
    """fwd_prep_tab / rev_prep_tab (a per-pair gather + funnel over the
    tables) == the reference's barrel-shift versions over gathered rows,
    word for word, at the reverse ends the forward pass finds."""
    J = 256
    a, b, la, lb, d0 = _case(W)
    oriented, lengths, a_oid, b_oid = _as_oriented(a, b, la, lb)
    LA = oriented.shape[1]
    ref, tab, reads = _tables(oriented, lengths)
    peqT = jnp.transpose(ref["peq"][a_oid], (2, 1, 0))
    bpkT = jnp.transpose(ref["bpk"][b_oid], (2, 1, 0))
    A, Bo, D = _t(a_oid), _t(b_oid), _t(d0)
    la_t = reads.lengths[A.long() >> 1]
    lb_t = reads.lengths[Bo.long() >> 1]
    want = _ref_fwd_prep(peqT, bpkT, jnp.asarray(la, jnp.int32), jnp.asarray(d0, jnp.int32), W, J)
    got = TM.fwd_prep_tab(tab.peq, tab.bpk, A, Bo, la_t, D, W, J)
    assert np.array_equal(_u32(want[0]), _u32(got[0].numpy()))
    for w, g in zip(want[1:], got[1:]):
        assert np.array_equal(np.asarray(w), g.numpy())
    _, iend_rel, jend, _ = TM.fwd_win_plain(la_t, lb_t, D, got[0], got[1], W, J)
    iend = iend_rel + TM.WB * got[3].int()
    want_r = _ref_rev_prep(
        peqT, bpkT, LA, jnp.asarray(iend.numpy()), jnp.asarray(jend.numpy()),
        jnp.asarray(d0, jnp.int32), W, J,
    )
    got_r = TM.rev_prep_tab(tab.peq, tab.bpk, A, Bo, LA, iend, jend, D, W, J)
    assert np.array_equal(_u32(want_r[0]), _u32(got_r[0].numpy()))
    assert np.array_equal(np.asarray(want_r[1]), got_r[1].numpy())
    assert np.array_equal(np.asarray(want_r[2]), got_r[2].numpy())
    assert {0, 31} <= set(((LA - iend.numpy()) % TM.WB).tolist())


def test_fwd_fetch_plain_matches_tpu_kernel_interpret():
    """Kernel 5's plain version on the port's unpadded tables == the TPU
    kernel (interpret mode) on the reference's zero-padded ones, and ==
    the reference's fwd_prep_tab, on bench.make_batch pairs whose windows
    run past the table rows' end."""
    proto = _load("myers_dma_proto", "scripts/myers_dma_proto.py")
    bench = _load("bench", "bench.py")
    W, J, B = 64, 1024, 1024
    oriented, lengths, a_oid, b_oid, d0 = bench.make_batch(np.random.default_rng(0), 64, 1200, B, J)
    ref = jax.jit(M.build_myers_tables)(jnp.asarray(oriented), jnp.asarray(lengths.astype(np.int32)))
    PW, BW = ref["peq"].shape[2], ref["bpk"].shape[2]
    peq_p = jnp.pad(ref["peq"], ((0, 0), (0, 0), (0, 96)))
    bpk_p = jnp.pad(ref["bpk"], ((0, 0), (0, 0), (0, J // 16 + 8)))
    ai, bi, di = (jnp.asarray(x.astype(np.int32)) for x in (a_oid, b_oid, d0))
    sfw = (M.fwd_anchor(di, W) + M.F_TAB).astype(jnp.int32)
    k_peq, k_bpk = jax.jit(proto.make_fwd_fetch(W, J, PW + 96, BW, interpret=True))(
        ai, bi, sfw, peq_p, bpk_p
    )
    tab = MyersTables.from_reads(DeviceReads.from_arrays(oriented, lengths, "cpu"))
    A, Bo, D = _t(a_oid), _t(b_oid), _t(d0)
    sfw_t = (TM.fwd_anchor(D, W) + TM.F_TAB).int()
    NBLK = J // TM.WB + TM.K_of(W)
    assert bool(((sfw_t + NBLK) > PW).any())  # some windows leave the row
    n0 = MC.myers_fwd_fetch_launches
    got_peq, got_bpk = MC.myers_fwd_fetch(tab, A, Bo, sfw_t, W, J)
    assert MC.myers_fwd_fetch_launches == n0
    assert got_peq.shape == (NBLK, 4, B) and got_bpk.shape == (J // 16, B)
    assert np.array_equal(_u32(k_peq).reshape(NBLK, 4, B), _u32(got_peq.numpy()))
    assert np.array_equal(np.asarray(k_bpk).reshape(J // 16, B), got_bpk.numpy())
    la = jnp.asarray(lengths.astype(np.int32))[ai >> 1]
    want = _ref_fwd_prep(
        jnp.transpose(ref["peq"][ai], (2, 1, 0)), jnp.transpose(ref["bpk"][bi], (2, 1, 0)),
        la, di, W, J,
    )
    assert np.array_equal(_u32(want[0]), _u32(got_peq.numpy()))
    assert np.array_equal(np.asarray(want[1]), got_bpk.numpy())


@pytest.mark.parametrize("W", [64, 128])
def test_compute_tab_matches_reference_core_and_myers_pair(W):
    """The table tier (windows packed to 2-bit codes, PAD read as code 0
    past lb) gives the reference pair core's answer and the resident
    path's, on random pairs and the edge pairs (lb > J, 1-bp b)."""
    J = 256
    a, b, la, lb, d0 = _case(W)
    oriented, lengths, a_oid, b_oid = _as_oriented(a, b, la, lb)
    _, tab, reads = _tables(oriented, lengths)
    A, Bo, D = _t(a_oid), _t(b_oid), _t(d0)
    got = MC.myers_compute_tab(tab, reads.lengths, A, Bo, D, W, J)
    want = _ref_core(a, b, la.astype(np.int32), lb.astype(np.int32), d0.astype(np.int32), W, J)
    pair = MC.myers_pair(reads, A, Bo, D, W, J)
    for n, g, w, p in zip(NAMES, got, want, pair):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy()), n
        assert torch.equal(g, p), n


def test_compute_tab_matches_pallas_tab_interpret():
    """One case against the reference's own table tier
    (``myers_pallas_compute_tab``, interpret mode): the edge pairs plus a
    pair whose b holds an N (code 4) over an A of a.  Both tab tiers read
    that N as an A (2-bit packing), so they agree there too, and their cost
    is one below the pair core's (here its twin ``myers_pair``), where an N
    matches nothing."""
    a, b, la, lb, d0 = _edge_case()
    rng = np.random.default_rng(8)
    a_n = rng.integers(0, 4, a.shape[1]).astype(np.uint8)
    a_n[70] = 0
    b_n = np.full(b.shape[1], 9, dtype=np.uint8)
    b_n[:100] = a_n[20:120]
    b_n[50] = 4
    a, b = np.vstack([a, a_n]), np.vstack([b, b_n])
    la, lb, d0 = np.append(la, 120), np.append(lb, 100), np.append(d0, 20)
    W, J = 64, 128
    oriented, lengths, a_oid, b_oid = _as_oriented(a, b, la, lb)
    ref, tab, reads = _tables(oriented, lengths)
    want = MP.myers_pallas_compute_tab(
        ref["peq"], ref["bpk"], lengths, a_oid, b_oid, d0.astype(np.int32),
        LA=oriented.shape[1], W=W, J=J, interpret=True,
    )
    A, Bo, D = _t(a_oid), _t(b_oid), _t(d0)
    got = MC.myers_compute_tab(tab, reads.lengths, A, Bo, D, W, J)
    for n, w, g in zip(NAMES, want, got):
        assert np.array_equal(np.asarray(w), g.numpy()), n
    core = MC.myers_pair(reads, A, Bo, D, W, J)
    assert int(got[0][-1]) == 0 and int(core[0][-1]) == 1
    for n, w, g in zip(NAMES, core, got):
        assert torch.equal(w[:-1], g[:-1]), n


def test_cpu_wrappers_count_no_launches_and_cuda_raises():
    """On the CPU the table tier runs its plain versions and counts no
    launch; the main path's launch counts do not list it; asking for a
    missing card raises, as do shapes outside the kernels' contract."""
    rng = np.random.default_rng(13)
    a, b, la, lb, d0 = random_overlap_case(rng, B=4, la_max=200, err=0.08)
    oriented, lengths, a_oid, b_oid = _as_oriented(a, b, la, lb)
    counts = lambda: (  # noqa: E731
        MC.myers_fwd_fetch_launches, MC.myers_fwd_win_launches, MC.myers_rev_win_launches
    )
    before = counts()
    got = MC.myers_overlap_batch_tab(oriented, lengths, a_oid, b_oid, d0, 64, 256, device="cpu")
    want = MC.myers_overlap_batch(oriented, lengths, a_oid, b_oid, d0, 64, 256, device="cpu")
    for f in ("a_start", "a_end", "b_start", "b_end", "diffs", "win_cost"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert counts() == before
    assert set(configs.launch_counts()) == {"myers_fwd", "myers_rev", "wband"}
    assert DeviceReads.from_arrays(oriented, lengths, "cpu").peq_fwd is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MC.myers_overlap_batch_tab(oriented, lengths, a_oid, b_oid, d0, 64, 256)
        with pytest.raises(RuntimeError):
            DeviceReads.from_arrays(oriented, lengths, "cuda")
    _, tab, reads = _tables(oriented, lengths)
    args = (tab, reads.lengths, _t(a_oid), _t(b_oid), _t(d0))
    for W, J in ((256, 512), (64, 1000)):
        with pytest.raises(ValueError):
            MC.myers_compute_tab(*args, W, J)
