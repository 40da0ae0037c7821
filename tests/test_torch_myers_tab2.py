"""Port Myers tab2 tier == the JAX reference, bit for bit: the blocked table
(``build_myers_tables_blocked``, ``blocked_counts``, ``tab2_offsets``), the
tab2 window cuts (``fwd_prep_tab2`` / ``rev_prep_tab2``: the reference's
coarse-row gathers with their clips, the residual barrel, the reverse bit
and packed-b funnels) against the table tier's windows, and the entry point
``myers_compute_tab2`` (plain versions on the CPU) against one
interpret-mode ``myers_pallas_compute_tab2`` case and the port's
``myers_pair``.

Inputs come from numpy with fixed seeds (tests/test_myers.py and
tests/test_myers_pallas.py generators); every comparison is exact.
"""
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
from phasm_tpu_torch.state import DeviceReads, MyersBlockedTables, MyersTables

from test_myers import as_oriented, random_overlap_case
from test_myers_pallas import _as_oriented

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers

NAMES = ("cost", "i0", "iend", "jend", "win")
_ref_blocked = jax.jit(M.build_myers_tables_blocked)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))


def _blocked(oriented, lengths):
    """The reference's blocked table of one oriented matrix, carried into
    the port (``MyersBlockedTables.from_arrays``)."""
    ref = _ref_blocked(jnp.asarray(oriented), jnp.asarray(lengths))["win"]
    return np.asarray(ref), MyersBlockedTables.from_arrays(np.asarray(ref), oriented.shape[1], "cpu")


def test_build_myers_tables_blocked_matches_reference():
    """Ragged lengths (1 bp to the full width), a width that is no multiple
    of 32 or 16, code-4 bases inside reads and filler past them; the row
    counts and offsets over a range of widths."""
    rng = np.random.default_rng(21)
    n_reads, LA = 9, 203
    lengths = np.concatenate([[1, LA, 32, 33], rng.integers(2, LA, n_reads - 4)]).astype(np.int32)
    oriented = np.full((2 * n_reads, LA), 9, dtype=np.uint8)
    for o in range(2 * n_reads):
        n = lengths[o // 2]
        row = rng.integers(0, 4, n).astype(np.uint8)
        row[rng.random(n) < 0.05] = 4
        oriented[o, :n] = row
    ref, carried = _blocked(oriented, lengths)
    got = MyersBlockedTables.from_reads(DeviceReads.from_arrays(oriented, lengths, "cpu"))
    assert got.win.dtype == torch.int32 and (got.LA, got.n_o) == (LA, 2 * n_reads)
    assert np.array_equal(ref.view(np.int32), got.win.numpy())
    assert torch.equal(carried.win, got.win) and (carried.LA, carried.n_o) == (got.LA, got.n_o)
    assert got.nbytes == got.win.numel() * 4
    for LA in list(range(1, 400)) + [2047, 2048, 2049, 7296, 16385]:
        assert TM.blocked_counts(LA) == M.blocked_counts(LA), LA
        assert TM.tab2_offsets(2666, LA) == M.tab2_offsets(2666, LA), LA
    with pytest.raises(ValueError):
        MyersBlockedTables.from_arrays(ref[:-1], LA=203, device="cpu")


# a width past 2048 + 252, so that LA - jend reaches [2032, 2064) at small
# jend: crem = (LA - jend) // 16 % 128 takes 127 and 0 there
WIN_LA = 2300


def _window_case(W: int, J: int):
    """Random pairs plus edge pairs, with forward ends (iend, jend) chosen
    near the pair's diagonal rather than run: d0 = 0 (m0 = -2), d0 near la,
    lb > J, a 1-bp b, d0 at which srem = (m0 + 16) % 32 is 0 and 31, iend
    at which the reverse funnel's delta = (LA - iend) % 32 is 0 and 31, and
    jend at which crem is 0 and 127.  Returns (oriented, lengths, a_oid,
    b_oid, d0, iend, jend)."""
    rng = np.random.default_rng(J + W)
    n = 40
    la = rng.integers(700, WIN_LA + 1, n)
    lb = rng.integers(1, WIN_LA + 1, n)
    d0 = (rng.random(n) * (la - 50)).astype(np.int64)
    la[:4], lb[:4], d0[:4] = WIN_LA, [1, WIN_LA, 600, 900], [0, WIN_LA - 40, 0, 1]
    # srem 31 and 0 at both bands: m0 = 15 / 16
    d0[4:8] = [W // 2 + 32 * 17 - 1, W // 2 + 32 * 17, W // 2 + 32 * 18 - 1, W // 2 + 32 * 17 + 5]
    jend = np.minimum(lb, J) * rng.random(n)
    jend = jend.astype(np.int64)
    jend[8:12] = [WIN_LA - 2048 - 16, WIN_LA - 2048, WIN_LA - 2048 + 1, WIN_LA - 2048 + 20]
    lb[8:12] = np.maximum(lb[8:12], jend[8:12])
    jend[:2] = [1, min(J, WIN_LA)]
    iend = np.clip(d0 + jend + rng.integers(-W // 4, W // 4 + 1, n), 0, la)
    iend[12:14] = [WIN_LA - 32 * 20, WIN_LA - 32 * 20 - 31]  # delta 0 and 31
    la[12:14] = WIN_LA
    jend[12:14] = np.minimum(lb[12:14], np.clip(iend[12:14] - d0[12:14], 0, J))
    oriented = np.full((4 * n, WIN_LA), 9, dtype=np.uint8)
    oriented[: 2 * n : 2] = rng.integers(0, 4, (n, WIN_LA))
    oriented[2 * n :: 2] = rng.integers(0, 4, (n, WIN_LA))
    lengths = np.concatenate([la, lb]).astype(np.int32)
    a_oid, b_oid = 2 * np.arange(n), 2 * (n + np.arange(n))
    return oriented, lengths, a_oid, b_oid, d0, iend, jend


@pytest.mark.parametrize("J", [512, 1024, 2048])
@pytest.mark.parametrize("W", [64, 128])
def test_tab2_windows_match_table_tier(W, J):
    """fwd_prep_tab2 / rev_prep_tab2 over the reference's blocked table ==
    the table tier's fwd_prep_tab / rev_prep_tab over the port's tables,
    word for word, with the residuals and funnel shifts at their extremes."""
    oriented, lengths, a_oid, b_oid, d0, iend, jend = _window_case(W, J)
    _, t2 = _blocked(oriented, lengths)
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    tab = MyersTables.from_reads(reads)
    A, Bo, D, IE, JE = (_t(x) for x in (a_oid, b_oid, d0, iend, jend))
    la = reads.lengths[A.long() >> 1]
    got = TM.fwd_prep_tab2(t2.win, reads.lengths, A, Bo, D, WIN_LA, W, J)
    want = TM.fwd_prep_tab(tab.peq, tab.bpk, A, Bo, la, D, W, J)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got_r = TM.rev_prep_tab2(t2.win, A, Bo, WIN_LA, IE, JE, D, W, J)
    want_r = TM.rev_prep_tab(tab.peq, tab.bpk, A, Bo, WIN_LA, IE, JE, D, W, J)
    for g, w in zip(got_r, want_r):
        assert torch.equal(g, w)
    s = TM.fwd_anchor(d0, W) + TM.F_TAB
    assert {0, 31} <= set((s % 32).tolist())
    assert {0, 31} <= set(((WIN_LA - iend) % 32).tolist())
    assert {0, 127} <= set(((WIN_LA - jend) // 16 % 128).tolist())
    assert int(lengths[len(a_oid) + 1]) > J and int(lengths[len(a_oid)]) == 1


def test_compute_tab2_matches_pallas_tab2_interpret():
    """One case at the reference test's own size (tests/test_myers_pallas.py:
    B = 24, la_max = 320, J = 512, W = 64) against the reference's
    ``myers_pallas_compute_tab2`` in interpret mode, plus a pair whose b
    holds an N (code 4) over an A of a: both tab2 tiers read that N as an A
    (2-bit packing), so their cost there is one below ``myers_pair``'s,
    where an N matches nothing."""
    W, J = 64, 512
    a, b, la, lb, d0 = random_overlap_case(np.random.default_rng(80 + W), B=24, la_max=320, err=0.1)
    rng = np.random.default_rng(8)
    a_n = np.full(a.shape[1], 9, dtype=np.uint8)
    a_n[:200] = rng.integers(0, 4, 200)
    a_n[70] = 0
    b_n = np.full(b.shape[1], 9, dtype=np.uint8)
    b_n[:100] = a_n[20:120]
    b_n[50] = 4
    a, b = np.vstack([a, a_n]), np.vstack([b, b_n])
    la, lb, d0 = np.append(la, 200), np.append(lb, 100), np.append(d0, 20)
    oriented, lengths, a_oid, b_oid = _as_oriented(a, b, la, lb)
    ref, t2 = _blocked(oriented, lengths)
    want = MP.myers_pallas_compute_tab2(
        ref, lengths, a_oid, b_oid, d0.astype(np.int32),
        LA=oriented.shape[1], W=W, J=J, interpret=True,
    )
    A, Bo, D, L = _t(a_oid), _t(b_oid), _t(d0), _t(lengths)
    got = MC.myers_compute_tab2(t2, L, A, Bo, D, W, J)
    for n, w, g in zip(NAMES, want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(np.asarray(w), g.numpy()), n
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    core = MC.myers_pair(reads, A, Bo, D, W, J)
    assert int(got[0][-1]) == 0 and int(core[0][-1]) == 1
    for n, w, g in zip(NAMES, core, got):
        assert torch.equal(w[:-1], g[:-1]), n


@pytest.mark.parametrize("W", [64, 128])
def test_compute_tab2_matches_myers_pair(W):
    """The tab2 tier on the reference's blocked table == the port's
    resident pair path on the same pairs (no N), lb cut short on some and
    past J on others."""
    J = 512
    rng = np.random.default_rng(30 + W)
    a, b, la, lb, d0 = random_overlap_case(rng, B=24, la_max=700, err=0.08)
    lb[:4] = [0, 1, 9, 33]
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    _, t2 = _blocked(oriented, lengths)
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    A, Bo, D = _t(a_oid), _t(b_oid), _t(d0)
    got = MC.myers_compute_tab2(t2, reads.lengths, A, Bo, D, W, J)
    want = MC.myers_pair(reads, A, Bo, D, W, J)
    assert bool((reads.lengths[Bo.long() >> 1] > J).any())
    for n, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), n


def test_tab2_rejects_what_it_does_not_take_and_counts_no_cpu_launch():
    """On the CPU the tab2 tier runs its plain versions and counts no
    launch, and the main path's launch counts do not list it; it raises
    outside tab2_fits (J = 4096), outside K_of 4..7 (W = 256), on int64
    vectors, lengths or table, on vectors of another device, and asking for
    a missing card."""
    rng = np.random.default_rng(13)
    a, b, la, lb, d0 = random_overlap_case(rng, B=4, la_max=200, err=0.08)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    counts = lambda: (MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches)  # noqa: E731
    before = counts()
    got = MC.myers_overlap_batch_tab2(oriented, lengths, a_oid, b_oid, d0, 64, 256, device="cpu")
    want = MC.myers_overlap_batch(oriented, lengths, a_oid, b_oid, d0, 64, 256, device="cpu")
    for f in ("a_start", "a_end", "b_start", "b_end", "diffs", "win_cost"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert counts() == before
    assert set(configs.launch_counts()) == {"myers_fwd", "myers_rev", "wband"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MC.myers_overlap_batch_tab2(oriented, lengths, a_oid, b_oid, d0, 64, 256)
        with pytest.raises(RuntimeError):
            MyersBlockedTables.from_arrays(np.zeros((0, 128), np.uint32), 100)
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    t2 = MyersBlockedTables.from_reads(reads)
    A, Bo, D = _t(a_oid), _t(b_oid), _t(d0)
    bad_table = MyersBlockedTables(win=t2.win.long(), LA=t2.LA, n_o=t2.n_o)
    meta = torch.empty(A.shape, dtype=torch.int32, device="meta")
    for args, W, J in (
        ((t2, reads.lengths, A, Bo, D), 64, 4096),
        ((t2, reads.lengths, A, Bo, D), 256, 1024),
        ((t2, reads.lengths, A.long(), Bo, D), 64, 1024),
        ((t2, reads.lengths.long(), A, Bo, D), 64, 1024),
        ((bad_table, reads.lengths, A, Bo, D), 64, 1024),
        ((t2, reads.lengths, meta, Bo, D), 64, 1024),
        ((t2, reads.lengths, A, Bo[:3], D), 64, 1024),
    ):
        with pytest.raises(ValueError):
            MC.myers_compute_tab2(*args, W, J)
    assert counts() == before
