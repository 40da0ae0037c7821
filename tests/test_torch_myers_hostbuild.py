"""The CUDA source of Myers kernels 1 and 2 (``csrc/myers.cu``), built for
the host with g++ through ``csrc/host_warp_shim.h`` (a warp's 32 lanes run
as fibers that meet at every warp collective), == the plain torch
versions, integer for integer: the resident kernels against ``fwd_plain``
/ ``rev_plain``, the window-fed ones against ``fwd_win_plain`` /
``rev_win_plain`` and the resident ones, the tab2 ones (the slab body on
small batches, one pair a thread on large ones) against ``fwd_tab2_plain``
/ ``rev_tab2_plain`` and the resident ones.

This guards the kernels' index arithmetic (the column-order permutation,
the unrolled column groups and their tail, the vector loads at any row
alignment, the freeze at the pair's own end; the slab body's wavefront,
bubbles and slot moves, its row-la tracker and band-minimum gathers) on a
machine without a card.  The library is cached in the git-ignored
``build/phasm_tpu_torch/``, keyed by the two files' contents and the flags.
"""
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from phasm_tpu_torch._build import ENTRIES, index_tensors
from phasm_tpu_torch.overlap import myers as plain
from phasm_tpu_torch.overlap import myers_cuda as MC
from phasm_tpu_torch.state import DeviceReads, MyersBlockedTables, MyersTables

from test_myers import as_oriented, random_overlap_case

_CSRC = Path(__file__).resolve().parent.parent / "phasm_tpu_torch" / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "phasm_tpu_torch"
_FLAGS = ["-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-x", "c++", "-DPHASM_HOST_SHIM",
          "-include", str(_CSRC / "host_warp_shim.h")]
J = 1024


@pytest.fixture(scope="module")
def lib():
    h = hashlib.sha256()
    for name in ("host_warp_shim.h", "myers.cu"):
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS[:-1]).encode())
    so = _BUILD / f"libmyers_host_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_CSRC / "myers.cu")], check=True)
        os.replace(tmp, so)
    out = ctypes.CDLL(str(so))
    for name, argtypes in ENTRIES.items():
        if hasattr(out, name):
            getattr(out, name).argtypes = argtypes
            getattr(out, name).restype = ctypes.c_int
    return out


def _case(seed, W):
    """About 200 random pairs, with lb cut to 0..9 and to lengths off the
    8-column groups on some, in a matrix whose rows are not 16-byte aligned."""
    rng = np.random.default_rng(seed)
    a, b, la, lb, d0 = random_overlap_case(rng, B=200, la_max=1100)
    lb[:8] = [0, 1, 3, 7, 8, 9, 33, 71]
    lb[8:40] = np.minimum(lb[8:40], rng.integers(10, 400, 32))
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    assert oriented.shape[1] % 16 != 0
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    reads._build_tables()
    return reads, index_tensors(reads.device, a_oid, b_oid, d0)


def _padded_codes(reads):
    """The code matrix in a buffer with room past its end: the kernels' last
    aligned 16-byte word of a row may reach up to 15 bytes beyond it."""
    flat = reads.codes.reshape(-1)
    buf = torch.zeros(flat.numel() + 64, dtype=torch.uint8)
    buf[: flat.numel()] = flat
    return buf


def _outs(n, B):
    return [torch.full((B,), -7, dtype=torch.int32) for _ in range(n)]


def _fwd(lib, reads, order, a, b, d, W):
    B = a.shape[0]
    outs = _outs(4, B)
    buf = _padded_codes(reads)
    err = lib.phasm_myers_fwd(
        order.data_ptr(), a.data_ptr(), b.data_ptr(), d.data_ptr(), reads.lengths.data_ptr(),
        buf.data_ptr(), reads.codes.shape[1], reads.peq_fwd.data_ptr(), reads.peq_fwd.shape[1],
        B, W, J, *(o.data_ptr() for o in outs), None,
    )
    assert err == 0
    return outs


def _rev(lib, reads, order, a, b, d, ie, je, W):
    B = a.shape[0]
    outs = _outs(2, B)
    buf = _padded_codes(reads)
    err = lib.phasm_myers_rev(
        order.data_ptr(), a.data_ptr(), b.data_ptr(), d.data_ptr(), ie.data_ptr(), je.data_ptr(),
        reads.lengths.data_ptr(), buf.data_ptr(), reads.codes.shape[1], reads.peq_rev.data_ptr(),
        reads.peq_rev.shape[1], B, W, J, *(o.data_ptr() for o in outs), None,
    )
    assert err == 0
    return outs


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int32), w.to(torch.int32))


@pytest.mark.parametrize("W", [20, 64, 128])
def test_host_built_kernels_match_plain(lib, W):
    reads, (a, b, d) = _case(W, W)
    B = a.shape[0]
    lb = reads.lengths[b.long() >> 1]
    # the wrappers' column order, and the identity
    order = MC.column_order(lb, J)
    ident = torch.arange(B)
    fwd = _fwd(lib, reads, order, a, b, d, W)
    _equal(fwd, plain.fwd_plain(reads.codes, reads.lengths, a, b, d, W, J))
    _equal(_fwd(lib, reads, ident, a, b, d, W), fwd)
    ie, je = fwd[1], fwd[2]
    rev_order = MC.column_order(je, J)
    rev = _rev(lib, reads, rev_order, a, b, d, ie, je, W)
    _equal(rev, plain.rev_plain(reads.codes, reads.lengths, a, b, d, ie, je, W, J))
    _equal(_rev(lib, reads, ident, a, b, d, ie, je, W), rev)

    # window-fed: kernel 5's windows (plain gather) -> 1w -> rev_prep_tab -> 2w
    tables = MyersTables.from_reads(reads)
    la = reads.lengths[a.long() >> 1]
    m0 = plain.fwd_anchor(d, W)
    peq_f, bpk_f = plain.fwd_fetch(tables.peq, tables.bpk, a, b, (m0 + plain.F_TAB).int(), W, J)
    fw = _outs(4, B)
    assert lib.phasm_myers_fwd_win(
        la.data_ptr(), lb.data_ptr(), d.data_ptr(), peq_f.data_ptr(), bpk_f.data_ptr(),
        B, W, J, *(o.data_ptr() for o in fw), None) == 0
    _equal(fw, plain.fwd_win_plain(la, lb, d, peq_f, bpk_f, W, J))
    _equal((fw[0], fw[1] + 32 * m0, fw[2], fw[3]), fwd)
    peq_r, bpk_r, row_off = plain.rev_prep_tab(
        tables.peq, tables.bpk, a, b, tables.LA, ie, je, d, W, J)
    row_off = row_off.int()
    rw = _outs(2, B)
    assert lib.phasm_myers_rev_win(
        row_off.data_ptr(), ie.data_ptr(), je.data_ptr(), peq_r.data_ptr(), bpk_r.data_ptr(),
        B, W, J, *(o.data_ptr() for o in rw), None) == 0
    _equal(rw, plain.rev_win_plain(row_off, ie, je, peq_r, bpk_r, W, J))
    _equal(rw, rev)


def _top_edge_rows(rng, a, b, la, lb, d0, rows, W):
    """Rows whose alignment rides the band's top edge: b is an exact copy of
    a from row 32 m0 + c (c in -1..1), la_rel = 32 q + (-1..1).  Row la's
    cost then reaches its least (0) in the last column before la's word
    leaves the band, or one column later, so only the forward slab's
    post-window +1 keeps every later column from taking the best."""
    for i, p in enumerate(rows):
        c, off = i % 3 - 1, (i // 3) % 3 - 1
        la_rel = 32 * (5 + (5 * i) % 21) + off
        m0 = int(rng.integers(2, (a.shape[1] - la_rel) // 32 + 1))
        la[p] = 32 * m0 + la_rel
        d0[p] = 32 * (m0 + 1) + W // 2 + int(rng.integers(0, 32))  # fwd_anchor(d0, W) == m0
        a[p, :] = 9
        a[p, : la[p]] = rng.integers(0, 4, la[p])
        row = np.concatenate([a[p, 32 * m0 + c : la[p]], rng.integers(0, 4, 400)])[: b.shape[1]]
        lb[p] = row.size
        b[p, :] = 9
        b[p, : lb[p]] = row


def _tab2_case(W):
    """203 pairs at the tab2 bodies' edges (203 is no multiple of any body's
    pairs a warp): b lengths 0..9 and off the 32-column blocks, d0 swept so
    that row la (la_rel = la - 32 m0) runs from above the band's anchor
    through every band word, hence every lane's words, to below the band,
    and 53 rows whose best at row la falls as la's word leaves the band."""
    rng = np.random.default_rng(W + 7)
    a, b, la, lb, d0 = random_overlap_case(rng, B=203, la_max=1100)
    lb[:8] = [0, 1, 3, 7, 8, 9, 33, 71]
    lb[8:40] = np.minimum(lb[8:40], rng.integers(10, 400, 32))
    sweep = np.arange(-W // 2 - 70, 32 * plain.K_of(W) + 100, 11)
    at = 40 + np.arange(sweep.size)
    d0[at] = la[at] - sweep
    _top_edge_rows(rng, a, b, la, lb, d0, range(150, 203), W)
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    reads._build_tables()
    return reads, index_tensors(reads.device, a_oid, b_oid, d0)


def _tab2_fwd(lib, t2, lengths, a, b, d, W):
    fwd = _outs(4, a.shape[0])
    assert lib.phasm_myers_fwd_tab2(
        a.data_ptr(), b.data_ptr(), d.data_ptr(), lengths.data_ptr(), t2.win.data_ptr(),
        t2.n_o, plain.blocked_counts(t2.LA)[0], a.shape[0], W, J,
        *(o.data_ptr() for o in fwd), None) == 0
    return fwd


def _tab2_rev(lib, t2, a, b, d, iend, jend, W, order=None, err=0):
    rev = _outs(2, a.shape[0])
    NBb, NBc = plain.blocked_counts(t2.LA)
    assert lib.phasm_myers_rev_tab2(
        None if order is None else order.data_ptr(), a.data_ptr(), b.data_ptr(), d.data_ptr(),
        iend.data_ptr(), jend.data_ptr(), t2.win.data_ptr(), t2.LA, t2.n_o, NBb, NBc,
        a.shape[0], W, J, *(o.data_ptr() for o in rev), None) == err
    return rev


def _rev_edges(reads, a, b, W, seed):
    """Reverse-pass inputs off the forward pass's ends: jend 0..9 and at the
    32-column block edges, and on some pairs iend far below jend, so the
    reversed prefix starts below the window (q < -m0r) for the first words
    and for words that enter the band later."""
    rng = np.random.default_rng(seed)
    la = reads.lengths[a.long() >> 1].numpy()
    lb = reads.lengths[b.long() >> 1].numpy()
    cols = np.minimum(lb, J)
    jend = rng.integers(0, cols + 1)
    edges = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 31, 32, 33, 63, 64, 65, 95, 96, 97])
    jend[: edges.size] = np.minimum(edges, cols[: edges.size])
    iend = rng.integers(0, la + 1)
    far = slice(edges.size, edges.size + 30)
    jend[far] = cols[far]
    iend[far] = np.minimum(iend[far], rng.integers(0, 40, 30))
    return (torch.from_numpy(iend.astype(np.int32)), torch.from_numpy(jend.astype(np.int32)))


@pytest.mark.parametrize("W", [64, 128])
def test_host_built_tab2_kernels_match_plain(lib, W):
    """The tab2 kernels on a batch small enough for the slab body (K lanes
    a pair), which cut their windows out of the blocked table themselves
    (row clamps, residual shifts, the reverse funnels), == fwd_tab2_plain /
    rev_tab2_plain and the resident kernels; the reverse pass also at jend
    0..9, at block edges and below the reversed prefix."""
    reads, (a, b, d) = _tab2_case(W)
    B = a.shape[0]
    assert lib.phasm_myers_tab2_lanes(B, W, J, 0) > 1 and lib.phasm_myers_tab2_lanes(B, W, J, 1) > 1
    t2 = MyersBlockedTables.from_reads(reads)
    fwd = _tab2_fwd(lib, t2, reads.lengths, a, b, d, W)
    _equal(fwd, plain.fwd_tab2_plain(t2.win, reads.lengths, a, b, d, t2.LA, W, J))
    iend = (fwd[1] + 32 * plain.fwd_anchor(d, W)).int()
    resident = _fwd(lib, reads, torch.arange(B), a, b, d, W)
    _equal((fwd[0], iend, fwd[2], fwd[3]), resident)
    rev = _tab2_rev(lib, t2, a, b, d, iend, fwd[2], W)
    _equal(rev, plain.rev_tab2_plain(t2.win, a, b, t2.LA, iend, fwd[2], d, W, J))
    _equal(rev, _rev(lib, reads, torch.arange(B), a, b, d, iend, fwd[2], W))
    ie, je = _rev_edges(reads, a, b, W, seed=W)
    _equal(_tab2_rev(lib, t2, a, b, d, ie, je, W),
           plain.rev_tab2_plain(t2.win, a, b, t2.LA, ie, je, d, W, J))


@pytest.mark.parametrize("W", [64, 128])
def test_host_built_tab2_thread_body_matches_plain(lib, W):
    """Above the slab body's batch size the entries run one pair a thread,
    the reverse pass in the column order the wrapper passes: the 203 edge
    pairs repeated past that size == the plain versions of one copy.  With
    no order there the reverse entry refuses (cudaErrorInvalidValue, 1)."""
    reads, (a, b, d) = _tab2_case(W)
    copies = next(n for n in range(2, 200)
                  if all(lib.phasm_myers_tab2_lanes(a.shape[0] * n, W, J, rev) == 1 for rev in (0, 1)))
    t2 = MyersBlockedTables.from_reads(reads)
    want_f = plain.fwd_tab2_plain(t2.win, reads.lengths, a, b, d, t2.LA, W, J)
    ie, je = _rev_edges(reads, a, b, W, seed=W + 1)
    want_r = plain.rev_tab2_plain(t2.win, a, b, t2.LA, ie, je, d, W, J)
    a, b, d, ie, je = (t.repeat(copies) for t in (a, b, d, ie, je))
    _equal(_tab2_fwd(lib, t2, reads.lengths, a, b, d, W), [w.repeat(copies) for w in want_f])
    rev = _tab2_rev(lib, t2, a, b, d, ie, je, W, order=MC.column_order(je, J))
    _equal(rev, [w.repeat(copies) for w in want_r])
    untouched = _tab2_rev(lib, t2, a, b, d, ie, je, W, order=None, err=1)
    assert all(bool((o == -7).all()) for o in untouched)


def test_column_order_groups_by_blocks_at_either_key_width():
    """column_order's one-byte key (J <= 8192) and two-byte key (J > 8192)
    give the same grouping by 32-column block count, most blocks first, and
    the two-byte key orders counts past 255 too (J = 16384)."""
    rng = np.random.default_rng(3)
    cols = torch.from_numpy(rng.integers(0, 8192, 5000).astype(np.int32))
    blocks = (cols.clamp(max=8191) >> 5).long()
    narrow, wide = MC.column_order(cols, 8192), MC.column_order(cols, 16384)
    for order in (narrow, wide):
        assert torch.equal(order.sort().values, torch.arange(cols.numel()))
    assert torch.equal(blocks[narrow], blocks[wide])
    assert bool((blocks[narrow][1:] <= blocks[narrow][:-1]).all())
    long_cols = torch.from_numpy(rng.integers(0, 20000, 5000).astype(np.int32))
    long_blocks = (long_cols.clamp(max=16383) >> 5).long()
    got = long_blocks[MC.column_order(long_cols, 16384)]
    assert torch.equal(got, long_blocks.sort(descending=True).values) and int(got[0]) == 511


def test_host_built_kernels_match_nothing_on_n(lib):
    """An N (code 4) in b matches no a base in kernels 1 and 2, as in their
    plain versions (the window-fed ones read it as an A, like the
    reference's table tier, so they are left out here)."""
    W = 64
    rng = np.random.default_rng(4)
    a, b, la, lb, d0 = random_overlap_case(rng, B=60, la_max=500)
    b[(b < 4) & (rng.random(b.shape) < 0.02)] = 4
    oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
    reads = DeviceReads.from_arrays(oriented, lengths, "cpu")
    reads._build_tables()
    a, b, d = index_tensors(reads.device, a_oid, b_oid, d0)
    order = MC.column_order(reads.lengths[b.long() >> 1], J)
    fwd = _fwd(lib, reads, order, a, b, d, W)
    _equal(fwd, plain.fwd_plain(reads.codes, reads.lengths, a, b, d, W, J))
    ie, je = fwd[1], fwd[2]
    rev = _rev(lib, reads, MC.column_order(je, J), a, b, d, ie, je, W)
    _equal(rev, plain.rev_plain(reads.codes, reads.lengths, a, b, d, ie, je, W, J))
