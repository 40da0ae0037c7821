"""Kernels 1 and 2 (``csrc/myers.cu``): Myers forward and Myers reverse,
and the Myers table tier: kernel 5 (``csrc/myers_fetch.cu``, the per-pair
forward window fetch) feeding the window-fed variants of kernels 1 and 2.

Each wrapper runs the plain torch version (``overlap/myers.py``) when its
tensors lie on the CPU and launches its CUDA kernel when they lie on the
card; on the card it launches or raises, never falls back.  Each keeps a
plain launch count, bumped only where its kernel is launched, and records
its pairs and launches per shape (``_build.count_shape``).  The resident
kernels 1 and 2 run their pairs in column order (``column_order``): sorted
by the columns each will run, longest first, so the 32 pairs of a warp run
loops of about the same length and the longest warps start first; each
pair's outputs land at its own index.  The window-fed kernels keep the
pair order, since their pair-last windows are laid out by it.  The main
path (``DeviceExtender``) runs the resident kernels 1 and 2 only; the table
tier is the entry point ``myers_compute_tab``, the tab2 tier (kernels 1 and
2 in their tab2 bodies, which cut their windows out of the blocked table
themselves) the entry point ``myers_compute_tab2``, and the five counts of
those two tiers stay out of ``configs.launch_counts()``.  The tab2 C
entries pick their body by batch size (``tab2_body``): the slab body
(several lanes a pair) in pair order, or one pair a thread, whose reverse
pass the wrapper hands the column order by jend.
"""
from __future__ import annotations

import numpy as np
import torch

from phasm_tpu_torch import _build
from phasm_tpu_torch.overlap import myers as plain
from phasm_tpu_torch.overlap.extend import ExtendResult, column_order
from phasm_tpu_torch.overlap.myers import F_TAB, WB, K_of, blocked_counts, rev_K
from phasm_tpu_torch.overlap.routing import tab2_fits
from phasm_tpu_torch.state import DeviceReads, MyersBlockedTables, MyersTables

myers_fwd_launches = 0
myers_rev_launches = 0
myers_fwd_fetch_launches = 0
myers_fwd_win_launches = 0
myers_rev_win_launches = 0
myers_fwd_tab2_launches = 0
myers_rev_tab2_launches = 0


def _require_table(table):
    if table is None:
        raise ValueError("read set has no match-mask tables (built for CUDA reads only)")
    return table


def _check_shape(W: int, J: int) -> None:
    if not 4 <= K_of(W) <= 7:
        raise ValueError(f"Myers kernels take bands with K_of(W) in 4..7, not W={W}")
    if J % 128:
        raise ValueError(f"jmax must be 128-aligned, got {J}")


def myers_fwd(reads: DeviceReads, a_oid, b_oid, d0, W: int, J: int):
    """Kernel 1: (cost_f, iend, jend, win) int32 [B]."""
    global myers_fwd_launches
    if reads.device.type == "cpu":
        return plain.fwd_plain(reads.codes, reads.lengths, a_oid, b_oid, d0, W, J)
    _build.check_launch_inputs(reads, _require_table(reads.peq_fwd), a_oid, b_oid, d0)
    _check_shape(W, J)
    B = a_oid.shape[0]
    outs = torch.empty((4, B), dtype=torch.int32, device=reads.device).unbind()
    if B == 0:
        return outs
    order = column_order(reads.lengths[b_oid >> 1], J)
    err = _build.load().phasm_myers_fwd(
        order.data_ptr(), a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(),
        reads.lengths.data_ptr(), reads.codes.data_ptr(), reads.codes.shape[1],
        reads.peq_fwd.data_ptr(), reads.peq_fwd.shape[1], B, W, J,
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(reads.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_fwd")
    myers_fwd_launches += 1
    _build.count_shape("myers_fwd", B, W, J)
    return outs


def myers_rev(reads: DeviceReads, a_oid, b_oid, d0, iend, jend, W: int, J: int):
    """Kernel 2: reverse start recovery (cost_rev, best_row) int32 [B];
    the alignment starts at i0 = iend - best_row."""
    global myers_rev_launches
    if reads.device.type == "cpu":
        return plain.rev_plain(
            reads.codes, reads.lengths, a_oid, b_oid, d0, iend, jend, W, J
        )
    _build.check_launch_inputs(reads, _require_table(reads.peq_rev), a_oid, b_oid, d0, iend, jend)
    _check_shape(W, J)
    B = a_oid.shape[0]
    outs = torch.empty((2, B), dtype=torch.int32, device=reads.device).unbind()
    if B == 0:
        return outs
    order = column_order(jend, J)
    err = _build.load().phasm_myers_rev(
        order.data_ptr(), a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(),
        iend.data_ptr(), jend.data_ptr(),
        reads.lengths.data_ptr(), reads.codes.data_ptr(), reads.codes.shape[1],
        reads.peq_rev.data_ptr(), reads.peq_rev.shape[1], B, W, J,
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(reads.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_rev")
    myers_rev_launches += 1
    _build.count_shape("myers_rev", B, W, J)
    return outs


def myers_pair(reads: DeviceReads, a_oid, b_oid, d0, W: int, J: int):
    """Forward + start recovery: (cost, i0, iend, jend, win) int32 [B] on
    the reads' device, the contract of ``myers._myers_pair_core``."""
    cost_f, iend, jend, win = myers_fwd(reads, a_oid, b_oid, d0, W, J)
    cost_r, best_row = myers_rev(reads, a_oid, b_oid, d0, iend, jend, W, J)
    return plain.combine(cost_f, iend, jend, win, cost_r, best_row)


def myers_overlap_batch(
    oriented: np.ndarray,
    lengths: np.ndarray,
    a_oid: np.ndarray,
    b_oid: np.ndarray,
    d0: np.ndarray,
    band: int = 64,
    jmax: int = 4096,
    device="cuda",
) -> ExtendResult:
    """Twin of ``myers.myers_overlap_batch`` on the port's Myers path."""
    reads = DeviceReads.from_arrays(oriented, lengths, device)
    a, b, d = _build.index_tensors(reads.device, a_oid, b_oid, d0)
    return _result(myers_pair(reads, a, b, d, band, jmax))


def _result(out) -> ExtendResult:
    cost, i0, iend, jend, win = (x.cpu().numpy() for x in out)
    return ExtendResult(
        a_start=i0, a_end=iend, b_start=np.zeros_like(i0), b_end=jend,
        diffs=cost, win_cost=win,
    )


# -- the table tier --


def _check_windows(dev, *named) -> None:
    """Raise unless each (name, tensor, shape) is a contiguous int32 tensor
    of that shape on dev."""
    for name, t, shape in named:
        if (
            t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape
            or not t.is_contiguous()
        ):
            raise ValueError(f"{name}: expected contiguous int32 {list(shape)} on {dev}")


def myers_fwd_fetch_plain(tables: MyersTables, a_oid, b_oid, sfw, W: int, J: int):
    """Kernel 5's plain version: one indexing gather per table."""
    return plain.fwd_fetch(tables.peq, tables.bpk, a_oid, b_oid, sfw, W, J)


def myers_fwd_fetch(tables: MyersTables, a_oid, b_oid, sfw, W: int, J: int):
    """Kernel 5: each pair's forward window out of the tables, (peq_f
    [NBLK, 4, B], bpk_f [J/16, B]) int32, NBLK = J/32 + K_of(W); sfw =
    fwd_anchor(d0, W) + F_TAB.  Words past a table row come out 0."""
    global myers_fwd_fetch_launches
    if tables.device.type == "cpu":
        return myers_fwd_fetch_plain(tables, a_oid, b_oid, sfw, W, J)
    _check_shape(W, J)
    dev = tables.device
    n_o, _, PW = tables.peq.shape
    BW = tables.bpk.shape[2]
    _check_windows(dev, ("peq table", tables.peq, (n_o, 8, PW)),
                   ("bpk table", tables.bpk, (n_o, 2, BW)))
    _build.check_pair_vectors(dev, a_oid, b_oid, sfw)
    B, NBLK, JW = a_oid.shape[0], J // WB + K_of(W), J // 16
    peq_f = torch.empty((NBLK, 4, B), dtype=torch.int32, device=dev)
    bpk_f = torch.empty((JW, B), dtype=torch.int32, device=dev)
    if B == 0:
        return peq_f, bpk_f
    err = _build.load().phasm_myers_fwd_fetch(
        a_oid.data_ptr(), b_oid.data_ptr(), sfw.data_ptr(),
        tables.peq.data_ptr(), PW, tables.bpk.data_ptr(), BW, B, NBLK, JW,
        peq_f.data_ptr(), bpk_f.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "phasm_myers_fwd_fetch")
    myers_fwd_fetch_launches += 1
    _build.count_shape("myers_fwd_fetch", B, W, J)
    return peq_f, bpk_f


def myers_fwd_win(la, lb, d0, peq_f, bpk_f, W: int, J: int):
    """Window-fed kernel 1: (cost_f, iend_rel, jend, win) int32 [B], the
    TPU kernel's contract (iend relative to the anchor row 32*m0)."""
    global myers_fwd_win_launches
    if la.device.type == "cpu":
        return plain.fwd_win_plain(la, lb, d0, peq_f, bpk_f, W, J)
    _check_shape(W, J)
    _build.check_pair_vectors(la.device, la, lb, d0)
    B = la.shape[0]
    _check_windows(la.device, ("peq_f", peq_f, (J // WB + K_of(W), 4, B)),
                   ("bpk_f", bpk_f, (J // 16, B)))
    outs = [torch.empty(B, dtype=torch.int32, device=la.device) for _ in range(4)]
    if B == 0:
        return tuple(outs)
    err = _build.load().phasm_myers_fwd_win(
        la.data_ptr(), lb.data_ptr(), d0.data_ptr(), peq_f.data_ptr(), bpk_f.data_ptr(),
        B, W, J, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(la.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_fwd_win")
    myers_fwd_win_launches += 1
    _build.count_shape("myers_fwd_win", B, W, J)
    return tuple(outs)


def myers_rev_win(row_off, iend, jend, peq_r, bpk_r, W: int, J: int):
    """Window-fed kernel 2: (cost_rev, best_row) int32 [B] over the
    reverse windows of ``rev_prep_tab``."""
    global myers_rev_win_launches
    if row_off.device.type == "cpu":
        return plain.rev_win_plain(row_off, iend, jend, peq_r, bpk_r, W, J)
    _check_shape(W, J)
    _build.check_pair_vectors(row_off.device, row_off, iend, jend)
    B = row_off.shape[0]
    _check_windows(row_off.device, ("peq_r", peq_r, (J // WB + rev_K(W), 4, B)),
                   ("bpk_r", bpk_r, (J // 16, B)))
    outs = [torch.empty(B, dtype=torch.int32, device=row_off.device) for _ in range(2)]
    if B == 0:
        return tuple(outs)
    err = _build.load().phasm_myers_rev_win(
        row_off.data_ptr(), iend.data_ptr(), jend.data_ptr(), peq_r.data_ptr(),
        bpk_r.data_ptr(), B, W, J, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(row_off.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_rev_win")
    myers_rev_win_launches += 1
    _build.count_shape("myers_rev_win", B, W, J)
    return tuple(outs)


def myers_compute_tab(tables: MyersTables, lengths, a_oid, b_oid, d0, W: int, J: int):
    """The Myers table tier (twin of the reference's
    ``myers_pallas_compute_tab``): kernel 5 cuts the forward windows out
    of the tables, window-fed kernel 1 runs on them, ``rev_prep_tab`` cuts
    the reverse windows, window-fed kernel 2 runs on them.  Returns (cost,
    i0, iend, jend, win) int32 [B], ``myers_pair``'s contract.  Raises
    outside the kernels' contract (K_of(W) in 4..7, J % 128 == 0); pads
    nothing."""
    _check_shape(W, J)
    la = lengths[a_oid.long() >> 1]
    lb = lengths[b_oid.long() >> 1]
    m0 = plain.fwd_anchor(d0, W)
    peq_f, bpk_f = myers_fwd_fetch(tables, a_oid, b_oid, (m0 + F_TAB).int(), W, J)
    cost_f, iend_rel, jend, win = myers_fwd_win(la, lb, d0, peq_f, bpk_f, W, J)
    iend = (iend_rel + WB * m0).int()
    peq_r, bpk_r, row_off = plain.rev_prep_tab(
        tables.peq, tables.bpk, a_oid, b_oid, tables.LA, iend, jend, d0, W, J
    )
    cost_r, best_row = myers_rev_win(row_off.int(), iend, jend, peq_r, bpk_r, W, J)
    return plain.combine(cost_f, iend, jend, win, cost_r, best_row)


def myers_overlap_batch_tab(
    oriented: np.ndarray,
    lengths: np.ndarray,
    a_oid: np.ndarray,
    b_oid: np.ndarray,
    d0: np.ndarray,
    band: int = 64,
    jmax: int = 4096,
    device="cuda",
) -> ExtendResult:
    """``myers_overlap_batch`` through the table tier, from host arrays."""
    reads = DeviceReads.from_arrays(oriented, lengths, device)
    a, b, d = _build.index_tensors(reads.device, a_oid, b_oid, d0)
    tables = MyersTables.from_reads(reads)
    return _result(myers_compute_tab(tables, reads.lengths, a, b, d, band, jmax))


# -- the tab2 tier --


def _check_tab2(tables: MyersBlockedTables, W: int, J: int, lengths=None) -> None:
    """Raise unless (W, J) is what the tab2 kernels take (K_of(W) in 4..7,
    tab2_fits(W, J): J <= 2048, which the table's padding rows cover) and
    the table (and lengths) are contiguous int32 tensors of the right shape
    on one device."""
    _check_shape(W, J)
    if not tab2_fits(W, J):
        raise ValueError(f"the tab2 kernels take tab2_fits(W, J) only, not W={W} J={J}")
    NBb, NBc = blocked_counts(tables.LA)
    _check_windows(tables.device, ("blocked table", tables.win,
                                   (tables.n_o * (2 * NBb + 1 + NBc), 128)))
    if lengths is not None:
        _check_windows(tables.device, ("lengths", lengths, (lengths.shape[0],)))


def myers_fwd_tab2(tables: MyersBlockedTables, lengths, a_oid, b_oid, d0, W: int, J: int):
    """Tab2 kernel 1: the forward pass on windows it cuts out of the blocked
    table itself; (cost_f, iend_rel, jend, win) int32 [B], iend relative to
    the anchor row 32*m0 (the TPU kernel's contract)."""
    global myers_fwd_tab2_launches
    _check_tab2(tables, W, J, lengths)
    _build.check_pair_vectors(tables.device, a_oid, b_oid, d0)
    if tables.device.type == "cpu":
        return plain.fwd_tab2_plain(tables.win, lengths, a_oid, b_oid, d0, tables.LA, W, J)
    B = a_oid.shape[0]
    outs = torch.empty((4, B), dtype=torch.int32, device=tables.device).unbind()
    if B == 0:
        return outs
    err = _build.load().phasm_myers_fwd_tab2(
        a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(), lengths.data_ptr(),
        tables.win.data_ptr(), tables.n_o, blocked_counts(tables.LA)[0], B, W, J,
        *(o.data_ptr() for o in outs), torch.cuda.current_stream(tables.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_fwd_tab2")
    myers_fwd_tab2_launches += 1
    _build.count_shape("myers_fwd_tab2", B, W, J)
    return outs


def myers_rev_tab2(tables: MyersBlockedTables, a_oid, b_oid, d0, iend, jend, W: int, J: int):
    """Tab2 kernel 2: reverse start recovery on windows it cuts, funnels and
    masks out of the blocked table itself; (cost_rev, best_row) int32 [B]."""
    global myers_rev_tab2_launches
    _check_tab2(tables, W, J)
    _build.check_pair_vectors(tables.device, a_oid, b_oid, d0, iend, jend)
    if tables.device.type == "cpu":
        return plain.rev_tab2_plain(tables.win, a_oid, b_oid, tables.LA, iend, jend, d0, W, J)
    B = a_oid.shape[0]
    outs = torch.empty((2, B), dtype=torch.int32, device=tables.device).unbind()
    if B == 0:
        return outs
    NBb, NBc = blocked_counts(tables.LA)
    # one pair a thread runs in column order; the slab body in pair order
    order = column_order(jend, J) if tab2_body(B, W, J, True) == "thread" else None
    err = _build.load().phasm_myers_rev_tab2(
        None if order is None else order.data_ptr(),
        a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(), iend.data_ptr(), jend.data_ptr(),
        tables.win.data_ptr(), tables.LA, tables.n_o, NBb, NBc, B, W, J,
        *(o.data_ptr() for o in outs), torch.cuda.current_stream(tables.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_rev_tab2")
    myers_rev_tab2_launches += 1
    _build.count_shape("myers_rev_tab2", B, W, J)
    return outs


def tab2_body(B: int, W: int, J: int, rev: bool) -> str:
    """The body tab2 kernel 1 (rev False) or 2 runs on a batch of B pairs,
    as the C entry's fixed rule picks it: ``"thread"`` (one pair a thread)
    or ``"slab L"`` (L lanes a pair, ceil(K / L) band words a lane)."""
    lanes = _build.load().phasm_myers_tab2_lanes(B, W, J, int(rev))
    return "thread" if lanes == 1 else f"slab {lanes}"


def myers_compute_tab2(tables: MyersBlockedTables, lengths, a_oid, b_oid, d0, W: int, J: int):
    """The Myers tab2 tier (twin of the reference's
    ``myers_pallas_compute_tab2``): tab2 kernel 1, then tab2 kernel 2 at the
    forward ends.  Returns (cost, i0, iend, jend, win) int32 [B],
    ``myers_pair``'s contract.  Raises outside the kernels' contract
    (K_of(W) in 4..7, tab2_fits(W, J)); pads nothing and hands no batch on
    to another tier."""
    cost_f, iend_rel, jend, win = myers_fwd_tab2(tables, lengths, a_oid, b_oid, d0, W, J)
    iend = (iend_rel + WB * plain.fwd_anchor(d0, W)).int()
    cost_r, best_row = myers_rev_tab2(tables, a_oid, b_oid, d0, iend, jend, W, J)
    return plain.combine(cost_f, iend, jend, win, cost_r, best_row)


def myers_overlap_batch_tab2(
    oriented: np.ndarray,
    lengths: np.ndarray,
    a_oid: np.ndarray,
    b_oid: np.ndarray,
    d0: np.ndarray,
    band: int = 64,
    jmax: int = 1024,
    device="cuda",
) -> ExtendResult:
    """``myers_overlap_batch`` through the tab2 tier, from host arrays."""
    reads = DeviceReads.from_arrays(oriented, lengths, device)
    a, b, d = _build.index_tensors(reads.device, a_oid, b_oid, d0)
    tables = MyersBlockedTables.from_reads(reads)
    return _result(myers_compute_tab2(tables, reads.lengths, a, b, d, band, jmax))
