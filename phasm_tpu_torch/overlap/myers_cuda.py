"""Kernels 1 and 2 (``csrc/myers.cu``): Myers forward and Myers reverse.

Each wrapper runs the plain torch version (``overlap/myers.py``) when the
read set lies on the CPU and launches its CUDA kernel when it lies on the
card; on the card it launches or raises, never falls back.  Each keeps a
plain launch count, bumped only where its kernel is launched.
"""
from __future__ import annotations

import numpy as np
import torch

from phasm_tpu.overlap.extend import ExtendResult
from phasm_tpu.overlap.myers import K_of

from phasm_tpu_torch import _build
from phasm_tpu_torch.overlap import myers as plain
from phasm_tpu_torch.state import DeviceReads

myers_fwd_launches = 0
myers_rev_launches = 0


def check_launch_inputs(reads: DeviceReads, table, *idx: torch.Tensor) -> None:
    """Raise unless the read set, the kernel's table (when it reads one) and
    the per-pair vectors are what the CUDA kernels take: contiguous,
    uint8 codes / int32 lengths / int32 tables, equal-length int32 vectors,
    all on the reads' device."""
    dev = reads.device
    arrays = [("codes", reads.codes, torch.uint8, 2), ("lengths", reads.lengths, torch.int32, 1)]
    if table is not None:
        arrays.append(("table", table, torch.int32, 3))
    for name, t, dt, nd in arrays:
        if t.device != dev or t.dtype != dt or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {nd}-d on {dev}")
    n = idx[0].shape[0]
    for t in idx:
        if (
            t.device != dev or t.dtype != torch.int32 or t.dim() != 1
            or t.shape[0] != n or not t.is_contiguous()
        ):
            raise ValueError(f"per-pair vectors: expected contiguous int32 [{n}] on {dev}")


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
    check_launch_inputs(reads, _require_table(reads.peq_fwd), a_oid, b_oid, d0)
    _check_shape(W, J)
    B = a_oid.shape[0]
    outs = [torch.empty(B, dtype=torch.int32, device=reads.device) for _ in range(4)]
    if B == 0:
        return tuple(outs)
    err = _build.load().phasm_myers_fwd(
        a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(),
        reads.lengths.data_ptr(), reads.codes.data_ptr(), reads.codes.shape[1],
        reads.peq_fwd.data_ptr(), reads.peq_fwd.shape[1], B, W, J,
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(reads.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_fwd")
    myers_fwd_launches += 1
    return tuple(outs)


def myers_rev(reads: DeviceReads, a_oid, b_oid, d0, iend, jend, W: int, J: int):
    """Kernel 2: reverse start recovery (cost_rev, best_row) int32 [B];
    the alignment starts at i0 = iend - best_row."""
    global myers_rev_launches
    if reads.device.type == "cpu":
        return plain.rev_plain(
            reads.codes, reads.lengths, a_oid, b_oid, d0, iend, jend, W, J
        )
    check_launch_inputs(reads, _require_table(reads.peq_rev), a_oid, b_oid, d0, iend, jend)
    _check_shape(W, J)
    B = a_oid.shape[0]
    outs = [torch.empty(B, dtype=torch.int32, device=reads.device) for _ in range(2)]
    if B == 0:
        return tuple(outs)
    err = _build.load().phasm_myers_rev(
        a_oid.data_ptr(), b_oid.data_ptr(), d0.data_ptr(),
        iend.data_ptr(), jend.data_ptr(),
        reads.lengths.data_ptr(), reads.codes.data_ptr(), reads.codes.shape[1],
        reads.peq_rev.data_ptr(), reads.peq_rev.shape[1], B, W, J,
        *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(reads.device).cuda_stream,
    )
    _build.check(err, "phasm_myers_rev")
    myers_rev_launches += 1
    return tuple(outs)


def myers_pair(reads: DeviceReads, a_oid, b_oid, d0, W: int, J: int):
    """Forward + start recovery: (cost, i0, iend, jend, win) int32 [B] on
    the reads' device, the contract of ``myers._myers_pair_core``."""
    cost_f, iend, jend, win = myers_fwd(reads, a_oid, b_oid, d0, W, J)
    cost_r, best_row = myers_rev(reads, a_oid, b_oid, d0, iend, jend, W, J)
    return plain.combine(cost_f, iend, jend, win, cost_r, best_row)


def index_tensors(device, *arrays: np.ndarray):
    """Host index vectors -> contiguous int32 device vectors (one upload)."""
    stacked = torch.from_numpy(
        np.stack([np.asarray(a, dtype=np.int32) for a in arrays])
    ).to(device)
    return tuple(stacked[i] for i in range(len(arrays)))


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
    a, b, d = index_tensors(reads.device, a_oid, b_oid, d0)
    cost, i0, iend, jend, win = (
        x.cpu().numpy() for x in myers_pair(reads, a, b, d, band, jmax)
    )
    return ExtendResult(
        a_start=i0, a_end=iend, b_start=np.zeros_like(i0), b_end=jend,
        diffs=cost, win_cost=win,
    )
