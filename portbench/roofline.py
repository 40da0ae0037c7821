"""The bound arithmetic of the benchmark's roofline shares.

A batch's bound is max(int ops / INT32 rate, bytes / HBM rate), both
counted from the pairs' own lengths (what these inputs need, not the most
the bucket could hold).  The counts are those of ``chip_smoke.py`` and
PERF.md's kernel table:

  Myers forward   17 ops a band word and column, K_of(W) words over
                  min(J, lb) columns; bytes: the b codes, one 16-byte
                  match-mask word a window word each 32 columns, 28 bytes
                  of indices and results a pair;
  Myers reverse   17 ops over rev_K(W) = K_of(W) + 3 words and min(J, jend)
                  columns; two 16-byte words a window word each 32 columns;
  W-band          5 ops a cell, W cells over the live columns
                  min(J, lb, la - d0 + W/2); bytes: one a and one b code a
                  live column, the band's first W a codes, 32 bytes a pair.

Peaks are NVIDIA's published figures for the H100 SXM at its 700 W limit:
132 SMs x 64 INT32 lanes x 1,980 MHz = 1.673e13 int ops/s, and 3.35e12 B/s
of HBM3.  A card set below 700 W reaches less; the harness reports the
card's limit beside the shares.
"""
from __future__ import annotations

import numpy as np

MYERS_OPS_PER_WORD = 17
WBAND_OPS_PER_CELL = 5
WB = 32

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int32_ops_per_s": 132 * 64 * 1980e6, "hbm_bytes_per_s": 3.35e12},
}


def K_of(W: int) -> int:
    return -(-(W + 63) // WB) + 1


def myers_fwd(lb: np.ndarray, W: int, J: int) -> tuple[float, float]:
    cols = np.minimum(lb.astype(np.int64), J)
    K = K_of(W)
    blocks = (cols + 31) // 32
    nbytes = cols.sum() + 16 * np.maximum(blocks + K - 1, 0).sum() + 28 * cols.shape[0]
    return float(MYERS_OPS_PER_WORD * K * cols.sum()), float(nbytes)


def myers_rev(jend: np.ndarray, W: int, J: int) -> tuple[float, float]:
    cols = np.minimum(jend.astype(np.int64), J)
    K = K_of(W) + 3
    blocks = (cols + 31) // 32
    nbytes = cols.sum() + 32 * (blocks * K).sum() + 28 * cols.shape[0]
    return float(MYERS_OPS_PER_WORD * K * cols.sum()), float(nbytes)


def wband(la: np.ndarray, lb: np.ndarray, d0: np.ndarray, W: int, J: int) -> tuple[float, float]:
    live = la.astype(np.int64) - d0.astype(np.int64) + W // 2
    cols = np.maximum(np.minimum(np.minimum(lb.astype(np.int64), J), live), 0)
    nbytes = 2 * cols.sum() + (W + 32) * cols.shape[0]
    return float(WBAND_OPS_PER_CELL * W * cols.sum()), float(nbytes)


def batch_work(family: str, la, lb, d0, jend, W: int, J: int) -> tuple[float, float]:
    """(int ops, bytes) one batch of ``family`` needs; jend is the
    forward pass's column of each pair (the reverse pass's length)."""
    if family == "myers":
        f, r = myers_fwd(lb, W, J), myers_rev(jend, W, J)
        return f[0] + r[0], f[1] + r[1]
    return wband(la, lb, d0, W, J)


def bound_s(ops: float, nbytes: float, peaks: dict) -> float:
    return max(ops / peaks["int32_ops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
