"""Fuzz-transitive reduction as one tensor pass on the device.

Twin of ``phasm_tpu.graph.transitive``: edge (v, x) is transitive iff some
w != v, x has (v, w) and (w, x) in E with elen(v,w) + elen(w,x) <=
elen(v,x) + fuzz, evaluated against the original edge set, with the
marginal-edge veto (a witness path through a dirty edge cannot eliminate a
clean edge).  Replaces ``reduce_mask_jax``: torch has int64 on every device,
so the (w, x) lookup is ``searchsorted`` over composed int64 keys instead of
the reference's 32-step CSR bisection (which exists only because JAX runs
without x64).
"""
from __future__ import annotations

import numpy as np
import torch

from phasm_tpu.graph.structure import StringGraph
from phasm_tpu.graph.transitive import _padded_adjacency, reduce_mask_np

from phasm_tpu_torch.device import resolve_device

AUTO_MIN_EDGES = 4096  # the reference's auto threshold for the device pass


def reduce_mask_torch(
    g: StringGraph, fuzz: int, dirty: np.ndarray | None = None, device="cuda"
) -> np.ndarray:
    """Boolean [E] mask, True = transitive; equal to ``reduce_mask_np``."""
    if g.n_edges == 0:
        return np.zeros(0, dtype=bool)
    dev = resolve_device(device)
    if dirty is None:
        dirty = np.zeros(g.n_edges, dtype=bool)
    nbr, nel, valid, ndirty = _padded_adjacency(g, pad_to=8, dirty=dirty)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    nbr, nel, valid, ndirty = up(nbr), up(nel), up(valid), up(ndirty)
    v = up(g.src.astype(np.int64))
    x = up(g.dst.astype(np.int64))
    elen = up(g.elen.astype(np.int64))
    edirty = up(dirty.astype(bool))
    n = g.n_nodes

    w = nbr[v]  # [E, D] candidate mids
    ok = valid[v] & (w != x[:, None]) & (w != v[:, None])
    keys = v * n + x  # canonical edges are (src, dst)-sorted
    q = torch.where(ok, w, 0) * n + x[:, None]
    pos = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
    ex = keys[pos] == q
    wx_len = torch.where(ex, elen[pos], 0)
    witness_dirty = ndirty[v] | (ex & edirty[pos])
    cond = (
        ok & ex
        & (nel[v] + wx_len <= elen[:, None] + fuzz)
        & ~(witness_dirty & ~edirty[:, None])
    )
    return cond.any(dim=1).cpu().numpy()


def remove_transitive_edges(
    g: StringGraph, fuzz: int = 1000, impl: str = "np",
    dirty: np.ndarray | None = None, device="cuda",
) -> StringGraph:
    """Drop transitive edges.  impl: ``np`` (host oracle), ``torch`` (the
    device pass; the reference's ``jax`` names it too) or ``auto`` (device
    pass for graphs of >= 4096 edges, as in the reference)."""
    if impl == "auto":
        impl = "torch" if g.n_edges >= AUTO_MIN_EDGES else "np"
    if impl == "np":
        mask = reduce_mask_np(g, fuzz, dirty)
    elif impl in ("torch", "jax"):
        mask = reduce_mask_torch(g, fuzz, dirty, device)
    else:
        raise ValueError(f"unknown transitive impl {impl!r}")
    return g.take_edges(~mask)
