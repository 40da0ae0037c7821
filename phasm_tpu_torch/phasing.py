"""Bubble-chain phasing: the branch scorer on the device, batched over a
leading chain axis, and the reference's lockstep loop around it.

``score_step`` replaces both ``phasing._get_jit_score`` and its vmapped
form ``_get_jit_score_v`` and computes in float32 as the reference does.
Everything else (evidence, the resumable per-chain DP ``_ChainDP``, prune,
read assignment, phase breaks) is the reference's host code.
"""
from __future__ import annotations

import numpy as np
import torch

from phasm_tpu import metrics
from phasm_tpu.alignments import AlignmentTable
from phasm_tpu.bubbles import BubbleChain
from phasm_tpu.graph.unitigs import UnitigGraph
from phasm_tpu.phasing import (
    ChainPhaseResult,
    PhaseConfig,
    _ChainDP,
    canonical_pair,
    read_touch_dirty,
    read_touch_errs,
)
from phasm_tpu.reads import ReadSet

from phasm_tpu_torch.device import resolve_device


def score_step(B, M, A, scores, active, cand_mask, ext_mask, err, beta, n_path):
    """All-pairs branch scores for G chains at once.

    B [G, C, R, k] bool prior consistency bits; M [G, R, P] bool read-path
    consistency at this bubble; A [G, E, k] int path assignment per
    extension; scores [G, C] f32; active [G, R] bool; cand_mask [G, C],
    ext_mask [G, E] bool; err, beta 0-d f32; n_path [G, P] f32 per-path
    read support.  Returns total [G, C, E] f32 (-inf where masked)."""
    G, C, R, k = B.shape
    E, P = A.shape[1], M.shape[2]
    kf = torch.tensor(float(k), dtype=torch.float32, device=B.device)
    one = torch.ones((), dtype=torch.float32, device=B.device)
    # Mp[g, e, r, m] = M[g, r, A[g, e, m]]
    Mp = torch.gather(
        M[:, None].expand(G, E, R, P), 3, A.long()[:, :, None, :].expand(G, E, R, k)
    )
    Bn = B[:, :, None] & Mp[:, None]  # [G, C, E, R, k]
    c_new = Bn.sum(dim=4).to(torch.float32)
    c_old = B.sum(dim=3).to(torch.float32)
    p_new = (c_new * (one - err) + (kf - c_new) * err) / kf
    p_old = (c_old * (one - err) + (kf - c_old) * err) / kf
    contrib = torch.log(p_new) - torch.log(p_old)[:, :, None, :]
    delta = torch.where(active[:, None, None, :], contrib, 0.0).sum(dim=3)

    # coverage term: per-extension multiplicity of each path
    onehot = A.long()[:, :, :, None] == torch.arange(P, device=A.device)
    mult = onehot.sum(dim=2).to(torch.float32)  # [G, E, P]
    lam = (n_path.sum(dim=1) / kf)[:, None, None]
    eps = torch.tensor(1e-6, dtype=torch.float32, device=B.device)
    cov = (n_path[:, None, :] * torch.log(lam * mult + eps) - lam * mult).sum(dim=2)

    total = scores[:, :, None] + delta + beta * cov[:, None, :]
    mask = cand_mask[:, :, None] & ext_mask[:, None, :]
    return torch.where(mask, total, -torch.inf)


def _score(groups_args, cfg: PhaseConfig, dev) -> np.ndarray:
    """Stack G same-shape prepped argument tuples and score them in one
    device call; returns float32 totals [G, Cp, Ep]."""
    stacked = [
        torch.from_numpy(np.stack([a[j] for a in groups_args])).to(dev)
        for j in range(8)
    ]
    err = torch.tensor(cfg.err, dtype=torch.float32, device=dev)
    beta = torch.tensor(cfg.coverage_weight, dtype=torch.float32, device=dev)
    return score_step(*stacked[:7], err, beta, stacked[7]).cpu().numpy()


def phase_chain(
    ug: UnitigGraph,
    reads: ReadSet,
    aln: AlignmentTable,
    chain: BubbleChain,
    cfg: PhaseConfig | None = None,
    touch=None,
    dirty=None,
    device="cuda",
) -> ChainPhaseResult:
    """Branch-score-prune over one bubble chain, one bubble at a time."""
    cfg = cfg or PhaseConfig()
    dev = resolve_device(device)
    if touch is None:
        touch = read_touch_errs(ug, reads.n_reads, aln)
    if dirty is None and cfg.link_discrimination:
        dirty = read_touch_dirty(
            ug, reads.n_reads, aln, z=cfg.link_z, min_excess=cfg.link_min_excess
        )
    dp = _ChainDP(ug, reads, aln, chain, cfg, touch, dirty=dirty)
    for i in range(dp.n_b):
        metrics.incr("phasing.score_dispatches")
        args, meta = dp.prep(i)
        dp.apply(meta, _score([args], cfg, dev)[0, : meta[1], : meta[2]])
    return dp.finish()


def phase_all(
    ug: UnitigGraph,
    reads: ReadSet,
    aln: AlignmentTable,
    chains: list[BubbleChain],
    cfg: PhaseConfig | None = None,
    batch: bool = True,
    device="cuda",
) -> list[ChainPhaseResult]:
    """Phase every chain (twin of ``phasing.phase_all``).  With ``batch``,
    all chains advance in lockstep and chains whose padded step shapes
    coincide are scored in one device call; ``batch=False`` runs
    ``phase_chain`` per chain.  Both give the same results."""
    cfg = cfg or PhaseConfig()
    if not chains:
        return []
    dev = resolve_device(device)
    touch = read_touch_errs(ug, reads.n_reads, aln)
    dirty = (
        read_touch_dirty(
            ug, reads.n_reads, aln, z=cfg.link_z, min_excess=cfg.link_min_excess
        )
        if cfg.link_discrimination
        else None
    )
    # restrict each chain to the reads touching its interiors
    pair2chains: dict[int, set[int]] = {}
    for ci, c in enumerate(chains):
        for b in c.bubbles:
            for u in b.interior:
                pair2chains.setdefault(canonical_pair(ug, u), set()).add(ci)
    touch_sub: list[dict] = [{} for _ in chains]
    for r, ts in touch.items():
        cis: set[int] = set()
        for u in ts:
            cis |= pair2chains.get(u, set())
        for ci in cis:
            touch_sub[ci][r] = ts

    if not batch or len(chains) <= 1:
        return [
            phase_chain(ug, reads, aln, c, cfg, touch=touch_sub[ci],
                        dirty=dirty, device=dev)
            for ci, c in enumerate(chains)
        ]

    dps = [
        _ChainDP(ug, reads, aln, c, cfg, touch_sub[ci], dirty=dirty)
        for ci, c in enumerate(chains)
    ]
    for t in range(max(dp.n_b for dp in dps)):
        buckets: dict[tuple, list] = {}
        for dp in dps:
            if t < dp.n_b:
                args, meta = dp.prep(t)
                key = tuple(a.shape for a in args)
                buckets.setdefault(key, []).append((dp, args, meta))
        for group in buckets.values():
            metrics.incr("phasing.score_dispatches")
            totals = _score([g[1] for g in group], cfg, dev)
            for gi, (dp, _args, meta) in enumerate(group):
                dp.apply(meta, totals[gi, : meta[1], : meta[2]])
    return [dp.finish() for dp in dps]
