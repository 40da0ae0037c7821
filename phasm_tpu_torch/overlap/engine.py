"""Overlap engine: ReadSet -> AlignmentTable on the port's device path.

Twin of ``phasm_tpu.overlap.engine.overlap_reads`` / ``overlap_reads_blocked``.
The host side is the reference's own: minimizer seeding and matching
(``seeding``), ``_normalize_candidates``, ``_auto_blocks``,
``_dispatch_bucketed``, ``_materialize_pending`` and ``_escalate_and_build``
run unchanged against the port's ``DeviceExtender``.  ``sort_seeds`` is
called without ``k`` exactly as the reference calls it, so the candidate
set stays identical (the reference's default k applies to the key check).
"""
from __future__ import annotations

import numpy as np

from phasm_tpu import metrics
from phasm_tpu.alignments import AlignmentTable
from phasm_tpu.overlap import seeding
from phasm_tpu.overlap.engine import (
    OverlapConfig,
    _auto_blocks,
    _dispatch_bucketed,
    _escalate_and_build,
    _materialize_pending,
    _normalize_candidates,
)
from phasm_tpu.overlap.extend import BIG
from phasm_tpu.reads import ReadSet

from phasm_tpu_torch.device import resolve_device
from phasm_tpu_torch.overlap.extend import DeviceExtender
from phasm_tpu_torch.state import DeviceReads


def _resolve_backend(cfg: OverlapConfig, device) -> str:
    """``auto`` is the Myers routing on the card, the W-band dp_core on the
    CPU (the reference's TPU / CPU defaults)."""
    if cfg.backend == "auto":
        return "myers_pallas" if device.type == "cuda" else "jnp"
    return cfg.backend


def overlap_reads(
    reads: ReadSet,
    cfg: OverlapConfig | None = None,
    n_blocks: int | None = None,
    device="cuda",
) -> AlignmentTable:
    """All-vs-all overlap detection on ``device``."""
    cfg = cfg or OverlapConfig()
    dev = resolve_device(device)
    nb = n_blocks if n_blocks is not None else cfg.n_blocks
    if nb == 0:
        nb = _auto_blocks(reads.n_reads)
    if nb > 1:
        return overlap_reads_blocked(reads, cfg, n_blocks=nb, device=dev)
    backend = _resolve_backend(cfg, dev)

    lengths = reads.lengths.astype(np.int32)
    with metrics.stage("overlap.seed", reads=reads.n_reads):
        seeds = seeding.sort_seeds(
            seeding.extract_minimizers(reads.codes, lengths, cfg.seed)
        )
        cands = seeding.match_seeds(seeds, lengths, cfg.seed, presorted=True)
    metrics.incr("overlap.candidates", len(cands))
    if len(cands) == 0:
        return AlignmentTable.empty()

    a_id, b_id, st, swap, ka, kb, kd, la_k, lb_k, need = _normalize_candidates(
        cands, lengths, cfg.band
    )
    extender = DeviceExtender(
        DeviceReads.from_reference(reads, dev), band=cfg.band, backend=backend
    )
    pending = _dispatch_bucketed(extender, ka, kb, kd, need, cfg)
    r_diffs, r_as, r_ae, r_be, r_win = _materialize_pending(
        extender, pending, ka.shape[0]
    )
    return _escalate_and_build(
        extender, cfg, lengths,
        a_id, b_id, st, swap, ka, kb, kd, la_k, lb_k,
        r_diffs, r_as, r_ae, r_be, r_win,
    )


def overlap_reads_blocked(
    reads: ReadSet,
    cfg: OverlapConfig | None = None,
    n_blocks: int = 4,
    device="cuda",
) -> AlignmentTable:
    """Block-tiled overlap (DALIGNER's block-vs-block tiling): each tile's
    host normalisation runs while the previous tile's batches are in flight
    on the device.  The table equals ``overlap_reads``'s."""
    cfg = cfg or OverlapConfig()
    dev = resolve_device(device)
    backend = _resolve_backend(cfg, dev)

    lengths = reads.lengths.astype(np.int32)
    with metrics.stage("overlap.seed.minimizers", reads=reads.n_reads):
        seeds = seeding.extract_minimizers(reads.codes, lengths, cfg.seed)
    with metrics.stage("overlap.seed.sort"):
        seeds = seeding.sort_seeds(seeds)
        metrics.incr(
            "overlap.seed.repeat_dropped",
            int((~seeding.repeat_run_mask(seeds.canon, cfg.seed.max_occ)).sum()),
        )
    extender = DeviceExtender(
        DeviceReads.from_reference(reads, dev), band=cfg.band, backend=backend
    )

    n = reads.n_reads
    n_blocks = max(1, min(n_blocks, n))
    bounds = np.array([(n * i) // n_blocks for i in range(n_blocks + 1)])
    with metrics.stage("overlap.seed.match"):
        cands = seeding.match_seeds(seeds, lengths, cfg.seed, presorted=True)
    metrics.incr("overlap.candidates", len(cands))
    if len(cands) == 0:
        return AlignmentTable.empty()

    blk_a = np.searchsorted(bounds, cands.a_id, side="right") - 1
    blk_b = np.searchsorted(bounds, cands.b_id, side="right") - 1
    tile_key = blk_a * n_blocks + blk_b
    tile_order = np.argsort(tile_key, kind="stable")
    tiles = []  # (normalized frame, pending dispatches)
    for t0 in np.split(tile_order, np.nonzero(np.diff(tile_key[tile_order]))[0] + 1):
        bi, bj = divmod(int(tile_key[t0[0]]), n_blocks)
        sub = seeding.Candidates(
            a_id=cands.a_id[t0], b_id=cands.b_id[t0],
            strand=cands.strand[t0], diag=cands.diag[t0],
            n_seeds=cands.n_seeds[t0],
        )
        with metrics.stage(f"overlap.seed.tile{bi}_{bj}"):
            norm = _normalize_candidates(sub, lengths, cfg.band)
        pend = _dispatch_bucketed(
            extender, norm[4], norm[5], norm[6], norm[-1], cfg, tag=f".t{bi}_{bj}"
        )
        tiles.append((norm, pend))

    a_id, b_id, st, swap, ka, kb, kd, la_k, lb_k, _ = (
        np.concatenate([t[0][i] for t in tiles]) for i in range(10)
    )
    N = ka.shape[0]
    r = [np.full(N, BIG, dtype=np.int64)] + [np.zeros(N, dtype=np.int64) for _ in range(4)]
    off = 0
    for norm, pend in tiles:
        n_t = norm[0].shape[0]
        for dst, src in zip(r, _materialize_pending(extender, pend, n_t)):
            dst[off : off + n_t] = src
        off += n_t
    return _escalate_and_build(
        extender, cfg, lengths,
        a_id, b_id, st, swap, ka, kb, kd, la_k, lb_k, *r,
    )
