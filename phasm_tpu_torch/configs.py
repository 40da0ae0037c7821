"""Ladder rungs on the port: ``run_rung``, the twin of
``phasm_tpu.configs.run_rung`` over the reference's ``ladder()``.

In place of the reference's ``overlap_s`` each row carries
``overlap_cold_s`` (the first overlap call, which is what ``overlap_s``
times: device upload, table build and, in a fresh process, the kernel
build) and ``overlap_warm_s`` (a second call on the same reads), the device
it ran on, and the kernel launches per stage.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from phasm_tpu.configs import LadderConfig
from phasm_tpu.eval import evaluate_assembly
from phasm_tpu.sim import simulate_reads

from phasm_tpu_torch.device import resolve_device
from phasm_tpu_torch.overlap import extend, myers_cuda
from phasm_tpu_torch.overlap.engine import overlap_reads
from phasm_tpu_torch.pipeline import assemble


def launch_counts() -> dict:
    """Launch counts of every kernel wrapper in this process."""
    return {
        "myers_fwd": myers_cuda.myers_fwd_launches,
        "myers_rev": myers_cuda.myers_rev_launches,
        "wband": extend.wband_launches,
    }


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_rung(cfg: LadderConfig, backend: str | None = None, device="cuda") -> dict:
    """Execute one ladder rung end to end on ``device``; returns the stats
    row (topology counts, stage seconds, accuracy columns)."""
    dev = resolve_device(device)
    t0 = time.time()
    rs, truth = simulate_reads(**cfg.sim)
    ov = cfg.overlap
    if backend:
        ov = dataclasses.replace(ov, backend=backend)
    c0 = launch_counts()
    t1 = time.time()
    table = overlap_reads(rs, ov, device=dev)
    _sync(dev)
    t2 = time.time()
    c1 = launch_counts()
    overlap_reads(rs, ov, device=dev)
    _sync(dev)
    t_warm = time.time() - t2
    c2 = launch_counts()
    t2b = time.time()
    res = assemble(rs, table, cfg.pipeline, device=dev)
    _sync(dev)
    t3 = time.time()
    c3 = launch_counts()
    qc = evaluate_assembly(res, truth)
    t4 = time.time()
    out = dict(res.stats)
    purity = qc["allele_purity"]
    out.update(
        name=cfg.name,
        backend=backend or ov.backend,
        device=str(dev),
        sim_s=round(t1 - t0, 1),
        overlap_cold_s=round(t2 - t1, 3),
        overlap_warm_s=round(t_warm, 3),
        assemble_s=round(t3 - t2b, 1),
        eval_s=round(t4 - t3, 1),
        qc_kmer_identity=qc["kmer_identity"]["weighted_mean"],
        qc_kmer_identity_min=qc["kmer_identity"]["min"],
        qc_completeness=qc["completeness"],
        qc_allele_purity=purity and purity["min"],
        qc_allele_purity_mean=purity and purity["mean"],
        qc_purity_haplotigs_measured=purity and purity["n_measured"],
        launches_overlap=_delta(c1, c0),
        launches_overlap_warm=_delta(c2, c1),
        launches_assemble=_delta(c3, c2),
    )
    return out
