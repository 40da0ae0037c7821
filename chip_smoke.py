#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (phasm_tpu_torch) on one card.

    python3 chip_smoke.py

1. environment: the card's name and power limit, torch / CUDA / nvcc /
   triton versions, and the native host library (required);
2. builds every CUDA kernel of the main path from phasm_tpu_torch/csrc;
3. holds each kernel against its plain PyTorch version on the card, on
   real candidate batches from the reference's seeding: Myers forward and
   reverse on the c4 rung's J = 1024 / 4096 / 8192 buckets at band 64 and
   its J = 4096 bucket at band 128; the W-band kernel on the c3 rung's
   whole J = 12288 bucket at band 64 and on c4 pairs at bands 256 and 512.
   Every integer output must be equal; both times are printed per batch;
4. drives the main path once, ``phasm_tpu_torch.configs.run_rung`` on the
   c4 rung (200 kb diploid, 1,333 reads) on the card, with every launch
   count set to 0 just before and read just after, and holds its quality
   columns to the reference ladder's c4 row.

Prints the kernels' JSON line, then the result line
``{"ok": true, "device": {...}}`` last.  Any failure exits non-zero and
prints no result line; so does a machine without a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# the reference ladder's c4 row (LADDER_r5.jsonl) and the allowed shortfall
C4_REFERENCE = {"qc_kmer_identity": 0.9896, "qc_completeness": 0.9896}
QC_SLACK = 0.005
MIN_PURITY = 0.99

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "myers_fwd": ("phasm_tpu_torch/csrc/myers.cu", "phasm_tpu/overlap/myers_pallas.py:157"),
    "myers_rev": ("phasm_tpu_torch/csrc/myers.cu", "phasm_tpu/overlap/myers_pallas.py:450"),
    "wband": ("phasm_tpu_torch/csrc/wband.cu", "phasm_tpu/overlap/extend.py:1246"),
}


def _say(*a):
    print(*a, flush=True)


def environment() -> None:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _say(smi)  # the card's name and power limit, exactly as nvidia-smi gives them
    from phasm_tpu_torch import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    _say(
        f"versions: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, nvcc {nvcc.stdout.strip().splitlines()[-1]}, "
        f"triton {triton_v}"
    )
    from phasm_tpu import native

    if native.get_lib() is None:
        raise RuntimeError("phasm_tpu.native did not load: the polish quality gates need it")
    _say("native host library: loaded")


def build() -> float:
    from phasm_tpu_torch import _build

    lib_was_built = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    _say(f"kernel build: {dt:.2f} s ({'nvcc' if lib_was_built else 'cached'}) -> {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            _say("  ptxas:", line.strip())
    return dt


def _candidates(rung, band: int):
    """Kernel-frame candidates of a rung's read set: the reference engine's
    seeding + _normalize_candidates.  Returns (reads, ka, kb, kd, la, lb)."""
    import numpy as np

    from phasm_tpu.overlap import seeding
    from phasm_tpu.overlap.engine import _normalize_candidates
    from phasm_tpu.sim import simulate_reads

    rs, _ = simulate_reads(**rung.sim)
    lengths = rs.lengths.astype(np.int32)
    cfg = rung.overlap.seed
    seeds = seeding.sort_seeds(seeding.extract_minimizers(rs.codes, lengths, cfg))
    cands = seeding.match_seeds(seeds, lengths, cfg, presorted=True)
    _, _, _, _, ka, kb, kd, la, lb, _ = _normalize_candidates(cands, lengths, band)
    return rs, ka, kb, kd, la, lb


def _bucket(rung, ka, kd, la, lb, band: int, J: int):
    """Indices of the pairs the engine puts into column bucket J at band."""
    import numpy as np

    from phasm_tpu.overlap.engine import _bucket_edges

    need = np.minimum(lb, la - kd + band).astype(np.int64) + band
    edges = _bucket_edges(need, rung.overlap)
    i = edges.index(J)
    lo = edges[i - 1] if i else 0
    sel = (need > lo) & ((need <= J) if i + 1 < len(edges) else True)
    return np.nonzero(sel)[0]


def _time_ms(fn, reps: int) -> float:
    import torch

    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0 for g, w in zip(got, want))


def kernel_checks() -> dict:
    """Every kernel against its plain version on real batches; returns
    {name: [case dicts]}.  Raises on any disagreement."""
    import torch

    from phasm_tpu.configs import ladder
    from phasm_tpu_torch.overlap import extend as X
    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap import myers_cuda as MC
    from phasm_tpu_torch.overlap.myers_cuda import index_tensors
    from phasm_tpu_torch.state import DeviceReads

    rungs = {r.name.split("_")[0]: r for r in ladder()}
    results: dict = {k: [] for k in KERNELS}

    def case(name, label, kernel_fn, plain_fn, B, W, J, reps=5):
        kernel_fn()  # warm-up launch
        torch.cuda.synchronize()
        ms = _time_ms(kernel_fn, reps)
        got = kernel_fn()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = plain_fn()
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        err = _max_abs_err(got, want)
        rec = dict(case=label, pairs=B, W=W, J=J, ms=ms, plain_ms=plain_ms, max_abs_err=err)
        _say(f"  {name} {label}: pairs={B} W={W} J={J} kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, max_abs_err {err}")
        results[name].append(rec)
        if err != 0:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain version")

    c4 = rungs["c4"]
    rs4, ka, kb, kd, la, lb = _candidates(c4, 64)
    r4 = DeviceReads.from_reference(rs4, "cuda")
    _say(f"c4: {rs4.n_reads} reads, {ka.shape[0]} candidate pairs")
    for W, J in ((64, 1024), (64, 4096), (64, 8192), (128, 4096)):
        assert X.route("myers_pallas", W, J) == "myers", (W, J)
        idx = _bucket(c4, ka, kd, la, lb, W, J)
        a, b, d = index_tensors(r4.device, ka[idx], kb[idx], kd[idx])
        B = len(idx)
        fwd = MC.myers_fwd(r4, a, b, d, W, J)
        case("myers_fwd", f"c4.W{W}.J{J}", lambda: MC.myers_fwd(r4, a, b, d, W, J),
             lambda: plain.fwd_plain(r4.codes, r4.lengths, a, b, d, W, J), B, W, J)
        ie, je = fwd[1], fwd[2]
        case("myers_rev", f"c4.W{W}.J{J}", lambda: MC.myers_rev(r4, a, b, d, ie, je, W, J),
             lambda: plain.rev_plain(r4.codes, r4.lengths, a, b, d, ie, je, W, J), B, W, J)

    c3 = rungs["c3"]
    rs3, ka3, kb3, kd3, la3, lb3 = _candidates(c3, 64)
    r3 = DeviceReads.from_reference(rs3, "cuda")
    _say(f"c3: {rs3.n_reads} reads, {ka3.shape[0]} candidate pairs")
    cases = [(r3, c3, ka3, kb3, kd3, la3, lb3, 64, 12288, "c3")]
    cases += [(r4, c4, ka, kb, kd, la, lb, W, 4096, "c4") for W in (256, 512)]
    for reads, rung, ka_, kb_, kd_, la_, lb_, W, J, tag in cases:
        assert X.route("myers_pallas", W, J) == "wband", (W, J)
        idx = _bucket(rung, ka_, kd_, la_, lb_, W, J)
        a, b, d = index_tensors(reads.device, ka_[idx], kb_[idx], kd_[idx])
        case("wband", f"{tag}.W{W}.J{J}", lambda: X.wband(reads, a, b, d, W, J),
             lambda: X.wband_plain(reads.codes, reads.lengths, a, b, d, W, J),
             len(idx), W, J)
    return results


def main_path() -> dict:
    """c4 end to end on the card; returns the stats row + launch counts."""
    from phasm_tpu import metrics
    from phasm_tpu.configs import ladder
    from phasm_tpu_torch import configs
    from phasm_tpu_torch.overlap import extend, myers_cuda

    c4 = next(r for r in ladder() if r.name.startswith("c4"))
    metrics.reset()
    myers_cuda.myers_fwd_launches = 0
    myers_cuda.myers_rev_launches = 0
    extend.wband_launches = 0
    row = configs.run_rung(c4, device="cuda")
    launches = configs.launch_counts()
    report = metrics.report()
    counters = report["counters"]
    _say("c4 row:", json.dumps(row, sort_keys=True))
    _say("c4 stage seconds:", json.dumps({k: row[k] for k in (
        "sim_s", "overlap_cold_s", "overlap_warm_s", "assemble_s", "eval_s")}))
    _say("c4 stage timers (host clock, both overlap calls summed):", json.dumps(
        {k: round(v, 3) for k, v in sorted(report["seconds"].items())}))
    _say("c4 kernel families:", json.dumps(
        {k: v for k, v in counters.items() if k.startswith("overlap.family.")}, sort_keys=True))
    _say("c4 wide-band retries:", json.dumps(
        {k: v for k, v in counters.items() if k.startswith("overlap.wide_band_retries")}, sort_keys=True))
    _say("c4 launches:", json.dumps(launches), "per stage:", json.dumps(
        {k: row[k] for k in ("launches_overlap", "launches_overlap_warm", "launches_assemble")}))
    for stage in ("launches_overlap", "launches_assemble"):
        for k in ("myers_fwd", "myers_rev"):
            if row[stage][k] <= 0:
                raise AssertionError(f"{k} never launched in {stage}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if row["n_haplotigs"] <= 0:
        raise AssertionError("no haplotigs")
    diffs = {k: row[k] - v for k, v in C4_REFERENCE.items()}
    _say("c4 qc minus reference row:", json.dumps(diffs), "purity:", row["qc_allele_purity"])
    for k, dv in diffs.items():
        if dv < -QC_SLACK:
            raise AssertionError(f"{k} {row[k]} below reference {C4_REFERENCE[k]} - {QC_SLACK}")
    if row["qc_allele_purity"] is None or row["qc_allele_purity"] < MIN_PURITY:
        raise AssertionError(f"allele purity {row['qc_allele_purity']} < {MIN_PURITY}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    import phasm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    environment()
    build()
    _say("kernels vs plain versions:")
    checks = kernel_checks()
    _say("main path:")
    launches = main_path()
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        recs = checks[name]
        rep = max(recs, key=lambda r: r["pairs"] * r["J"])  # largest batch
        line["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=rep["ms"], plain_ms=rep["plain_ms"], at=rep["case"], cases=recs,
        ))
    _say(json.dumps(line))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
