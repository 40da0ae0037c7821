"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m portbench.run`` works too).

Traffic (the harness's own work, before ``setup_s`` starts): simulate the
cell's reads (the configuration's own seed, so every run does the same
work) and seed them into candidate pairs, with frozen copies under
``portbench/traffic``.

Set-up (timed as ``setup_s``, not in the window): put the pairs in an order
drawn from ``--seed`` and batch them as the overlap engine does (frozen
copies too), upload the reads (``state.DeviceReads.from_arrays``; on a mesh
the engine copies them to every card), build the engine's
``DeviceExtender`` (its kernels too, in a fresh checkout) and run one warm
pass: the band-64 first pass, then the escalation's retries at each wider
band, selected by the frozen rule from the results before them.  Then
``WARM_SECONDS`` of replays of the whole pass, as the window will run it,
bring the card to its working clock.

The window replays that pass, whole passes until ``--seconds`` have gone
by: every first-pass batch through ``extend_async``, then ``materialize``
of each, then each retry band's batches the same way, in the engine's
order.  With ``--trace 1`` a short traced segment follows the window:
whole passes as in the window, then one pass with a synchronisation around
each call, so the kernels each call launched can be told apart.

After the window (the program's state freed) the plain reference judges a
sample of every batch group's answers from every pass (``reference/
check.py``).  The last stdout line is the result; the numbers compared
are the last lines on stderr and the last key of the result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every cache the program or torch may write stays at a fixed path in the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "portbench" / ".build" / "torch_extensions")

import numpy as np  # noqa: E402

from portbench import catalog, roofline, tracing  # noqa: E402
from portbench.reference import check  # noqa: E402
from portbench.traffic import batches, seeding, sim  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "phasm_tpu")
TRACE_SECONDS = 1.0  # whole passes in the traced segment, at least TRACE_MIN_PASSES
TRACE_MIN_PASSES = 3
WARM_SECONDS = 3.0  # replayed passes before the window


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Call:
    """One device call of the pass: the engine's arguments and which of its
    answers the check keeps."""

    W: int
    J: int
    family: str
    a: np.ndarray
    b: np.ndarray
    d: np.ndarray
    la: np.ndarray
    lb: np.ndarray
    take: np.ndarray  # positions in the batch whose answers the check keeps


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def devices_for(kind: str, chips: int):
    import torch

    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [torch.device("cpu")] * chips


def sync(devs) -> None:
    import torch

    for d in dict.fromkeys(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def make_extender(oriented, lengths, params, devs):
    """The program under test: the engine's DeviceExtender over the reads."""
    from phasm_tpu_torch.overlap.engine import DeviceExtender
    from phasm_tpu_torch.parallel import make_mesh
    from phasm_tpu_torch.state import DeviceReads

    reads = DeviceReads.from_arrays(oriented, lengths, devs[0])
    mesh = make_mesh(len(devs), devices=devs) if len(devs) > 1 else None
    return DeviceExtender(reads, band=params.band, backend=params.backend, mesh=mesh)


def rows_of(res, take=None) -> np.ndarray:
    cols = (res.diffs, res.a_start, res.a_end, res.b_end, res.win_cost)
    return np.stack([c if take is None else c[take] for c in cols])


def run_stage(ext, calls, on_result, enq=None, span=None) -> None:
    """Launch every call of one stage, then fetch each result in order."""
    outs = []
    for c in calls:
        t = time.perf_counter()
        with span(f"portbench.dispatch.W{c.W}.J{c.J}") if span else contextlib.nullcontext():
            outs.append(ext.extend_async(c.a, c.b, c.d, c.J, band=c.W))
        if enq is not None:
            enq[0] += time.perf_counter() - t
    for c, (out, M) in zip(calls, outs):
        with span(f"portbench.fetch.W{c.W}.J{c.J}") if span else contextlib.nullcontext():
            on_result(c, ext.materialize(out, M))


def plan_pass(frame, params, ext, rng):
    """Warm pass with escalation -> the window's stages ([[Call]]) and the
    check's groups [(W, J, family, frame indices)] in the order the sampled
    answers come out of a pass."""
    N = len(frame)

    def calls_of(batch_list):
        return [Call(W=b.W, J=b.J, family=b.family, a=frame.ka[b.idx], b=frame.kb[b.idx],
                     d=frame.kd[b.idx], la=frame.la[b.idx], lb=frame.lb[b.idx],
                     take=np.zeros(0, np.int64)) for b in batch_list]

    def run_batches(batch_list) -> batches.Results:
        res = batches.Results(N)
        calls = calls_of(batch_list)
        idx_of = {id(c): b.idx for c, b in zip(calls, batch_list)}
        run_stage(ext, calls, lambda c, r: res.put(idx_of[id(c)], rows_of(r).T))
        return res

    first_batches = batches.plan(frame, np.arange(N), params.band, params)
    first = run_batches(first_batches)
    stage_batches = [first_batches]

    def run_band(W, idx):
        bl = batches.plan(frame, idx, W, params)
        stage_batches.append(bl)
        return run_batches(bl).cols[:, idx].T

    retries = batches.escalate(frame, first, params, run_band)
    stages, groups = [], []
    for bl in stage_batches:
        calls = calls_of(bl)
        start = 0
        while start < len(bl):  # consecutive chunks of one (W, J) form a group
            end = start
            while end < len(bl) and (bl[end].W, bl[end].J) == (bl[start].W, bl[start].J):
                end += 1
            gidx = np.concatenate([b.idx for b in bl[start:end]])
            pos = np.sort(rng.choice(gidx.shape[0], min(check.SAMPLE_PER_GROUP, gidx.shape[0]),
                                     replace=False))
            groups.append((bl[start].W, bl[start].J, bl[start].family, gidx[pos]))
            off = 0
            for c in calls[start:end]:
                n = c.a.shape[0]
                c.take = pos[(pos >= off) & (pos < off + n)] - off
                off += n
            start = end
        stages.append(calls)
    return stages, groups, retries


def one_pass(ext, stages, enq=None, span=None) -> np.ndarray:
    parts = []

    def keep(c, r):
        if c.take.shape[0]:
            parts.append(rows_of(r, c.take))

    for calls in stages:
        run_stage(ext, calls, keep, enq, span)
    return np.concatenate(parts, axis=1)


class Variants:
    """The distinct sampled answers the passes gave, with their counts."""

    def __init__(self):
        self.items = []

    def add(self, rows: np.ndarray) -> None:
        for item in reversed(self.items):
            if np.array_equal(item[0], rows):
                item[1] += 1
                return
        self.items.append([rows, 1])


def traced_segment(ext, stages, devs, peaks):
    """Whole passes under torch.profiler, then one pass with a sync around
    each call; returns the trace part of the record."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if devs[0].type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    work = {}
    with profile(activities=acts) as prof:
        t0, n = time.perf_counter(), 0
        while n < TRACE_MIN_PASSES or time.perf_counter() - t0 < TRACE_SECONDS:
            with record_function("portbench.pass"):
                one_pass(ext, stages, span=record_function)
            n += 1
        for calls in stages:
            for c in calls:
                sync(devs)
                with record_function(f"portbench.call.{c.family}"):
                    out, M = ext.extend_async(c.a, c.b, c.d, c.J, band=c.W)
                    sync(devs)
                r = ext.materialize(out, M)
                ops, nbytes = roofline.batch_work(c.family, c.la, c.lb, c.d, r.b_end, c.W, c.J)
                w = work.setdefault(c.family, [0.0, 0.0])
                w[0] += ops
                w[1] += nbytes
        sync(devs)
    with tempfile.TemporaryDirectory(prefix="portbench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return trace_record(events, work, peaks, len(devs))


def trace_record(events: list, work: dict, peaks, n_cards: int) -> dict:
    """The trace part of the record the metric readers take: the events,
    each family's (int ops, bytes) of one pass, the traced passes' window
    and each card's busy time in it, and the card's peaks."""
    passes = tracing.spans(events, "portbench.pass")
    lo, hi = passes[0][1], passes[-1][2]
    busy = tracing.busy_per_card(events, lo, hi)
    return {"events": events, "work": work, "window_us": (lo, hi), "passes": len(passes),
            "busy_us": [busy.get(i, 0.0) for i in range(n_cards)], "peaks": peaks}


def breakdown(tr: dict) -> dict:
    """Top device operations by summed time in the traced passes, and idle
    time of the first card summed by the harness span open over each gap."""
    events, (lo, hi) = tr["events"], tr["window_us"]
    dev_ops = [op for op in tracing.device_ops(events) if op[3] > lo and op[2] < hi]
    ops = {}
    for _dev, name, t0, t1 in dev_ops:
        ops[name] = ops.get(name, 0.0) + (min(t1, hi) - max(t0, lo)) / 1e6
    first = min((op[0] for op in dev_ops), default=0)
    busy = sorted((max(t0, lo), min(t1, hi)) for dev, _n, t0, t1 in dev_ops if dev == first)
    inner = [s for s in tracing.spans(events, "portbench.")
             if s[0].startswith(("portbench.dispatch", "portbench.fetch"))]
    gaps, end, k = {}, lo, 0
    for t0, t1 in busy + [(hi, hi)]:
        if t0 > end:
            mid = (end + t0) / 2
            while k < len(inner) and inner[k][2] < mid:
                k += 1
            label = inner[k][0][len("portbench."):] if k < len(inner) and inner[k][1] <= mid else "harness"
            gaps[label] = gaps.get(label, 0.0) + (t0 - end) / 1e6
        end = max(end, t1)

    def top(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def card_state(devs) -> str:
    """SM clock, temperature, power draw and throttle reasons of the cell's cards."""
    if devs[0].type != "cuda":
        return "no card"
    q = "clocks.sm,temperature.gpu,power.draw,clocks_throttle_reasons.active"
    res = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return " | ".join(res.stdout.strip().splitlines()[: len(devs)])


def card_info(devs) -> dict:
    import torch

    if devs[0].type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": len(devs), "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(devs))
    limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": len(devs),
            "memory_peak_bytes": int(peak), "power_limit": limit[0] if limit else "unknown"}


@dataclasses.dataclass
class Traffic:
    """A cell's reads and candidate pairs, made from its configuration."""

    oriented: np.ndarray
    lengths: np.ndarray
    cands: seeding.Candidates
    params: batches.OverlapParams
    seconds: float


def make_traffic(cell) -> Traffic:
    """Simulate and seed the configuration's own read set."""
    t = time.perf_counter()
    cfg = cell.config
    codes, lengths = sim.simulate_reads(**cfg["sim"])
    cands = seeding.candidates(codes, lengths, seeding.SeedParams(**cfg["seed"]))
    params = batches.OverlapParams(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in cfg["overlap"].items()})
    tr = Traffic(oriented=sim.oriented_matrix(codes, lengths), lengths=lengths, cands=cands,
                 params=params, seconds=time.perf_counter() - t)
    say(f"{cell.name}: {codes.shape[0]} reads, {len(cands)} candidate pairs, "
        f"made in {tr.seconds:.1f} s")
    return tr


@dataclasses.dataclass
class Prepared:
    """A cell's set-up: its reads, candidates and pass, and the program
    warmed on them."""

    oriented: np.ndarray
    lengths: np.ndarray
    frame: batches.Frame
    ext: object
    devs: list
    stages: list
    groups: list
    pass_pairs: int
    reads_upload_s: float


def prepare(cell, seed: int, traffic: Traffic, kind: str = "cuda", wrap=None) -> Prepared:
    """Order and batch the cell's pairs by ``seed``, build the program on
    its reads and warm it with the escalating pass and replays of it."""
    devs = devices_for(kind, cell.chips)
    cands = seeding.reorder(traffic.cands, np.random.default_rng([seed, 0]))  # --seed: the pairs' order
    frame = batches.normalize(cands, traffic.lengths)

    t = time.perf_counter()
    ext = make_extender(traffic.oriented, traffic.lengths, traffic.params, devs)
    sync(devs)
    reads_upload_s = time.perf_counter() - t
    if wrap is not None:
        ext = wrap(ext)
    rng = np.random.default_rng([seed, 1])
    stages, groups, retries = plan_pass(frame, traffic.params, ext, rng)
    pass_pairs = sum(c.a.shape[0] for calls in stages for c in calls)
    say("  retries " + ", ".join(f"W{W}: {ix.shape[0]}" for W, ix in retries)
        + f"; {sum(len(s) for s in stages)} calls, {pass_pairs} pair extensions a pass")
    t = time.perf_counter()
    while time.perf_counter() - t < WARM_SECONDS:  # the replay itself, warm, and the card at its working clock
        one_pass(ext, stages)
    return Prepared(oriented=traffic.oriented, lengths=traffic.lengths, frame=frame, ext=ext,
                    devs=devs, stages=stages, groups=groups, pass_pairs=pass_pairs,
                    reads_upload_s=reads_upload_s)


def reference(p: Prepared, band_divisor: int = 1) -> np.ndarray:
    """The plain reference's answers of every sampled pair, on the first
    card, from the reads and candidates alone; ``band_divisor`` 2 is the
    control (each group at half its band)."""
    import torch

    rcodes = torch.from_numpy(p.oriented).to(p.devs[0])
    rlens = torch.from_numpy(p.lengths).to(p.devs[0])
    return check.reference_answers(rcodes, rlens, p.frame, p.groups, band_divisor)


def run(workload: str, seed: int, seconds: float, trace: bool, kind: str = "cuda",
        root: Path = catalog.HERE, bench: dict | None = None, wrap=None) -> dict:
    """One run of a cell; returns the result dict.  ``kind`` "cpu" and
    ``wrap`` (extender -> extender) serve the CPU tests."""
    import torch

    if bench is None:
        with open(ROOT / "BENCHMARK.json") as fh:
            bench = json.load(fh)
    cell = catalog.load_cell(workload, bench, root)
    traffic = make_traffic(cell)
    t_setup = time.perf_counter()
    p = prepare(cell, seed, traffic, kind, wrap)
    ext, stages, devs = p.ext, p.stages, p.devs

    gc.collect()
    gc.freeze()
    gc.disable()  # no collector pauses inside the window
    variants = Variants()
    pass_s, enqueue_s = [], []
    say("  card before the window: " + card_state(devs))
    setup_s = time.perf_counter() - t_setup
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        enq = [0.0]
        variants.add(one_pass(ext, stages, enq))
        te = time.perf_counter()
        pass_s.append(te - ts)
        enqueue_s.append(enq[0])
        if te - t0 >= seconds:
            break
    window_s = te - t0
    gc.enable()
    gc.unfreeze()
    say("  card after the window: " + card_state(devs))
    ms, ends = np.asarray(pass_s) * 1e3, np.cumsum(pass_s)
    seg = [ms[(ends > a) & (ends <= a + 5)] for a in range(0, int(window_s), 5)]
    say("  pass ms p5/25/50/75/95 " + " ".join(f"{v:.2f}" for v in np.percentile(ms, [5, 25, 50, 75, 95]))
        + "; mean by 5 s of the window " + " ".join(f"{s.mean():.2f}" for s in seg if s.size))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded in the run: {found}")

    device = card_info(devs)
    record = {
        "setup_s": setup_s, "reads_upload_s": p.reads_upload_s, "window_s": window_s,
        "passes": len(pass_s), "pairs_per_pass": len(p.frame), "pass_s": pass_s,
        "enqueue_s": enqueue_s, "chips": cell.chips, "trace": None,
    }
    if trace:
        record["trace"] = traced_segment(ext, stages, devs, roofline.PEAKS.get(device["kind"]))
        busy, (lo, hi) = record["trace"]["busy_us"], record["trace"]["window_us"]
        device["busy_s"] = sum(busy) / len(busy) / 1e6
        device["window_s"] = (hi - lo) / 1e6
        matched, n_k = tracing.launches_found(record["trace"]["events"])
        say(f"  traced: {record['trace']['passes']} passes, {n_k} kernels, {matched} with their launch call")
    metrics = catalog.read_metrics(cell.per_layer if trace else cell.end_to_end, record, root)
    trace_breakdown = breakdown(record["trace"]) if trace else None
    p.ext = ext = record = None  # the program's state goes before the reference runs
    gc.collect()
    if kind == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = reference(p)
    bad, seen = check.mismatches(variants.items, ref)
    say(f"  window {window_s:.3f} s, {len(pass_s)} passes; reference {time.perf_counter() - t:.1f} s "
        f"on {ref.shape[1]} sampled pairs x {len(pass_s)} passes, {len(variants.items)} distinct")

    result = {
        "correct": bool(seen > 0 and bad <= check.LIMITS["mismatched_results"]),
        "attempted": int(len(pass_s) * p.pass_pairs),
        "failed": int(bad),
        "metrics": metrics,
        "device": device,
    }
    if trace:
        result["breakdown"] = trace_breakdown
    result["checks"] = {"mismatched_results": {"value": int(bad), "limit": check.LIMITS["mismatched_results"]},
                        "results_compared": {"value": int(seen), "limit": "above 0"}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)  # the host side is a few small copies: one thread, less jitter
    with open(ROOT / "BENCHMARK.json") as fh:
        bench = json.load(fh)
    chips = catalog.load_cell(args.workload, bench).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"no result: {args.workload} needs {chips} CUDA card(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    for k, v in result["checks"].items():
        say(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
