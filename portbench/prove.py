"""Runs of one cell, each in a process of its own as the check makes them,
and the spread of every metric they report.

    python3 portbench/prove.py --workload <cell> --seconds 20 --seeds 1,2,3,4,5,6 \
        [--sets 2] [--trace-seeds 7,8,9] [--out portbench/.build/prove.jsonl]

Each set runs ``--seeds`` in order with --trace 0; the traced seeds follow.
Every result line (with its seed, set, wall seconds and the tail of
stderr) is appended to ``--out``.  The summary gives, a set, each
metric's median and its spread: the distance between the first and third
quartile (``statistics.quantiles(values, n=4)``) as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one(workload: str, seed: int, seconds: int, trace: int) -> dict:
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(seed),
                          "--seconds", str(seconds), "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t
    lines = res.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1]) if res.returncode == 0 else {}
    except (IndexError, json.JSONDecodeError):
        out = {}
    out.update(seed=seed, trace=trace, rc=res.returncode, wall_s=wall,
               stderr_tail=res.stderr[-1500:])
    return out


def spread(values: list[float]) -> tuple[float, float]:
    med = statistics.median(values)
    q = statistics.quantiles(values, n=4)
    return med, (q[2] - q[0]) / med if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out", default="portbench/.build/prove.jsonl")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = [(k, s, 0) for k in range(args.sets) for s in seeds]
    runs += [(-1, int(s), 1) for s in args.trace_seeds.split(",") if s]
    by_set = {}
    for k, seed, trace in runs:
        r = one(args.workload, seed, args.seconds, trace)
        r["set"] = k
        with open(out, "a") as fh:
            fh.write(json.dumps(r) + "\n")
        m = {n: v["value"] for n, v in r.get("metrics", {}).items()}
        print(f"set {k} seed {seed} trace {trace} rc {r['rc']} correct {r.get('correct')} "
              f"wall {r['wall_s']:.1f}s {json.dumps(m)} checks {json.dumps(r.get('checks'))}", flush=True)
        if r["rc"] != 0 or not r.get("correct"):
            print(r["stderr_tail"], flush=True)
        by_set.setdefault(k, []).append(m)
    for k, ms in sorted(by_set.items()):
        names = sorted({n for m in ms for n in m})
        for n in names:
            vals = [m[n] for m in ms if n in m]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"summary set {k} {n}: median {med:.6g} spread {sp:.4%} over {len(vals)} runs: "
                      + " ".join(f"{v:.6g}" for v in vals), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
