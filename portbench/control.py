"""The control of the output check, on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed: the cell's set-up (the program warmed, which fixes the
pass's retry groups), then the plain reference put in the program's place
at half of each group's band, compared with the reference at the band the
configuration states, over the same sampled pairs.  The configuration
states the bands (64 first, then 128 / 256 / 512); a narrower band is the
step a faster program could be tempted to take.  Each seed's reading must
fail the limit (``check.LIMITS``).  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import catalog, run  # noqa: E402
from portbench.reference import check  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    import torch

    with open(run.ROOT / "BENCHMARK.json") as fh:
        cell = catalog.load_cell(args.workload, json.load(fh))
    traffic = run.make_traffic(cell)  # the same read set for every seed
    for seed in (int(s) for s in args.seeds.split(",")):
        p = run.prepare(cell, seed, traffic)
        p.ext = None
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = run.reference(p)
        t_ref = time.perf_counter() - t
        ctl = run.reference(p, band_divisor=2)
        bad, seen = check.mismatches([[ctl, 1]], ref)
        print(json.dumps({"workload": args.workload, "seed": seed, "control_mismatched_results": bad,
                          "limit": check.LIMITS["mismatched_results"], "results_compared": seen,
                          "fails_limit": bad > check.LIMITS["mismatched_results"],
                          "reference_s": t_ref, "groups": [[W, J, f, int(ix.shape[0])] for W, J, f, ix in p.groups]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
