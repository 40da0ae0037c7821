"""Run the evaluation ladder on the port; one JSON line per rung.

    python -m phasm_tpu_torch.ladder [--backend auto|jnp|pallas|myers|myers_pallas]
                                     [--rungs c1,c3] [--strict] [--out FILE]
                                     [--device cuda|cpu]

Twin of the reference's ``scripts/run_ladder.py``, with the same flags and
``--device`` (default ``cuda``; a missing card raises).  Each rung of
``configs.ladder()`` whose name starts with one of ``--rungs`` runs through
``configs.run_rung`` on the device, and its row (topology counts, stage
seconds, accuracy columns, launches per stage) is printed and flushed as
one JSON line, and appended to ``--out`` when given.  Without ``--strict``
a rung that raises gives a ``{"name", "error"}`` line and the ladder goes
on; the exit status is then 1 (the reference exits 0).
"""
from __future__ import annotations

import argparse
import json
import sys

from phasm_tpu_torch import configs
from phasm_tpu_torch.device import resolve_device


def row_diff(row: dict, ref: dict) -> tuple[list, dict]:
    """The columns a port row shares with a reference ladder row, apart from
    ``name``, ``backend`` and the ``*_s`` times, and those of them whose
    values differ ({column: [port, reference]})."""
    skip = {"name", "backend"} | {k for k in ref if k.endswith("_s")}
    shared = [k for k in ref if k in row and k not in skip]
    return shared, {k: [row[k], ref[k]] for k in shared if row[k] != ref[k]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m phasm_tpu_torch.ladder")
    p.add_argument(
        "--backend", default=None,
        choices=["auto", "jnp", "pallas", "myers", "myers_pallas"],
        help="overlap extend backend (default: config's, i.e. auto)",
    )
    p.add_argument("--rungs", default=None, help="comma-separated rung name prefixes")
    p.add_argument(
        "--strict", action="store_true",
        help="re-raise the first rung failure instead of continuing",
    )
    p.add_argument("--out", default=None, help="also append JSONL lines here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    want = args.rungs.split(",") if args.rungs else None
    failed = 0
    fh = open(args.out, "a") if args.out else None
    try:
        for cfg in configs.ladder():
            if want and not any(cfg.name.startswith(w) for w in want):
                continue
            try:
                line = json.dumps(configs.run_rung(cfg, backend=args.backend, device=dev))
            except Exception as e:  # keep the ladder going unless --strict
                if args.strict:
                    raise
                failed += 1
                line = json.dumps({"name": cfg.name, "error": repr(e)})
            print(line, flush=True)
            if fh:
                fh.write(line + "\n")
                fh.flush()
    finally:
        if fh:
            fh.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
