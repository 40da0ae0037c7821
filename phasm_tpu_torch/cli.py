"""CLI of the port: ``simulate`` and ``pipeline`` with the reference CLI's
flags, plus ``--device`` on ``pipeline`` (default ``cuda``; a missing card
is an error, not a CPU run).

Usage:
  python -m phasm_tpu_torch.cli simulate --out reads.fa --ploidy 2
  python -m phasm_tpu_torch.cli pipeline reads.fa --out asm.fa --polish
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

from phasm_tpu.cli import cmd_simulate

log = logging.getLogger("phasm_tpu_torch")


def cmd_pipeline(args):
    from phasm_tpu.io import fasta
    from phasm_tpu.overlap import OverlapConfig
    from phasm_tpu.phasing import PhaseConfig
    from phasm_tpu.pipeline import PipelineConfig

    from phasm_tpu_torch.overlap.engine import overlap_reads
    from phasm_tpu_torch.pipeline import assemble

    rs = fasta.read_fasta(args.reads)
    t = overlap_reads(
        rs, OverlapConfig(backend=args.backend, n_blocks=args.n_blocks),
        device=args.device,
    )
    cfg = PipelineConfig(
        min_overlap_length=args.min_overlap_length,
        max_error_rate=args.max_error_rate,
        length_fuzz=args.length_fuzz,
        max_tip_len=args.max_tip_len,
        phase=PhaseConfig(ploidy=args.ploidy, prune_factor=args.prune_factor),
        adaptive_error=args.adaptive_error,
        polish=args.polish,
    )
    res = assemble(rs, t, cfg, device=args.device)
    res.write_fasta(args.out)
    print(json.dumps(res.stats))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phasm_tpu_torch", description=__doc__)
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("simulate", help="simulate a polyploid read set")
    s.add_argument("--out", required=True)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--genome-len", type=int, default=50_000)
    s.add_argument("--ploidy", type=int, default=2)
    s.add_argument("--coverage", type=float, default=20.0)
    s.add_argument("--read-len", type=int, default=5000)
    s.add_argument("--error-rate", type=float, default=0.05)
    s.add_argument("--hotspots", type=int, default=0)
    s.add_argument("--hotspot-rate", type=float, default=0.05)
    s.add_argument("--hotspot-width", type=int, default=1500)
    s.add_argument("--read-len-spread", type=float, default=None)
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser("pipeline", help="overlap -> filter -> layout -> phase")
    s.add_argument("reads")
    s.add_argument("--out", required=True)
    s.add_argument("--ploidy", type=int, default=2)
    s.add_argument("--min-overlap-length", type=int, default=800)
    s.add_argument("--max-error-rate", type=float, default=0.25)
    s.add_argument("--length-fuzz", type=int, default=1000)
    s.add_argument("--max-tip-len", type=int, default=4)
    s.add_argument("--prune-factor", type=float, default=0.01)
    s.add_argument("--backend", default="auto",
                   choices=["auto", "pallas", "jnp", "myers", "myers_pallas"])
    s.add_argument("--n-blocks", type=int, default=0,
                   help="DALIGNER-style block tiling (0 = auto)")
    s.add_argument("--adaptive-error", action="store_true",
                   help="per-pair adaptive divergence filter (haplotype purity)")
    s.add_argument("--polish", action="store_true",
                   help="consensus-polish output sequences (pileup voting)")
    s.add_argument("--device", default="cuda",
                   help="torch device for the overlap, reduction and phasing work")
    s.set_defaults(fn=cmd_pipeline)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )
    args.fn(args)


if __name__ == "__main__":
    main()
