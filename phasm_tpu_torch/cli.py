"""CLI of the port: the reference CLI's subcommands with its flags, plus
``--device`` on the stages that do device work.

Stage boundary files keep the reference's checkpoint/resume contract:
alignments as .npz (or LAdump text for interop), graphs as GFA2, haplotigs
as FASTA, so a stage's file from either CLI feeds the other's next stage.
``overlap``, ``phase`` and ``pipeline`` take ``--device`` (default ``cuda``;
a missing card is an error, not a CPU run); ``filter`` and ``layout`` are
host work, as in the reference.

Usage:
  python -m phasm_tpu_torch.cli simulate --out reads.fa --ploidy 2
  python -m phasm_tpu_torch.cli overlap reads.fa --out aln.npz --device cuda
  python -m phasm_tpu_torch.cli filter reads.fa aln.npz --out filtered.npz
  python -m phasm_tpu_torch.cli layout reads.fa filtered.npz --out graph.gfa2
  python -m phasm_tpu_torch.cli phase reads.fa graph.gfa2 aln.npz --out haplotigs.fa --device cuda
  python -m phasm_tpu_torch.cli pipeline reads.fa --out asm.fa --polish
"""
from __future__ import annotations

import argparse
import json
import logging
import sys

log = logging.getLogger("phasm_tpu_torch")

BACKENDS = ["auto", "pallas", "jnp", "myers", "myers_pallas"]


def _load_alignments(path: str):
    from phasm_tpu_torch.io import daligner

    if path.endswith(".npz"):
        return daligner.load_table_npz(path)
    with open(path) as fh:
        return daligner.parse_local_alignments(fh)


def cmd_simulate(args):
    from phasm_tpu_torch.io import fasta
    from phasm_tpu_torch.sim import simulate_reads

    rs, truth = simulate_reads(
        seed=args.seed,
        genome_len=args.genome_len,
        ploidy=args.ploidy,
        coverage=args.coverage,
        mean_read_len=args.read_len,
        error_rate=args.error_rate,
        hotspots=args.hotspots,
        hotspot_rate=args.hotspot_rate,
        hotspot_width=args.hotspot_width,
        read_len_spread=args.read_len_spread,
    )
    fasta.write_fasta(
        args.out, [(rs.names[i], rs.oriented_str(2 * i)) for i in range(rs.n_reads)]
    )
    log.info("wrote %d reads to %s", rs.n_reads, args.out)


def cmd_overlap(args):
    from phasm_tpu_torch.device import resolve_device
    from phasm_tpu_torch.io import daligner, fasta
    from phasm_tpu_torch.overlap.engine import OverlapConfig, overlap_reads
    from phasm_tpu_torch.overlap.seeding import SeedConfig

    dev = resolve_device(args.device)
    rs = fasta.read_fasta(args.reads)
    cfg = OverlapConfig(
        seed=SeedConfig(k=args.k, window=args.window, min_seeds=args.min_seeds),
        min_overlap=args.min_overlap,
        backend=args.backend,
        n_blocks=args.n_blocks,
    )
    t = overlap_reads(rs, cfg, device=dev)
    if args.out.endswith(".npz"):
        daligner.save_table_npz(args.out, t)
    else:
        daligner.write_ladump(args.out, t)
    log.info("found %d alignments -> %s", len(t), args.out)


def cmd_filter(args):
    """Ref: `phasm filter` (SURVEY.md §4.1)."""
    from phasm_tpu_torch.filter import (
        FilterChain,
        MaxErrorRate,
        MinOverlapLength,
        MinReadLength,
        ProperOverlapsOnly,
    )
    from phasm_tpu_torch.io import daligner, fasta

    rs = fasta.read_fasta(args.reads)
    t = _load_alignments(args.alignments)
    chain = FilterChain(
        [
            MinReadLength(args.min_read_length),
            MinOverlapLength(args.min_overlap_length),
            MaxErrorRate(args.max_error_rate),
            ProperOverlapsOnly(),
        ],
        max_overhang_abs=args.max_overhang,
        max_overhang_ratio=args.max_overhang_ratio,
    )
    ft, types, contained = chain.apply(t, rs.lengths)
    daligner.save_table_npz(args.out, ft)
    log.info(
        "kept %d/%d alignments (%d contained reads) -> %s",
        len(ft), len(t), int(contained.sum()), args.out,
    )


def cmd_layout(args):
    """Ref: `phasm layout` (SURVEY.md §4.2).  The transitive reduction is
    the host pass, as in the reference's layout stage."""
    from phasm_tpu_torch.graph import (
        build_string_graph,
        remove_tips,
        remove_transitive_edges,
    )
    from phasm_tpu_torch.io import daligner, fasta, gfa

    rs = fasta.read_fasta(args.reads)
    t = _load_alignments(args.alignments)
    types = t.classify(rs.lengths)
    g = build_string_graph(t, types, rs.lengths)
    log.info("string graph: %d edges", g.n_edges)
    g = remove_transitive_edges(g, fuzz=args.length_fuzz)
    log.info("after transitive reduction: %d edges", g.n_edges)
    g, removed = remove_tips(g, max_tip_len=args.max_tip_len)
    log.info("after tip removal: %d edges (%d reads clipped)", g.n_edges, int(removed.sum()))
    gfa.write_gfa2(args.out, g, rs, sequences=not args.no_sequences)
    log.info("wrote %s", args.out)


def cmd_phase(args):
    """Ref: `phasm phase` (SURVEY.md §4.3); the branch scorer runs on
    ``--device``."""
    from phasm_tpu_torch import dna
    from phasm_tpu_torch.bubbles import build_chains
    from phasm_tpu_torch.bubbles_linear import find_superbubbles_linear as find_superbubbles
    from phasm_tpu_torch.device import resolve_device
    from phasm_tpu_torch.graph.unitigs import merge_unambiguous_paths
    from phasm_tpu_torch.io import fasta, gfa
    from phasm_tpu_torch.phasing import PhaseConfig, phase_all

    dev = resolve_device(args.device)  # a graph without chains uses no device
    g, gfa_reads = gfa.read_gfa2(args.graph)
    rs = fasta.read_fasta(args.reads)
    ev = _load_alignments(args.alignments)
    # GFA node ids are file positions (only edge-bearing reads serialize);
    # remap them onto the FASTA read indices so phasing evidence and spelled
    # sequences line up
    g = gfa.remap_node_ids(g, gfa_reads.names, rs)

    ug = merge_unambiguous_paths(g)
    bubbles = find_superbubbles(ug)
    chains = build_chains(ug, bubbles)
    log.info("%d superbubbles, %d chains", len(bubbles), len(chains))
    cfg = PhaseConfig(ploidy=args.ploidy, prune_factor=args.prune_factor)
    results = phase_all(ug, rs, ev, chains, cfg, device=dev)
    recs = []
    for ci, r in enumerate(results):
        for m, seq in enumerate(r.haplotigs):
            recs.append((f"haplotig_c{ci}_h{m}", dna.decode(seq)))
    fasta.write_fasta(args.out, recs)
    log.info("wrote %d haplotigs -> %s", len(recs), args.out)
    if args.read_assignment:
        with open(args.read_assignment, "w") as fh:
            fh.write("read\tchain\thaplotypes\n")
            for ci, r in enumerate(results):
                for rd, haps in sorted(r.read_assignment.items()):
                    hs = ",".join(str(h) for h in haps) if haps else "-"
                    fh.write(f"{rs.names[rd]}\t{ci}\t{hs}\n")
        log.info("wrote read assignment -> %s", args.read_assignment)


def cmd_pipeline(args):
    from phasm_tpu_torch.io import fasta
    from phasm_tpu_torch.overlap.engine import OverlapConfig, overlap_reads
    from phasm_tpu_torch.phasing import PhaseConfig
    from phasm_tpu_torch.pipeline import PipelineConfig, assemble

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

    s = sub.add_parser("overlap", help="all-vs-all overlap detection")
    s.add_argument("reads")
    s.add_argument("--out", required=True)
    s.add_argument("--k", type=int, default=15)
    s.add_argument("--window", type=int, default=8)
    s.add_argument("--min-seeds", type=int, default=3)
    s.add_argument("--min-overlap", type=int, default=500)
    s.add_argument("--backend", default="auto", choices=BACKENDS)
    s.add_argument("--n-blocks", type=int, default=0,
                   help="DALIGNER-style block tiling (0 = auto)")
    s.add_argument("--device", default="cuda", help="torch device for the overlap kernels")
    s.set_defaults(fn=cmd_overlap)

    s = sub.add_parser("filter", help="classify + filter alignments (stage 1)")
    s.add_argument("reads")
    s.add_argument("alignments")
    s.add_argument("--out", required=True)
    s.add_argument("--min-read-length", type=int, default=1000)
    s.add_argument("--min-overlap-length", type=int, default=800)
    s.add_argument("--max-error-rate", type=float, default=0.25)
    s.add_argument("--max-overhang", type=int, default=1000)
    s.add_argument("--max-overhang-ratio", type=float, default=0.8)
    s.set_defaults(fn=cmd_filter)

    s = sub.add_parser("layout", help="string graph build + clean (stage 2)")
    s.add_argument("reads")
    s.add_argument("alignments")
    s.add_argument("--out", required=True)
    s.add_argument("--length-fuzz", type=int, default=1000)
    s.add_argument("--max-tip-len", type=int, default=4)
    s.add_argument("--no-sequences", action="store_true")
    s.set_defaults(fn=cmd_layout)

    s = sub.add_parser("phase", help="superbubble-chain phasing (stage 3)")
    s.add_argument("reads")
    s.add_argument("graph")
    s.add_argument("alignments")
    s.add_argument("--out", required=True)
    s.add_argument("--ploidy", type=int, default=2)
    s.add_argument("--prune-factor", type=float, default=0.01)
    s.add_argument("--read-assignment", default=None,
                   help="optional TSV of read -> haplotype assignment")
    s.add_argument("--device", default="cuda", help="torch device for the branch scorer")
    s.set_defaults(fn=cmd_phase)

    s = sub.add_parser("pipeline", help="overlap -> filter -> layout -> phase")
    s.add_argument("reads")
    s.add_argument("--out", required=True)
    s.add_argument("--ploidy", type=int, default=2)
    s.add_argument("--min-overlap-length", type=int, default=800)
    s.add_argument("--max-error-rate", type=float, default=0.25)
    s.add_argument("--length-fuzz", type=int, default=1000)
    s.add_argument("--max-tip-len", type=int, default=4)
    s.add_argument("--prune-factor", type=float, default=0.01)
    s.add_argument("--backend", default="auto", choices=BACKENDS)
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
