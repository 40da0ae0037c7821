"""The port's host copies (phasm_tpu_torch's numpy / ctypes modules) == the
reference's modules they were copied from: one seeded input through both
packages, outputs compared exactly (every output here is an integer array,
a string or a float computed by the same numpy expression in the same
order).  One case per copied module or module group, each on a tiny input.
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest

from test_phasing import chain_fixture
from test_phasing_batch import many_chains_fixture
from torch_cases import ensure_reference_native

ensure_reference_native()  # before any test of this worker loads it

PKGS = ("phasm_tpu", "phasm_tpu_torch")

# SNV-only haplotypes (indel_rate 0) so truth_alignments' cross-haplotype
# rows have exact coordinates; one het hotspot
SIM = dict(
    seed=11, genome_len=6000, ploidy=2, coverage=6, mean_read_len=1000,
    min_read_len=400, error_rate=0.03, indel_rate=0.0, snv_rate=0.002,
    hotspots=1, hotspot_rate=0.1, hotspot_width=1200, read_len_spread=0.2,
)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _eq(a, b, what=""):
    """Exact equality of nested outputs: arrays, dataclasses, containers."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(a):
            _eq(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _eq(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        assert a == b, (what, a, b)


def _host_chain(pkg: str) -> dict:
    """The host stages of the main path on one package: simulate, seed,
    normalise and bucket, filter, build / reduce / clean the string graph,
    contract it, find bubbles and chains."""
    sim = _mod(pkg, "sim")
    seeding = _mod(pkg, "overlap.seeding")
    engine = _mod(pkg, "overlap.engine")
    filt = _mod(pkg, "filter")
    graph = _mod(pkg, "graph")
    build = _mod(pkg, "graph.build")
    pop = _mod(pkg, "graph.pop")
    transitive = _mod(pkg, "graph.transitive")
    bubbles = _mod(pkg, "bubbles")
    bubbles_linear = _mod(pkg, "bubbles_linear")
    out: dict = {}

    rs, truth = sim.simulate_reads(**SIM)
    out["sim"] = (rs, truth)

    lengths = rs.lengths.astype(np.int32)
    cfg = engine.OverlapConfig()
    seeds = seeding.sort_seeds(seeding.extract_minimizers(rs.codes, lengths, cfg.seed))
    cands = seeding.match_seeds(seeds, lengths, cfg.seed, presorted=True)
    seeds_np = seeding.extract_minimizers(rs.codes, lengths, cfg.seed, use_native=False)
    norm = engine._normalize_candidates(cands, lengths, cfg.band)
    out["seeding"] = (seeds, cands, seeds_np, norm, engine._bucket_edges(norm[-1], cfg),
                      engine._auto_blocks(rs.n_reads), engine._auto_blocks(90_000))

    table = sim.truth_alignments(rs, truth, min_overlap=300, cross_hap=True)
    table.win = np.random.default_rng(5).integers(0, 40, len(table)).astype(np.int32)
    chain = filt.FilterChain(
        [filt.MinReadLength(400), filt.MinOverlapLength(300),
         filt.AdaptiveErrorRate(1.25, 0.01), filt.MaxErrorRate(0.2), filt.ProperOverlapsOnly()],
        max_overhang_abs=600, max_overhang_ratio=0.8, window_filter=True,
        window_z=3.0, window_min_excess=6.0, post_filters=[filt.RelativeBestEnd(0.01, 0.15)],
    )
    ft, ftypes, contained = chain.apply(table, rs.lengths)
    e_read = filt.estimate_read_errors(table, rs.n_reads)
    dirty_rows = filt.window_excess_mask(ft, e_read, z=2.0, min_excess=4.0)
    out["filter"] = (ft, ftypes, contained, e_read, dirty_rows,
                     table.classify(rs.lengths), table.canonical_sort(), table.dedup())

    g = graph.build_string_graph(ft, ftypes, rs.lengths)
    dirty = build.edge_dirty_mask(g, ft, ftypes, dirty_rows)
    g1 = g.take_edges(~transitive.reduce_mask_np(g, 300, dirty))
    g2, n_chords = pop.cut_dirty_chords(g1, build.edge_dirty_mask(g1, ft, ftypes, dirty_rows))
    g3, removed = graph.remove_tips(g2, max_tip_len=4)
    g4, popped = graph.pop_error_bubbles(g3, aln=table, e_read=e_read)
    ug = graph.merge_unambiguous_paths(g4)
    ug2, n_cut = pop.cut_zipper_edges(ug, table, e_read, rs.n_reads)
    out["graph"] = (g, dirty, g1, g2, n_chords, g3, removed, g4, popped, ug, ug2, n_cut,
                    [ug.spell(u, rs) for u in range(ug.n_nodes)])

    sb = [bubbles.find_superbubbles(u) for u in (ug, *_fixture_graphs(pkg))]
    sb_lin = [bubbles_linear.find_superbubbles_linear(u) for u in (ug, *_fixture_graphs(pkg))]
    chains = [bubbles.build_chains(u, s) for u, s in zip((ug, *_fixture_graphs(pkg)), sb)]
    paths = [
        bubbles.enumerate_paths(u, b, max_paths=16)
        for u, cs in zip((ug, *_fixture_graphs(pkg)), chains) for c in cs for b in c.bubbles
    ]
    out["bubbles"] = (sb, sb_lin, chains, paths)
    return out


def _fixture_graphs(pkg: str):
    """The phasing tests' bubble-chain unitig graphs, as the package's own
    UnitigGraph (fields copied)."""
    cls = _mod(pkg, "graph.unitigs").UnitigGraph
    ugs = (chain_fixture(n_arms=3)[0], many_chains_fixture(3, n_bubbles=3, vary=True)[0])
    return [cls(**{f.name: getattr(u, f.name) for f in dataclasses.fields(u)}) for u in ugs]


@pytest.fixture(scope="module")
def runs():
    return {pkg: _host_chain(pkg) for pkg in PKGS}


@pytest.mark.parametrize("stage", ["sim", "seeding", "filter", "graph", "bubbles"])
def test_host_chain_matches_reference(runs, stage):
    """simulate_reads arrays and truth; seeding candidates (native and
    numpy); normalisation and buckets; filter classes and masks; string
    graph build, vetoed reduction, chords, tips, pop, unitigs, zippers;
    superbubbles (both finders), chains and arm paths."""
    _eq(runs["phasm_tpu"][stage], runs["phasm_tpu_torch"][stage], stage)


def _eval(pkg):
    sim = _mod(pkg, "sim")
    _, truth = sim.simulate_reads(**SIM)
    rng = np.random.default_rng(2)
    h0, h1 = truth.haplotypes[0], truth.haplotypes[1]
    result = types.SimpleNamespace(
        haplotigs=[("h0", sim.mutate_read(rng, h0[500:3500], 0.01)), ("h1", h1[1000:5200])],
        contigs=[("c0", h0[3000:5800])],
    )
    return _mod(pkg, "eval").evaluate_assembly(result, truth)


def _polish(pkg):
    sim = _mod(pkg, "sim")
    _, truth = sim.simulate_reads(**SIM)
    rng = np.random.default_rng(3)
    genome = truth.haplotypes[0][:2400]
    draft = sim.mutate_read(rng, genome, 0.04)
    offs = list(range(0, 1800, 150))
    mems = [sim.mutate_read(rng, genome[o:o + 600], 0.05) for o in offs]
    return _mod(pkg, "native").polish_native(draft, mems, offs, band=64, min_cov=3, iters=2)


def _fasta(pkg, tmp_path):
    fasta = _mod(pkg, "io.fasta")
    dna = _mod(pkg, "dna")
    rs, _ = _mod(pkg, "sim").simulate_reads(**SIM)
    path = str(tmp_path / f"{pkg}.fa")
    fasta.write_fasta(path, [(rs.names[i], rs.oriented_str(2 * i + 1)) for i in range(rs.n_reads)])
    back = fasta.read_fasta(path)
    return (open(path).read(), back, back.oriented_codes_matrix(), back.packed_2bit(),
            dna.revcomp(rs.codes[0, : rs.lengths[0]]))


def _sim_table(pkg):
    """SIM's reads and its truth alignments (cross-haplotype rows too), with
    a seeded ``win`` column."""
    sim = _mod(pkg, "sim")
    rs, truth = sim.simulate_reads(**SIM)
    table = sim.truth_alignments(rs, truth, min_overlap=300, cross_hap=True)
    table.win = np.random.default_rng(5).integers(0, 40, len(table)).astype(np.int32)
    return rs, table


def _daligner(pkg, tmp_path):
    """LAdump, .npz and PAF round trips of SIM's truth table, and a DBdump
    stream of its reads parsed back."""
    daligner = _mod(pkg, "io.daligner")
    rs, table = _sim_table(pkg)
    base = str(tmp_path / pkg)
    daligner.write_ladump(base + ".las", table)
    with open(base + ".las") as fh:
        parsed = daligner.parse_local_alignments(fh)
    daligner.save_table_npz(base + ".npz", table)
    daligner.write_paf(base + ".paf", table, rs.lengths)
    dbdump = [f"R {i + 1}\nS {rs.lengths[i]} {rs.oriented_str(2 * i)}\n" for i in range(rs.n_reads)]
    return (open(base + ".las").read(), open(base + ".paf").read(), parsed,
            daligner.load_table_npz(base + ".npz"), daligner.read_paf(base + ".paf"),
            daligner.parse_reads("".join(dbdump).splitlines()))


def _gfa(pkg, tmp_path):
    """GFA2 of SIM's string graph (reduced, tips cut, every 7th read's rows
    dropped so that the file leaves reads out), read back and remapped onto
    the read set; its unitig graph's GFA2."""
    gfa = _mod(pkg, "io.gfa")
    graph = _mod(pkg, "graph")
    rs, table = _sim_table(pkg)
    drop = np.arange(0, rs.n_reads, 7)
    table = table.take(~np.isin(table.a_id, drop) & ~np.isin(table.b_id, drop))
    g = graph.build_string_graph(table, table.classify(rs.lengths), rs.lengths)
    g, _ = graph.remove_tips(graph.remove_transitive_edges(g, fuzz=300), max_tip_len=4)
    base = str(tmp_path / pkg)
    gfa.write_gfa2(base + ".gfa2", g, rs)
    gfa.write_gfa2(base + ".bare.gfa2", g, rs, sequences=False)
    back, seg_reads = gfa.read_gfa2(base + ".gfa2")
    ug = graph.merge_unambiguous_paths(g)
    gfa.write_gfa2_unitigs(base + ".unitigs.gfa2", ug, rs)
    return (open(base + ".gfa2").read(), open(base + ".bare.gfa2").read(),
            open(base + ".unitigs.gfa2").read(), back, seg_reads,
            gfa.remap_node_ids(back, seg_reads.names, rs), g.n_nodes // 2 - seg_reads.n_reads)


def _ladder(pkg):
    return [dataclasses.asdict(c) for c in _mod(pkg, "configs").ladder()]


def _defaults(pkg):
    return [
        dataclasses.asdict(_mod(pkg, "overlap.engine").OverlapConfig()),
        dataclasses.asdict(_mod(pkg, "pipeline").PipelineConfig()),
        dataclasses.asdict(_mod(pkg, "phasing").PhaseConfig()),
        _mod(pkg, "overlap.engine")._MAX_BATCH,
        [f.name for f in dataclasses.fields(_mod(pkg, "overlap.extend").ExtendResult)],
        _mod(pkg, "native")._ABI_VERSION,
    ]


@pytest.mark.parametrize(
    "case", ["eval", "polish", "fasta", "daligner", "gfa", "ladder", "defaults"]
)
def test_host_module_matches_reference(case, tmp_path):
    """evaluate_assembly columns; native pileup polish on a small pileup
    (each package's own build of the library); FASTA round trip and DNA
    helpers; LAdump / .npz / PAF / DBdump and GFA2 interop; the evaluation
    ladder; config defaults and ABI version."""
    fn = {"eval": _eval, "polish": _polish, "fasta": lambda p: _fasta(p, tmp_path),
          "daligner": lambda p: _daligner(p, tmp_path), "gfa": lambda p: _gfa(p, tmp_path),
          "ladder": _ladder, "defaults": _defaults}[case]
    ref, port = fn("phasm_tpu"), fn("phasm_tpu_torch")
    if case == "polish":
        assert ref is not None and port is not None and port.shape[0] > 2000
    if case == "fasta":  # file names differ by package; the text must not
        assert ref[0] == port[0]
        ref, port = ref[1:], port[1:]
    _eq(ref, port, case)


# the (W, J) grid of test_torch_extend.test_routing_matches_reference_predicates
GRID = [(W, J) for W in (20, 64, 96, 128, 200, 256, 512, 1024)
        for J in (1024, 2048, 4096, 8192, 12288, 16384)]


def test_routing_predicates_match_reference():
    from phasm_tpu.overlap import myers_pallas as MP
    from phasm_tpu_torch.overlap import routing as R

    for W, J in GRID:
        assert R.tab2_fits(W, J) == MP.tab2_fits(W, J), (W, J)
        assert R.kernel_vmem_bytes(W, J) == MP.kernel_vmem_bytes(W, J), (W, J)
        assert R.blk_rows(W, J) == MP.blk_rows(W, J), (W, J)
        for rows in (8, 16):
            assert R.kernel_vmem_bytes_tab2(W, J, rows) == MP.kernel_vmem_bytes_tab2(W, J, rows)


def test_copied_constants_match_reference():
    from phasm_tpu.overlap import extend as E
    from phasm_tpu.overlap import myers as M
    from phasm_tpu.overlap import myers_pallas as MP
    from phasm_tpu_torch.overlap import extend as X
    from phasm_tpu_torch.overlap import myers as TM
    from phasm_tpu_torch.overlap import routing as R

    assert (X.BIG, X.BIGK, X.WINDOW) == (E.BIG, E.BIGK, E.WINDOW)
    assert X.BIG.dtype == E.BIG.dtype
    assert (X.MYERS_MAX_BAND, X.MYERS_VMEM_BUDGET, X.PALLAS_MAX_BAND) == (
        E.DeviceExtender.MYERS_MAX_BAND, E.DeviceExtender.MYERS_VMEM_BUDGET,
        E.DeviceExtender.PALLAS_MAX_BAND,
    )
    assert (TM.WB, TM.MBIG, TM.BK, TM.BKB, TM.JWMAX) == (M.WB, M.MBIG, M.BK, M.BKB, M.JWMAX)
    assert (R.VMEM_BUDGET, TM.BKB) == (MP.VMEM_BUDGET, MP.BKB2)
    d0 = np.arange(-70, 300, 7)
    for W, J in GRID:
        assert (TM.K_of(W), TM.rev_K(W)) == (M.K_of(W), M.rev_K(W))
        assert TM.tab2_geometry(W, J) == M.tab2_geometry(W, J)
        assert np.array_equal(TM.fwd_anchor(d0, W), M.fwd_anchor(d0, W))
        assert np.array_equal(
            TM.rev_anchor(d0 + 500, d0 + 480, d0, W), M.rev_anchor(d0 + 500, d0 + 480, d0, W)
        )
