"""End-to-end assembly on the port: filter -> layout -> phase -> polish.

Twin of ``phasm_tpu.pipeline.assemble`` / ``_polish_round2`` with three
device calls swapped for the port's: transitive reduction
(``graph.transitive``), the phasing scorer (``phasing.phase_all``) and the
round-2 placement overlap (``overlap.myers_cuda.myers_overlap_batch``,
Myers at ``round2_band`` and any J).  Every host stage is the reference's.

Deliberate differences, both so that a failure is not hidden: the
reference catches any exception in polish round 2 and keeps the round-1
output, and keeps the unpolished draft when the native polish returns None
(library missing or a failed call); here both raise.
"""
from __future__ import annotations

import logging

import numpy as np

from phasm_tpu import metrics
from phasm_tpu.alignments import AlignmentTable
from phasm_tpu.bubbles import build_chains
from phasm_tpu.bubbles_linear import find_superbubbles_linear
from phasm_tpu.filter import (
    AdaptiveErrorRate,
    FilterChain,
    MaxErrorRate,
    MinOverlapLength,
    MinReadLength,
    ProperOverlapsOnly,
    RelativeBestEnd,
    estimate_read_errors,
    window_excess_mask,
)
from phasm_tpu.graph import build_string_graph, merge_unambiguous_paths, pop_error_bubbles, remove_tips
from phasm_tpu.graph.build import edge_dirty_mask
from phasm_tpu.graph.pop import cut_dirty_chords, cut_zipper_edges
from phasm_tpu.overlap import seeding
from phasm_tpu.overlap.extend import BIG as XBIG
from phasm_tpu.phasing import refine_assignment_by_window_excess
from phasm_tpu.pipeline import AssemblyResult, PipelineConfig, _next_pow2
from phasm_tpu.reads import ReadSet

from phasm_tpu_torch.device import resolve_device
from phasm_tpu_torch.graph.transitive import remove_transitive_edges
from phasm_tpu_torch.overlap.myers_cuda import myers_overlap_batch
from phasm_tpu_torch.phasing import phase_all

log = logging.getLogger("phasm_tpu_torch.pipeline")


def _polish_round2(entries, reads: ReadSet, cfg: PipelineConfig, polish_fn, device):
    """Draft-guided placement of every read + second polish (twin of the
    reference's ``_polish_round2``): a mini overlap of the whole read set
    against the round-1 drafts (drafts chunked, reads in groups), best
    placement per (draft, read), haplotype exclusion by the window statistic
    within each chain, re-polish at the aligned offsets, then trim ends
    below ``round2_trim_cov``."""
    D = len(entries)
    drafts = [np.asarray(ent["seq"], dtype=np.uint8) for ent in entries]
    if not drafts:
        return
    LB = int(reads.codes.shape[1])
    read_max = int(reads.lengths.max())
    ov_slack = read_max + 4 * cfg.round2_band
    chunk = max(cfg.round2_chunk, 2 * ov_slack)
    step = chunk - ov_slack
    chunk_draft: list[int] = []
    chunk_begin: list[int] = []
    for i, s in enumerate(drafts):
        st = 0
        while True:
            chunk_draft.append(i)
            chunk_begin.append(st)
            if st + chunk >= len(s):
                break
            st += step
    C = len(chunk_draft)
    chunk_draft_a = np.asarray(chunk_draft, dtype=np.int64)
    chunk_begin_a = np.asarray(chunk_begin, dtype=np.int64)
    chunk_lens = np.minimum(
        chunk, np.array([len(drafts[d]) for d in chunk_draft], dtype=np.int64) - chunk_begin_a
    )
    L = max(int(chunk_lens.max()), LB)

    # read groups, sized by the reference's device-footprint rule: the
    # k-mer max_occ count is per group, so the group size is part of the
    # result and is kept exactly
    group = reads.n_reads
    while 6.0 * _next_pow2(2 * (C + group), 1) * L > cfg.round2_device_budget and group > 1024:
        group //= 2
        metrics.incr("polish2.read_group_halved")
    n_items_g = C + min(group, reads.n_reads)
    if float(n_items_g) * L > cfg.round2_max_bytes:
        metrics.incr("polish2.skipped_over_budget")
        log.warning(
            "polish round 2 skipped: dense code matrix would be %d x %d = "
            "%.1f GB (> round2_max_bytes=%.1f GB); round-1 pileup polish "
            "still applied",
            n_items_g, L, n_items_g * L / 1e9, cfg.round2_max_bytes / 1e9,
        )
        return

    scfg = seeding.SeedConfig()
    jmax = _next_pow2(read_max + 2 * cfg.round2_band, 1024)
    parts: list[tuple] = []  # (gdraft, gstart, b_global, strand, diffs, win)
    for r0 in range(0, reads.n_reads, group):
        r1 = min(r0 + group, reads.n_reads)
        ni = C + (r1 - r0)
        codes = np.zeros((ni, L), dtype=np.uint8)
        lengths = np.zeros(ni, dtype=np.int32)
        for c in range(C):
            cl = int(chunk_lens[c])
            b0 = int(chunk_begin_a[c])
            codes[c, :cl] = drafts[chunk_draft[c]][b0 : b0 + cl]
            lengths[c] = cl
        codes[C:, :LB] = reads.codes[r0:r1]
        lengths[C:] = reads.lengths[r0:r1]

        seeds = seeding.extract_minimizers(codes, lengths, scfg)
        cands = seeding.match_seeds(seeds, lengths, scfg)
        sel = (cands.a_id < C) & (cands.b_id >= C)
        a_id = cands.a_id[sel].astype(np.int64)
        b_id = cands.b_id[sel].astype(np.int64)
        strand_g = cands.strand[sel].astype(np.int64)
        d0 = cands.diag[sel].astype(np.int32)
        if a_id.shape[0] == 0:
            continue
        # oriented rows for the item set: drafts forward, reads both strands
        om = np.zeros((2 * ni, L), dtype=np.uint8)
        om[0::2] = codes
        src = lengths[:, None].astype(np.int64) - 1 - np.arange(L, dtype=np.int64)
        om[1::2] = np.where(
            src >= 0, 3 - codes[np.arange(ni)[:, None], np.clip(src, 0, L - 1)], 0
        )
        res = myers_overlap_batch(
            om, lengths, 2 * a_id, 2 * b_id + strand_g, d0,
            band=cfg.round2_band, jmax=jmax, device=device,
        )
        parts.append((
            chunk_draft_a[a_id],
            chunk_begin_a[a_id] + res.a_start.astype(np.int64),
            b_id - C + r0,
            strand_g,
            res.diffs.astype(np.int64),
            res.win_cost.astype(np.int64),
        ))
    if not parts:
        return
    gdraft, gstart, b_global, strand, diffs_all, win_all = (
        np.concatenate([p[i] for p in parts]) for i in range(6)
    )

    # best placement per (draft, read): lexicographic min of (diffs, win,
    # start, strand), sanity-capped error
    ok = diffs_all < XBIG
    err = diffs_all / np.maximum(reads.lengths[b_global], 1)
    ok &= err <= cfg.round2_max_err
    oki = np.nonzero(ok)[0]
    placed = [([], []) for _ in entries]
    if oki.shape[0]:
        order = np.lexsort((
            strand[oki], gstart[oki], win_all[oki],
            diffs_all[oki], b_global[oki], gdraft[oki],
        ))
        s = oki[order]
        first = np.ones(s.shape[0], dtype=bool)
        first[1:] = (gdraft[s[1:]] != gdraft[s[:-1]]) | (b_global[s[1:]] != b_global[s[:-1]])
        best = s[first]
        di_b, ri_b, wn_b = gdraft[best], b_global[best], win_all[best]
        # haplotype exclusion within each chain: win vs the chain-best
        chain_of = np.array([ent["ci"] for ent in entries], dtype=np.int64)
        ck = chain_of[di_b] * reads.n_reads + ri_b
        bw = np.full(int(chain_of.max() + 1) * reads.n_reads, 1 << 30, dtype=np.int64)
        np.minimum.at(bw, ck, wn_b)
        keep = wn_b <= bw[ck] + cfg.round2_win_delta
        kept = best[keep]
        di_k = gdraft[kept]
        mems_k = 2 * b_global[kept] + strand[kept]
        offs_k = gstart[kept]
        bounds = np.searchsorted(di_k, np.arange(D + 1))
        for di in range(D):
            sl = slice(int(bounds[di]), int(bounds[di + 1]))
            placed[di] = ([int(m) for m in mems_k[sl]], [int(o) for o in offs_k[sl]])
        metrics.incr("polish2.reads_excluded", int((~keep).sum()))
    metrics.incr("polish2.reads_placed", sum(len(p[0]) for p in placed))

    for ei, ent in enumerate(entries):
        mems, offs = placed[ei]
        if not mems:
            continue
        # round-1 members that failed placement stay at scaled offsets
        scale = len(ent["seq"]) / max(ent["spell_len"], 1)
        mems0 = np.asarray(ent["mems"], dtype=np.int64)
        offs0 = np.asarray(ent["offs"], dtype=np.float64)
        if mems0.shape[0]:
            miss = ~np.isin(mems0 >> 1, np.asarray(mems, dtype=np.int64) >> 1)
            mems.extend(int(m) for m in mems0[miss])
            offs.extend(int(round(o * scale)) for o in offs0[miss])
            metrics.incr("polish2.unplaced_member_kept", int(miss.sum()))
        pre_len = len(ent["seq"])
        ent["seq"] = polish_fn(ent["seq"], mems, offs)
        # trim ends below consensus coverage
        mems_a = np.asarray(mems, dtype=np.int64)
        offs_a = np.asarray(offs, dtype=np.int64)
        rl2 = reads.lengths[mems_a >> 1].astype(np.int64)
        cov = np.zeros(pre_len + 1, dtype=np.int32)
        np.add.at(cov, np.clip(offs_a, 0, pre_len), 1)
        np.add.at(cov, np.clip(offs_a + rl2, 0, pre_len), -1)
        cov = np.cumsum(cov[:-1])
        good = np.nonzero(cov >= cfg.round2_trim_cov)[0]
        if good.shape[0] == 0:
            continue
        s = len(ent["seq"]) / max(pre_len, 1)
        t0 = int(good[0] * s)
        t1 = min(int((good[-1] + 1) * s) + 1, len(ent["seq"]))
        if t0 > 0 or t1 < len(ent["seq"]):
            metrics.incr("polish2.bases_trimmed", t0 + (len(ent["seq"]) - t1))
            ent["seq"] = ent["seq"][t0:t1]


def assemble(
    reads: ReadSet,
    alignments: AlignmentTable,
    cfg: PipelineConfig | None = None,
    device="cuda",
) -> AssemblyResult:
    """Run filter -> layout -> phase (-> polish) on an alignment table."""
    cfg = cfg or PipelineConfig()
    dev = resolve_device(device)
    stats: dict = {"n_reads": reads.n_reads, "n_alignments": len(alignments)}

    # ---- stage 1: filter ------------------------------------------------
    filters = [
        MinReadLength(cfg.min_read_length),
        MinOverlapLength(cfg.min_overlap_length),
        MaxErrorRate(cfg.max_error_rate),
        ProperOverlapsOnly(),
    ]
    if cfg.adaptive_error:
        filters.insert(2, AdaptiveErrorRate(cfg.adaptive_factor, cfg.adaptive_margin))
    post = []
    if cfg.best_end:
        post.append(RelativeBestEnd(cfg.best_end_margin_abs, cfg.best_end_margin_rel))
    chain = FilterChain(
        filters,
        max_overhang_abs=cfg.max_overhang_abs,
        max_overhang_ratio=cfg.max_overhang_ratio,
        window_filter=cfg.window_filter,
        window_z=cfg.window_z,
        window_min_excess=cfg.window_min_excess,
        post_filters=post,
    )
    with metrics.stage("pipeline.filter", alignments=len(alignments)):
        ft, types, contained = chain.apply(alignments, reads.lengths)
    stats["n_proper_overlaps"] = len(ft)
    stats["n_contained_reads"] = int(contained.sum())

    # ---- stage 2: layout ------------------------------------------------
    with metrics.stage("pipeline.layout"):
        g = build_string_graph(ft, types, reads.lengths)
        stats["edges_initial"] = g.n_edges
        dirty_edges = None
        if cfg.cut_zippers and ft.win is not None and len(ft):
            dirty_rows = window_excess_mask(
                ft, estimate_read_errors(alignments, reads.n_reads),
                z=cfg.zipper_z, min_excess=cfg.zipper_min_excess,
            )
            dirty_edges = edge_dirty_mask(g, ft, types, dirty_rows)
            stats["dirty_edges"] = int(dirty_edges.sum())
            metrics.incr("graph.dirty_edges", stats["dirty_edges"])
        g = remove_transitive_edges(
            g, fuzz=cfg.length_fuzz, impl=cfg.transitive_impl,
            dirty=dirty_edges, device=dev,
        )
        if dirty_edges is not None:
            g, n_chords = cut_dirty_chords(g, edge_dirty_mask(g, ft, types, dirty_rows))
            stats["dirty_chords_cut"] = n_chords
        stats["edges_after_reduction"] = g.n_edges
        g, removed = remove_tips(g, max_tip_len=cfg.max_tip_len)
        if cfg.pop_bubbles:
            g, popped = pop_error_bubbles(
                g, max_weak_reads=cfg.pop_max_weak_reads,
                dominance=cfg.pop_dominance,
                aln=alignments,
                e_read=estimate_read_errors(alignments, reads.n_reads),
                veto_z=cfg.zipper_z, veto_min_excess=cfg.zipper_min_excess,
            )
            g, removed2 = remove_tips(g, max_tip_len=cfg.max_tip_len)
            stats["bubble_reads_popped"] = int(popped.sum())
            removed = removed | popped | removed2
    stats["edges_after_tips"] = g.n_edges
    stats["tip_reads_removed"] = int(removed.sum())
    ug = merge_unambiguous_paths(g)
    if cfg.cut_zippers:
        ug, n_cut = cut_zipper_edges(
            ug, alignments, estimate_read_errors(alignments, reads.n_reads), reads.n_reads,
        )
        stats["zipper_edges_cut"] = n_cut
    stats["n_unitigs"] = ug.n_nodes

    # ---- stage 3: phase -------------------------------------------------
    bubbles = find_superbubbles_linear(ug)
    chains = build_chains(ug, bubbles)
    stats["n_bubbles"] = len(bubbles)
    stats["n_chains"] = len(chains)

    ev_keep = alignments.diffs <= cfg.evidence_max_error * np.maximum(
        alignments.overlap_length(), 1
    )
    evidence = alignments.take(ev_keep)
    with metrics.stage("pipeline.phase", chains=len(chains)):
        results = phase_all(ug, reads, evidence, chains, cfg.phase, device=dev)

    if cfg.refine_anchor_assignment and results:
        e_read_all = estimate_read_errors(alignments, reads.n_reads)
        for r in results:
            r.read_assignment = refine_assignment_by_window_excess(
                r.read_assignment, alignments, e_read_all, cfg.phase.ploidy,
                z=cfg.window_z, min_excess=cfg.window_min_excess,
            )

    elen_lookup = {(int(s), int(d)): int(e) for s, d, e in zip(ug.src, ug.dst, ug.elen)}

    def _polish(seq, mems, offs):
        if not cfg.polish:
            return seq
        from phasm_tpu import native

        out = native.polish_native(
            seq,
            [reads.oriented_seq(m) for m in mems],
            offs,
            band=cfg.polish_band,
            min_cov=cfg.polish_min_cov,
            iters=cfg.polish_iters,
        )
        if out is None:  # the reference keeps the unpolished draft here
            raise RuntimeError("native polish failed (phasm_tpu.native returned None)")
        return out

    hap_entries: list[dict] = []
    chain_nodes: set[int] = set()
    for ci, r in enumerate(results):
        for m, seq in enumerate(r.haplotigs):
            nodes = r.haplotype_paths[m]
            # split at phase breaks: each segment is one phase block
            segs = [nodes]
            if cfg.split_phase_blocks and r.phase_breaks:
                split_at = [nodes.index(r.chain.bubbles[bi].entrance) for bi in r.phase_breaks]
                starts = [0] + split_at
                ends = split_at + [len(nodes) - 1]
                segs = [nodes[s0 : e0 + 1] for s0, e0 in zip(starts, ends)]
            for si, seg_nodes in enumerate(segs):
                elens = [
                    elen_lookup[(seg_nodes[j], seg_nodes[j + 1])]
                    for j in range(len(seg_nodes) - 1)
                ]
                seg_seq = seq if len(segs) == 1 else ug.spell_path(seg_nodes, elens, reads)
                mems, offs = ug.walk_members(seg_nodes, elens)
                # haplotype-pure polish: drop reads assigned elsewhere
                assign = r.read_assignment
                keep = [
                    k for k, mm in enumerate(mems)
                    if (mm >> 1) not in assign or m in assign[mm >> 1]
                ]
                mems = [mems[k] for k in keep]
                offs = [offs[k] for k in keep]
                name = f"haplotig_c{ci}_h{m}" + (f"_b{si}" if len(segs) > 1 else "")
                # trim interior phase-block boundaries to the anchor midpoint
                trim0 = int(ug.length[seg_nodes[0]]) // 2 if si > 0 else 0
                trim1 = int(ug.length[seg_nodes[-1]]) // 2 if si < len(segs) - 1 else 0
                if trim0 + trim1 >= len(seg_seq) - 1:
                    trim0 = trim1 = 0
                hap_entries.append({
                    "ci": ci, "name": name, "spell_len": len(seg_seq),
                    "seq": _polish(seg_seq, mems, offs),
                    "mems": mems, "offs": offs,
                    "trim0": trim0, "trim1": trim1,
                })
        for nodes in r.haplotype_paths:
            chain_nodes.update(nodes)
            chain_nodes.update(int(ug.rc[n]) for n in nodes)
        for b in r.chain.bubbles:
            chain_nodes.update(b.interior)
            chain_nodes.update(int(ug.rc[n]) for n in b.interior)

    # unphased primary contigs: one orientation per remaining unitig pair,
    # all on one pseudo-chain for round-2 polish
    contig_entries: list[dict] = []
    emitted = set()
    contig_chain = 1 + max((e["ci"] for e in hap_entries), default=-1)
    for u in range(ug.n_nodes):
        if u in chain_nodes or u in emitted:
            continue
        emitted.add(u)
        emitted.add(int(ug.rc[u]))
        seq = ug.spell(u, reads)
        mems = [int(m) for m in ug.members[u]]
        offs = [int(o) for o in ug.offsets[u]]
        contig_entries.append({
            "ci": contig_chain, "name": f"contig_u{u}",
            "spell_len": len(seq), "seq": _polish(seq, mems, offs),
            "mems": mems, "offs": offs,
        })

    all_entries = hap_entries + contig_entries
    if cfg.polish and cfg.polish_round2 and all_entries:
        for _ in range(cfg.round2_iters):
            with metrics.stage(
                "pipeline.polish2",
                haplotigs=len(hap_entries), contigs=len(contig_entries),
            ):
                _polish_round2(all_entries, reads, cfg, _polish, dev)
    haplotigs = [
        (e["name"], e["seq"][e.get("trim0", 0) : len(e["seq"]) - e.get("trim1", 0)])
        for e in hap_entries
    ]
    contigs = [(e["name"], e["seq"]) for e in contig_entries]
    stats["n_haplotigs"] = len(haplotigs)
    stats["n_contigs"] = len(contigs)
    return AssemblyResult(
        unitigs=ug, chains=chains, phase_results=results,
        contigs=contigs, haplotigs=haplotigs, stats=stats,
    )
