#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (phasm_tpu_torch) on one card.

    python3 chip_smoke.py

1. environment: the card's name and power limit, torch / CUDA / nvcc /
   triton versions;
2. builds every CUDA kernel from phasm_tpu_torch/csrc (one nvcc per
   source, in parallel) and, beside it, the port's native host library;
3. holds each kernel against its plain PyTorch version on the card, on
   real candidate batches from the port's seeding: Myers forward and
   reverse on the c4 rung's J = 1024 / 4096 / 8192 buckets at band 64 and
   its J = 4096 bucket at band 128, and the W-band kernel 3 on the c3
   rung's whole J = 12288 bucket at band 64 and on c4 pairs at bands 256
   and 512 (kernel times: means of 30 launches). Every integer output must
   be equal; both times are printed per batch;
4. drives the main path once, ``phasm_tpu_torch.configs.run_rung`` on the
   c4 rung (200 kb diploid, 1,333 reads) on the card, with every launch
   count set to 0 just before and read just after, and holds its quality
   columns to the reference ladder's c4 row; prints the pairs and launches
   of every kernel shape it ran and, from phase 3's times, each kernel's
   sum over those launches of (card ms - bound ms);
5. drives the batch entry point ``overlap.extend.banded_overlap_cuda``
   (kernel 4) on c4's W = 64 and W = 128 J = 4096 buckets and c3's W = 64
   J = 12288 bucket, its launch count set to 0 just before and read just
   after; then holds it against ``banded_overlap_batch`` (the plain
   version) and kernel 4 against its plain version and against kernel 3 on
   the same pairs, exactly, with kernel 4's and kernel 3's (means of 30
   launches) and the plain version's times, and each batch's share of
   dead columns (past a's end: in min(J, lb) but not in the bound's live
   columns);
6. drives the Myers table tier ``overlap.myers_cuda.myers_compute_tab``
   (kernel 5, the window fetch, feeding the window-fed kernels 1 and 2) on
   c4's three buckets that the reference sends to its table tier (W = 64 at
   J = 4096 and 8192, W = 128 at J = 4096), its three launch counts set to 0
   just before and read just after; then holds it against ``myers_pair``
   (the resident kernels), kernel 5 against its plain gather, the
   window-fed kernels against the resident ones on every bucket and against
   their plain versions on the W = 64, J = 4096 bucket, exactly, with the
   kernels' times beside the resident kernels', kernel 5's bound (bytes)
   and the time of one torch indexing expression that cuts the same peq
   window out of a zero-padded table (``library_ms``);
7. drives the Myers tab2 tier ``overlap.myers_cuda.myers_compute_tab2``
   (kernels 1 and 2 in their tab2 bodies, which cut their windows out of
   the blocked table themselves: the slab body, several lanes a pair, while
   its warps fit the rule, one pair a thread above) on c4's W = 64 and
   W = 128 J = 1024 buckets, on c4's W = 64 pairs that fit J = 2048 and on
   c2's W = 64 J = 1024 bucket (64,070 pairs, over c2's own blocked table),
   its two launch counts set to 0 just before and read just after; then
   holds it against ``myers_pair`` and ``myers_compute_tab``, the windows
   the tab2 kernels cut (their plain cut) against the table tier's, and
   the tab2 kernels against the window-fed and resident kernels on every
   batch and their plain versions on c4 W = 64, J = 1024, exactly, with the
   kernels' times beside theirs, the body each batch ran, the reverse
   wrapper's column sort where it sorts, and the three entry points' wall
   times;
8. drives the staged CLI ``phasm_tpu_torch.cli.main`` on the card: on
   rungs c1 to c5, each rung's simulated reads written as FASTA (named as
   ``simulate`` names them), ``overlap --min-overlap <rung's> --device
   cuda``, its three launch counts set to 0 just before and read just
   after; each table's length must equal the reference ladder's
   ``n_alignments`` (``LADDER_r5.jsonl``), kernels 1 and 2 must have
   launched on every rung, and kernel 3 exactly on the rungs whose
   routing sends pairs to the W-band family (band 256 retries, J = 12288
   buckets; c2 has neither). On c4 the stage's .npz must equal
   ``overlap_reads`` run in process on the same reads, field for field
   (``win`` too), and its LAdump (``--out x.las``) parsed back must give
   the same 8 columns; then ``filter`` -> ``layout`` -> ``phase
   --read-assignment`` on the card, and ``phase`` again with ``--device
   cpu``: the two haplotig FASTA files and the two TSV files must be
   byte-equal;
9. drives the data-parallel overlap (``phasm_tpu_torch.parallel``): on
   c4's reads, ``overlap_reads(mesh=)`` and ``overlap_reads_blocked(mesh=,
   n_blocks=3)`` on meshes of 2 and 4 shards (distinct cards where
   ``torch.cuda.device_count()`` allows, else the visible cards in turn:
   ``cuda:0`` repeated on one card), each equal to the unsharded table
   (``as_matrix()`` and ``win``, 47,343 rows), with each call's host-clock
   wall and the launch counts of kernels 1 to 3 on the mesh; then a
   2-process ``torch.distributed`` job (this script run again with
   ``--dp-worker``, importing only the port; NCCL with one card a process
   where there are two cards, gloo with both processes on ``cuda:0``
   otherwise), each process printing the digests of its mesh and
   unsharded tables, all equal to this process's; then one warm c4
   ``overlap_reads`` inside ``metrics.device_trace``, whose trace must name
   kernels 1, 2 and 3, and the summed kernel time over the traced call (the
   device busy share of the overlap stage);
10. drives the port's ladder runner and headline bench: ``python -m
   phasm_tpu_torch.ladder --rungs c1 --strict --device cuda --out <tmp>``
   in a process of its own, whose c1 row must equal ``LADDER_r5.jsonl``'s
   in every shared column but the name, the backend and the times, with
   kernels 1 and 2 launched in both overlap calls; c6's (10 Mb, 25,000
   reads) and c7's (2 Mb diploid) overlap stage alone, ``overlap_reads``
   in this process with the launch counts set to 0 just before, each
   table exactly ``LADDER_r5``'s length (437,698 and 148,173) and the
   launches following the routing, and on c6 a warm call inside
   ``metrics.device_trace`` (its table equal to the cold one; the device
   busy share at the scale of the reference's workload); then ``python -m
   phasm_tpu_torch.bench`` in a process of its own, whose last line must
   name family ``myers`` with a positive rate, and whose ``#`` lines (the
   window-fed kernels' rate, versions, card) are printed.
   ``ladder_rows("c2,c5")`` (not in ``main``) holds the longer rungs'
   rows to ``LADDER_r5`` the same way.

Each kernel's bound is the larger of its integer operations over the
card's INT32 rate (SMs x 64 lanes x the maximum SM clock) and its bytes
over the published HBM rate, counted from the batch's own pair lengths
(the W-band kernels: over each pair's live columns, min(J, lb, la - d0 +
W/2), past which no band cell lies on a row of a).
Prints the kernels' JSON line, then the result line
``{"ok": true, "device": {...}}`` last.  Any failure exits non-zero and
prints no result line; so does a machine without a CUDA card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# the reference ladder's c4 row (LADDER_r5.jsonl) and the allowed shortfall
C4_REFERENCE = {"qc_kmer_identity": 0.9896, "qc_completeness": 0.9896}
# the reference ladder's n_alignments (LADDER_r5.jsonl): the overlap table's
# length, len(alignments) at the top of pipeline.assemble
LADDER_R5_ALIGNMENTS = {"c1": 11832, "c2": 118748, "c3": 44252, "c4": 47343, "c5": 53822}
QC_SLACK = 0.005
MIN_PURITY = 0.99

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "myers_fwd": ("phasm_tpu_torch/csrc/myers.cu", "phasm_tpu/overlap/myers_pallas.py:157"),
    "myers_rev": ("phasm_tpu_torch/csrc/myers.cu", "phasm_tpu/overlap/myers_pallas.py:450"),
    "wband": ("phasm_tpu_torch/csrc/wband.cu", "phasm_tpu/overlap/extend.py:1246"),
    "wband_dense": ("phasm_tpu_torch/csrc/wband.cu", "phasm_tpu/overlap/extend.py:363"),
    "myers_fwd_fetch": ("phasm_tpu_torch/csrc/myers_fetch.cu", "scripts/myers_dma_proto.py:24"),
    "myers_fwd_win": ("phasm_tpu_torch/csrc/myers.cu", "phasm_tpu/overlap/myers_pallas.py:157"),
    "myers_rev_win": ("phasm_tpu_torch/csrc/myers.cu", "phasm_tpu/overlap/myers_pallas.py:450"),
    "myers_fwd_tab2": ("phasm_tpu_torch/csrc/myers.cu",
                       "phasm_tpu/overlap/myers_pallas.py:157 (tab2=True)"),
    "myers_rev_tab2": ("phasm_tpu_torch/csrc/myers.cu",
                       "phasm_tpu/overlap/myers_pallas.py:450 (tab2=True)"),
}
# c4's (band, column bucket)s that the reference runs through its Myers
# table tier (myers_pallas_compute_tab): Myers-routed, rejected by tab2_fits
TAB_BUCKETS = ((64, 4096), (64, 8192), (128, 4096))
# the tab2 tier's batches, (rung, band, column bucket): c4's buckets that the
# reference runs through myers_pallas_compute_tab2 (tab2_fits), W = 64 at J
# = 2048, the widest J tab2 takes (c4's W = 64 pairs whose need fits it),
# and c2's W = 64 J = 1024 bucket (64,070 pairs), the densest rung's, which
# fills the card at one pair a thread
TAB2_BATCHES = (("c4", 64, 1024), ("c4", 128, 1024), ("c4", 64, 2048), ("c2", 64, 1024))

# integer ops per unit of work, counted from the kernel sources: the Myers
# word step (csrc/myers.cu word_step + select_eq) per band word and column;
# the W-band cell update per live band cell and column, for kernels 3 and 4
# alike: the fewest the recurrence needs, their shared body as written
# (csrc/wband.cu wband_body: the substitution's compare and select, two
# fused add-mins for the diagonal / up candidate and the in-lane left chain,
# one three-way min for the prefix and the BIG clamp)
MYERS_OPS_PER_WORD = 17
WBAND_OPS_PER_CELL = 5
# launches in each CUDA-event mean of kernels 1, 2 and 3 in phase 3 and of
# kernels 4 and 3 in phase 5 (two 5-launch means of one kernel on the same
# pairs once differed by 7 %)
MYERS_REPS = 30
WBAND_REPS = 30
# phase 5's batches: (rung, band, column bucket)
DENSE_BATCHES = (("c4", 64, 4096), ("c4", 128, 4096), ("c3", 64, 12288))
INT32_LANES_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
ROOT = os.path.dirname(os.path.abspath(__file__))
# the reference ladder's n_alignments (LADDER_r5.jsonl) of the two scale
# rungs, whose overlap stage alone phase 10 runs in process (kept apart from
# LADDER_R5_ALIGNMENTS: phase 8 writes each of those rungs' reads as FASTA)
SCALE_ALIGNMENTS = {"c6": 437698, "c7": 148173}
# the headline bench's metric on the card: W64 J2048 is tab2_fits, and the
# engine runs the resident kernels 1 and 2 there (family myers)
BENCH_METRIC = "overlap_alignments_per_sec_per_chip[cuda,production,myers,band64,j2048]"


def _say(*a):
    print(*a, flush=True)


def environment() -> None:
    from phasm_tpu_torch import bench

    _say(bench.card())  # the card's name and power limit, exactly as nvidia-smi gives them
    _say(f"versions: python {sys.version.split()[0]}, {bench.versions()}")


def int32_ops_per_s() -> float:
    """The card's INT32 issue rate: SMs x lanes x the maximum SM clock."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * INT32_LANES_PER_SM * float(mhz) * 1e6
    _say(f"bound rates: {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x {mhz} MHz = "
         f"{rate:.4g} int ops/s; HBM {HBM_BYTES_PER_S:.4g} B/s")
    return rate


def build() -> float:
    """The CUDA kernels (nvcc) and the native host library (g++), side by
    side; both raise when they cannot be built."""
    from concurrent.futures import ThreadPoolExecutor

    from phasm_tpu_torch import _build, native

    lib_was_built = not _build.library_path().exists()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        host = pool.submit(native.get_lib)
        _build.load()
        host.result()
    dt = time.perf_counter() - t0
    _say(f"kernel + native build: {dt:.2f} s ({'nvcc' if lib_was_built else 'cached'}) -> "
         f"{_build.build_info['path']}, {native.library_path()}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            _say("  ptxas:", line.strip())
    table = ptxas_table(_build.build_info["log"])
    checked = {k: v for k, v in table.items() if "wband" in k or "tab2" in k}
    _say("ptxas, W-band and tab2 kernels (registers, stack bytes, spill stores, spill loads):",
         json.dumps(checked))
    spilled = [k for k, v in checked.items() if (v[2] or 0) + (v[3] or 0) > 0]
    if spilled:
        raise AssertionError(f"W-band or tab2 kernels spill registers: {spilled}")
    return dt


def ptxas_table(log: str) -> dict:
    """{entry: [registers, stack bytes, spill store bytes, spill load bytes]}
    from nvcc's -Xptxas -v output.  The W-band and tab2 kernels are named
    with their template arguments: kernel 3 ``wband_kernel<lanes a pair,
    cells a lane>`` (full bands) and ``wband_masked_kernel<...>`` (narrower
    ones), kernel 4 ``wband_dense_kernel<cells a lane, fast>``, the tab2
    kernels ``myers_{fwd,rev}_tab2_kernel<K>`` (one pair a thread) and
    ``myers_{fwd,rev}_tab2_slab_kernel<K, M>`` (M band words a lane,
    ceil(K / M) lanes a pair); the others keep their mangled names."""
    import re

    table, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            w = re.search(r"\d+((?:wband|myers)_\w*?kernel)I((?:L[ib]\d+E)+)E", entry)
            if w:
                entry = f"{w.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', w.group(2)))}>"
            table[entry] = [None, None, None, None]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            table[entry][1:] = [int(g) for g in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            table[entry][0] = int(m.group(1))
    return table


def _candidates(rung, band: int):
    """Kernel-frame candidates of a rung's read set: the port engine's
    seeding + _normalize_candidates.  Returns (reads, ka, kb, kd, la, lb)."""
    import numpy as np

    from phasm_tpu_torch.overlap import seeding
    from phasm_tpu_torch.overlap.engine import _normalize_candidates
    from phasm_tpu_torch.sim import simulate_reads

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

    from phasm_tpu_torch.overlap.engine import _bucket_edges

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


def _cols(lb, J: int):
    """Columns each pair runs: the kernels stop at min(J, lb)."""
    import torch

    return torch.clamp(lb.long(), max=J)


def _bound(ops: float, nbytes: float, int_rate: float) -> dict:
    t_ops, t_bytes = ops / int_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(
        bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        ops=ops, bytes=nbytes,
    )


def myers_fwd_bound(reads, b_oid, W: int, J: int, int_rate: float) -> dict:
    """K words x 17 ops per column; bytes: the b codes, one 16-byte
    match-mask word per window word per 32 columns, 12 bytes of indices in
    and 16 of results out per pair."""
    from phasm_tpu_torch.overlap.myers import K_of

    cols = _cols(reads.lengths[b_oid.long() >> 1], J)
    K = K_of(W)
    blocks = (cols + 31) // 32
    nbytes = int(cols.sum()) + 16 * int((blocks + K - 1).clamp(min=0).sum()) + 28 * cols.numel()
    return _bound(MYERS_OPS_PER_WORD * K * int(cols.sum()), nbytes, int_rate)


def myers_rev_bound(jend, W: int, J: int, int_rate: float) -> dict:
    """rev_K words x 17 ops per column over each pair's jend columns; two
    16-byte words per window word per 32 columns (the funnel join)."""
    from phasm_tpu_torch.overlap.myers import rev_K

    cols = _cols(jend, J)
    K = rev_K(W)
    blocks = (cols + 31) // 32
    nbytes = int(cols.sum()) + 32 * int((blocks * K).sum()) + 28 * cols.numel()
    return _bound(MYERS_OPS_PER_WORD * K * int(cols.sum()), nbytes, int_rate)


def wband_cols(la, lb, d0, W: int, J: int):
    """The columns the W-band function needs for each pair: min(J, lb,
    la - d0 + W/2), at least 0.  Past column la - d0 + W/2 - 1 every band
    cell lies on a row past la: it is never valid, so no endpoint fires and
    no window mark counts there (kernels 3 and 4 stop each pair there)."""
    import torch

    live = la.long() - d0.long() + W // 2
    return torch.minimum(_cols(lb, J), live).clamp(min=0)


def dead_col_share(la, lb, d0, W: int, J: int) -> float:
    """The share of min(J, lb) columns, summed over the pairs, that lie past
    a's end (not in ``wband_cols``)."""
    run = int(_cols(lb, J).sum())
    return 1.0 - int(wband_cols(la, lb, d0, W, J).sum()) / run if run else 0.0


def wband_bound(la, lb, d0, W: int, J: int, int_rate: float) -> dict:
    """W cells x WBAND_OPS_PER_CELL ops per live column (``wband_cols``);
    bytes: one a and one b code per live column plus the band's first W a
    codes, 12 bytes in and 20 out per pair.  Also gives the batch's
    ``dead_col_share``."""
    cols = wband_cols(la, lb, d0, W, J)
    nbytes = 2 * int(cols.sum()) + (W + 32) * cols.numel()
    return dict(_bound(WBAND_OPS_PER_CELL * W * int(cols.sum()), nbytes, int_rate),
                dead_col_share=dead_col_share(la, lb, d0, W, J))


def fetch_bound(tables, a_oid, b_oid, sfw, W: int, J: int) -> dict:
    """Kernel 5 computes nothing.  Bytes: each window written once (NBLK *
    16 + J/4 a pair), each table word it reads read once (the union of the
    pairs' in-row peq windows, 4 planes of 4 bytes a word, and the first
    min(J/16, BW) packed b words of each b row), 12 bytes of indices a pair.
    ``per_pair_bytes`` counts every pair's window as read too."""
    import torch

    from phasm_tpu_torch.overlap.myers import K_of

    B, NBLK, JW = a_oid.shape[0], J // 32 + K_of(W), J // 16
    n_o, _, PW = tables.peq.shape
    # in-row window words per table row: +1 at each window's start, -1 past its end
    marks = torch.zeros(n_o * (PW + 1), dtype=torch.int64, device=a_oid.device)
    base, s = a_oid.long() * (PW + 1), sfw.long()
    ones = torch.ones_like(base)
    marks.index_add_(0, base + s.clamp(0, PW), ones)
    marks.index_add_(0, base + (s + NBLK).clamp(0, PW), -ones)
    peq_words = int((marks.view(n_o, PW + 1).cumsum(1) > 0).sum())
    b_words = min(JW, tables.bpk.shape[2]) * torch.unique(b_oid).numel()
    per_pair = B * (2 * (NBLK * 16 + JW * 4) + 12)
    rec = _bound(0, B * (NBLK * 16 + JW * 4 + 12) + 16 * peq_words + 4 * b_words, 1.0)
    return dict(rec, per_pair_bytes=per_pair, per_pair_bound_ms=per_pair / HBM_BYTES_PER_S * 1e3)


def myers_win_bound(lens, K: int, J: int, out_bytes: int, int_rate: float) -> dict:
    """The window-fed kernels: K words x 17 ops per column; bytes: the
    window words the pair's columns consume (4 planes x 4 bytes per word
    per 32-column block), 8 bytes of packed b per block, 12 bytes of
    per-pair inputs and out_bytes of results."""
    cols = _cols(lens, J)
    blocks = (cols + 31) // 32
    nbytes = (16 * int((blocks + K - 1).clamp(min=0).sum()) + 8 * int(blocks.sum())
              + (12 + out_bytes) * cols.numel())
    return _bound(MYERS_OPS_PER_WORD * K * int(cols.sum()), nbytes, int_rate)


def tab2_fwd_bound(lb, W: int, J: int, int_rate: float) -> dict:
    """Tab2 kernel 1: K words x 17 ops per column; bytes: the words each
    pair loads, one 16-byte table word (four planes) per window word it
    reads (K, then one a block), 8 bytes of packed b a block, 20 bytes of
    indices and lengths in and 16 of results out."""
    from phasm_tpu_torch.overlap.myers import K_of

    K = K_of(W)
    cols = _cols(lb, J)
    blocks = (cols + 31) // 32
    words = K + (blocks - 1).clamp(min=0)
    nbytes = 16 * int(words.sum()) + 8 * int(blocks.sum()) + 36 * cols.numel()
    return _bound(MYERS_OPS_PER_WORD * K * int(cols.sum()), nbytes, int_rate)


def tab2_rev_bound(jend, m0r, W: int, J: int, int_rate: float) -> dict:
    """Tab2 kernel 2: rev_K words x 17 ops per column, plus its cut's
    funnel shifts (csrc/myers.cu funnel_eq: 4 per window word at or above
    the reversed prefix, 2 per block of packed codes); bytes: each 16-byte
    table word a pair's windows span read once (window word k is funnelled
    from table words k and k + 1, so n words need n + 1; words k < -m0r are
    0, not loaded), two packed flip-b words a block and one more for the
    bit offset, 20 bytes in and 8 out per pair."""
    from phasm_tpu_torch.overlap.myers import rev_K

    K = rev_K(W)
    cols = _cols(jend, J)
    blocks = (cols + 31) // 32
    words = K + (blocks - 1).clamp(min=0)
    loaded = (words - (-m0r.long()).clamp(min=0)).clamp(min=0)
    spans = int((loaded + (loaded > 0).long()).sum())
    nbytes = 16 * spans + 8 * int(blocks.sum()) + 32 * cols.numel()
    ops = MYERS_OPS_PER_WORD * K * int(cols.sum()) + 4 * int(loaded.sum()) + 2 * int(blocks.sum())
    return _bound(ops, nbytes, int_rate)


def _event_once(fn):
    """(result, CUDA-event ms) of one call."""
    import torch

    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _wall_ms(fn):
    """(result, host-clock ms of one call that ends in a device sync)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _warm_time(fn, reps: int = 5, warm: int = 3):
    """(result, mean ms of reps launches after warm calls): a fresh
    process's first calls still grow the caching allocator (the column
    sort's scratch) and meet the card's clocks ramping."""
    import torch

    for _ in range(warm):
        out = fn()
    torch.cuda.synchronize()
    return out, _time_ms(fn, reps)


def resident_myers_ms(reps: int = 30) -> dict:
    """Kernels 1 and 2 as the main path launches them, on phase 3's c4 Myers
    buckets: {label: [fwd ms, rev ms]}, each the mean of reps launches after
    three warm-up calls.  It uses only port APIs older than the table tier, so a copy
    of this script times an older tree on the same card (``compare_trees``
    runs the two in turns)."""
    from phasm_tpu_torch._build import index_tensors
    from phasm_tpu_torch.configs import ladder
    from phasm_tpu_torch.overlap import myers_cuda as MC
    from phasm_tpu_torch.state import DeviceReads

    c4 = next(r for r in ladder() if r.name.startswith("c4"))
    rs, ka, kb, kd, la, lb = _candidates(c4, 64)
    reads = DeviceReads.from_reads(rs, "cuda")
    out = {}
    for W, J in ((64, 1024), (64, 4096), (64, 8192), (128, 4096)):
        idx = _bucket(c4, ka, kd, la, lb, W, J)
        a, b, d = index_tensors(reads.device, ka[idx], kb[idx], kd[idx])
        fwd, ms_f = _warm_time(lambda: MC.myers_fwd(reads, a, b, d, W, J), reps)
        _, ms_r = _warm_time(lambda: MC.myers_rev(reads, a, b, d, fwd[1], fwd[2], W, J), reps)
        out[f"c4.W{W}.J{J}"] = [ms_f, ms_r]
    return out


def _dense_batch_pairs():
    """Phase 5's batches: [(tag, read set, ka, kb, kd, W, J)] from each
    rung's seeding, the pairs the engine puts into bucket J at band W."""
    from phasm_tpu_torch.configs import ladder

    rungs = {r.name.split("_")[0]: r for r in ladder()}
    batches = []
    for tag, W, J in DENSE_BATCHES:
        rung = rungs[tag]
        rs, ka, kb, kd, la, lb = _candidates(rung, W)
        idx = _bucket(rung, ka, kd, la, lb, W, J)
        batches.append((tag, rs, ka[idx], kb[idx], kd[idx], W, J))
    return batches


def wband_ms(reps: int = 30) -> dict:
    """Kernel 4 on phase 5's batches and kernel 3 on those and on phase 3's
    c4 W256 / W512 J4096 batches: {label: [ms]}, each the mean of reps
    launches after three warm-up calls.  It uses only port APIs as old as
    kernel 4, so a copy of this script times an older tree on the same card
    (``compare_trees``)."""
    from phasm_tpu_torch._build import index_tensors
    from phasm_tpu_torch.configs import ladder
    from phasm_tpu_torch.overlap import extend as X
    from phasm_tpu_torch.state import DeviceReads

    out, reads_of = {}, {}
    for tag, rs, ka, kb, kd, W, J in _dense_batch_pairs():
        a2, b2, la, lb = X.prepare_pair_tensors(rs.oriented_codes_matrix(), rs.lengths, ka, kb, kd, W, J)
        d = index_tensors(a2.device, kd)[0]
        _, ms = _warm_time(lambda: X.wband_dense(a2, b2, la, lb, d, W), reps)
        out[f"wband_dense.{tag}.W{W}.J{J}"] = [ms]
        reads = reads_of.setdefault(tag, DeviceReads.from_reads(rs, "cuda"))
        a, b, d3 = index_tensors(reads.device, ka, kb, kd)
        _, ms3 = _warm_time(lambda: X.wband(reads, a, b, d3, W, J), reps)
        out[f"wband.{tag}.W{W}.J{J}"] = [ms3]
    c4 = next(r for r in ladder() if r.name.startswith("c4"))
    rs, ka, kb, kd, la, lb = _candidates(c4, 64)
    reads = reads_of.get("c4") or DeviceReads.from_reads(rs, "cuda")
    for W in (256, 512):
        idx = _bucket(c4, ka, kd, la, lb, W, 4096)
        a, b, d = index_tensors(reads.device, ka[idx], kb[idx], kd[idx])
        _, ms3 = _warm_time(lambda: X.wband(reads, a, b, d, W, 4096), reps)
        out[f"wband.c4.W{W}.J4096"] = [ms3]
    return out


def compare_trees(*trees: str, reps: int = 30, timer: str = "resident_myers_ms") -> dict:
    """Kernels timed by ``timer(reps)`` in each tree (a directory holding a
    ``phasm_tpu_torch``, e.g. an older commit unpacked with ``git archive``
    into a git-ignored directory), one process each, in turns: the trees in
    order, then reversed (for two trees: parent, change, change, parent).
    This script is copied into each tree as ``_chip_smoke_timer.py``, so
    every tree is timed by the same code.  timer: ``resident_myers_ms``
    (kernels 1 and 2, [fwd ms, rev ms] a bucket), ``wband_ms`` (kernels 4
    and 3, [ms] a batch) or ``tab2_ms`` (tab2 kernels 1 and 2, [fwd ms, rev
    ms] a phase-7 batch).  Prints each run and returns {tree: {label: [ms
    means]}}."""
    import shutil

    runs: dict = {t: [] for t in trees}
    for tree in list(trees) + list(trees)[::-1]:
        shutil.copyfile(__file__, f"{tree}/_chip_smoke_timer.py")
        out = subprocess.run(
            [sys.executable, "-c", "import json, _chip_smoke_timer as c; "
             f"print('TIMES', json.dumps(c.{timer}({reps})))"],
            cwd=tree, capture_output=True, text=True, check=True,
        ).stdout
        times = json.loads(next(ln for ln in out.splitlines() if ln.startswith("TIMES"))[6:])
        runs[tree].append(times)
        _say(f"  {tree}: {json.dumps(times)}")
    means = {t: {b: [sum(r[b][i] for r in rs) / len(rs) for i in range(len(rs[0][b]))]
                 for b in rs[0]} for t, rs in runs.items()}
    _say("means:", json.dumps(means))
    return means


def kernel_checks(int_rate: float) -> dict:
    """Kernels 1-3 against their plain versions on real batches; returns
    {name: [case dicts]}.  Raises on any disagreement."""
    import torch

    from phasm_tpu_torch.configs import ladder
    from phasm_tpu_torch.overlap import extend as X
    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap import myers_cuda as MC
    from phasm_tpu_torch.overlap.routing import route
    from phasm_tpu_torch._build import index_tensors
    from phasm_tpu_torch.state import DeviceReads

    rungs = {r.name.split("_")[0]: r for r in ladder()}
    results: dict = {k: [] for k in KERNELS}

    def case(name, label, kernel_fn, plain_fn, B, W, J, bound, reps):
        got, ms = _warm_time(kernel_fn, reps)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        want = plain_fn()
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        err = _max_abs_err(got, want)
        rec = dict(case=label, pairs=B, W=W, J=J, ms=ms, plain_ms=plain_ms, max_abs_err=err, **bound)
        _say(f"  {name} {label}: pairs={B} W={W} J={J} kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
             f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), max_abs_err {err}")
        results[name].append(rec)
        if err != 0:
            raise AssertionError(f"{name} {label}: kernel disagrees with its plain version")

    c4 = rungs["c4"]
    rs4, ka, kb, kd, la, lb = _candidates(c4, 64)
    r4 = DeviceReads.from_reads(rs4, "cuda")
    _say(f"c4: {rs4.n_reads} reads, {ka.shape[0]} candidate pairs")
    for W, J in ((64, 1024), (64, 4096), (64, 8192), (128, 4096)):
        assert route("myers_pallas", W, J) == "myers", (W, J)
        idx = _bucket(c4, ka, kd, la, lb, W, J)
        a, b, d = index_tensors(r4.device, ka[idx], kb[idx], kd[idx])
        B = len(idx)
        fwd = MC.myers_fwd(r4, a, b, d, W, J)
        case("myers_fwd", f"c4.W{W}.J{J}", lambda: MC.myers_fwd(r4, a, b, d, W, J),
             lambda: plain.fwd_plain(r4.codes, r4.lengths, a, b, d, W, J), B, W, J,
             myers_fwd_bound(r4, b, W, J, int_rate), MYERS_REPS)
        ie, je = fwd[1], fwd[2]
        case("myers_rev", f"c4.W{W}.J{J}", lambda: MC.myers_rev(r4, a, b, d, ie, je, W, J),
             lambda: plain.rev_plain(r4.codes, r4.lengths, a, b, d, ie, je, W, J), B, W, J,
             myers_rev_bound(je, W, J, int_rate), MYERS_REPS)

    c3 = rungs["c3"]
    rs3, ka3, kb3, kd3, la3, lb3 = _candidates(c3, 64)
    r3 = DeviceReads.from_reads(rs3, "cuda")
    _say(f"c3: {rs3.n_reads} reads, {ka3.shape[0]} candidate pairs")
    cases = [(r3, c3, ka3, kb3, kd3, la3, lb3, 64, 12288, "c3")]
    cases += [(r4, c4, ka, kb, kd, la, lb, W, 4096, "c4") for W in (256, 512)]
    for reads, rung, ka_, kb_, kd_, la_, lb_, W, J, tag in cases:
        assert route("myers_pallas", W, J) == "wband", (W, J)
        idx = _bucket(rung, ka_, kd_, la_, lb_, W, J)
        a, b, d = index_tensors(reads.device, ka_[idx], kb_[idx], kd_[idx])
        case("wband", f"{tag}.W{W}.J{J}", lambda: X.wband(reads, a, b, d, W, J),
             lambda: X.wband_plain(reads.codes, reads.lengths, a, b, d, W, J),
             len(idx), W, J,
             wband_bound(reads.lengths[a.long() >> 1], reads.lengths[b.long() >> 1], d, W, J,
                         int_rate), WBAND_REPS)
    return results


def _zero_launches() -> None:
    """Set the main path's three launch counts to 0."""
    from phasm_tpu_torch.overlap import extend, myers_cuda

    myers_cuda.myers_fwd_launches = myers_cuda.myers_rev_launches = 0
    extend.wband_launches = 0


def _say_overlap_counters(label: str, counters: dict) -> dict:
    """Print the overlap engine's kernel families, wide-band retries and
    the wrappers' launch shapes from ``metrics`` counters; returns the
    shapes ({kernel.<name>.W<W>.J<J>[.launches]: value})."""
    _say(f"{label} kernel families:", json.dumps(
        {k: v for k, v in counters.items() if k.startswith("overlap.family.")}, sort_keys=True))
    _say(f"{label} wide-band retries:", json.dumps(
        {k: v for k, v in counters.items() if k.startswith("overlap.wide_band_retries")}, sort_keys=True))
    shapes = {k: v for k, v in sorted(counters.items()) if k.startswith("kernel.")}
    _say(f"{label} launch shapes (pairs; .launches):", json.dumps(shapes))
    return shapes


def main_path() -> tuple[dict, dict]:
    """c4 end to end on the card; returns (launch counts, {kernel.<name>.W.J
    counter: value}, the wrappers' pairs and launches per shape)."""
    from phasm_tpu_torch import configs, metrics

    c4 = next(r for r in configs.ladder() if r.name.startswith("c4"))
    metrics.reset()
    _zero_launches()
    row = configs.run_rung(c4, device="cuda")
    launches = configs.launch_counts()
    report = metrics.report()
    counters = report["counters"]
    _say("c4 row:", json.dumps(row, sort_keys=True))
    _say("c4 stage seconds:", json.dumps({k: row[k] for k in (
        "sim_s", "overlap_cold_s", "overlap_warm_s", "assemble_s", "eval_s")}))
    _say("c4 stage timers (host clock, both overlap calls summed):", json.dumps(
        {k: round(v, 3) for k, v in sorted(report["seconds"].items())}))
    shapes = _say_overlap_counters("c4", counters)
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
    return launches, shapes


def main_path_gap(checks: dict, shapes: dict) -> dict:
    """Per kernel of the main path, the sum over its c4 launches of (card ms
    - bound ms), from phase 3's batches: a launch of n pairs at (W, J) counts
    n / pairs of the phase-3 batch at (W, J) times that batch's gap.  A shape
    phase 3 did not time takes the batch of the same W with the nearest J,
    scaled by J / J_batch too, and is listed as such."""
    out = {}
    for name in ("myers_fwd", "myers_rev", "wband"):
        timed = {(r["W"], r["J"]): r for r in checks[name] if r["case"].startswith("c4")}
        total, untimed = 0.0, []
        for key, pairs in shapes.items():
            parts = key.split(".")
            if parts[1] != name or len(parts) != 4:
                continue
            W, J = int(parts[2][1:]), int(parts[3][1:])
            launches = int(shapes[key + ".launches"])
            rec = timed.get((W, J))
            scale = 1.0
            if rec is None:
                same_w = [r for (w, _), r in timed.items() if w == W] or list(timed.values())
                rec = min(same_w, key=lambda r: abs(r["J"] - J))
                scale = J / rec["J"]
                untimed.append(f"W{W}.J{J} ({launches} launches, {int(pairs)} pairs; "
                               f"from W{rec['W']}.J{rec['J']})")
            total += (rec["ms"] - rec["bound_ms"]) * pairs / rec["pairs"] * scale
        out[name] = dict(gap_ms=total, untimed=untimed)
    _say("c4 main path, sum over launches of (card ms - bound ms):", json.dumps(out))
    return out


def batch_entry_point(int_rate: float) -> tuple[dict, list]:
    """Kernel 4's path: ``banded_overlap_cuda`` from host arrays on real
    buckets, its launch count set to 0 just before and read just after;
    then the checks and timings on the same pairs.  Returns (launches,
    case dicts).  Raises on any disagreement."""
    import numpy as np
    import torch

    from phasm_tpu_torch.overlap import extend as X
    from phasm_tpu_torch.state import DeviceReads
    from phasm_tpu_torch._build import index_tensors

    batches = _dense_batch_pairs()
    X.wband_dense_launches = 0
    results = []
    for tag, rs, ka, kb, kd, W, J in batches:
        oriented, lengths = rs.oriented_codes_matrix(), rs.lengths
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = X.banded_overlap_cuda(oriented, lengths, ka, kb, kd, band=W, jmax=J)
        results.append((res, (time.perf_counter() - t0) * 1e3))  # ends in the device-to-host copy
    launches = {"wband_dense": X.wband_dense_launches}
    _say("batch entry point launches:", json.dumps(launches))
    if launches["wband_dense"] < len(batches):
        raise AssertionError("banded_overlap_cuda did not launch kernel 4 for every batch")

    fields = ("diffs", "a_start", "a_end", "b_end", "win_cost")
    cases = []
    for (tag, rs, ka, kb, kd, W, J), (res, wall_ms) in zip(batches, results):
        oriented, lengths = rs.oriented_codes_matrix(), rs.lengths
        label = f"{tag}.W{W}.J{J}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = X.banded_overlap_batch(oriented, lengths, ka, kb, kd, band=W, jmax=J)
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        entry_err = max(
            int(np.abs(getattr(res, f).astype(np.int64) - getattr(want, f).astype(np.int64)).max(initial=0))
            for f in fields
        )
        # kernel level on staged tensors: kernel 4, its plain version, kernel 3
        a2, b2, la, lb = X.prepare_pair_tensors(oriented, lengths, ka, kb, kd, W, J)
        d = index_tensors(a2.device, kd)[0]
        got, ms = _warm_time(lambda: X.wband_dense(a2, b2, la, lb, d, W), WBAND_REPS)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plain_out = X.wband_dense_plain(a2, b2, la, lb, d, W)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        reads = DeviceReads.from_reads(rs, "cuda")
        a, b, d3 = index_tensors(reads.device, ka, kb, kd)
        k3_out, k3_ms = _warm_time(lambda: X.wband(reads, a, b, d3, W, J), WBAND_REPS)
        err = max(entry_err, _max_abs_err(got, plain_out), _max_abs_err(got, k3_out))
        rec = dict(
            case=label, pairs=len(ka), W=W, J=J, ms=ms, plain_ms=plain_ms, wband_ms=k3_ms,
            entry_wall_ms=wall_ms, plain_entry_wall_ms=plain_wall_ms, max_abs_err=err,
            **wband_bound(la, lb, d, W, J, int_rate),
        )
        _say(f"  wband_dense {label}: pairs={len(ka)} kernel 4 {ms:.3f} ms, kernel 3 {k3_ms:.3f} ms, "
             f"plain {plain_ms:.1f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
             f"dead columns {rec['dead_col_share']:.4f} of min(J, lb); "
             f"entry point {wall_ms:.1f} ms wall (plain entry {plain_wall_ms:.1f} ms); "
             f"max_abs_err {err} (entry {entry_err})")
        cases.append(rec)
        if err != 0:
            raise AssertionError(f"wband_dense {label}: disagrees with its plain version or kernel 3")
    return launches, cases


def table_tier(int_rate: float) -> tuple[dict, dict]:
    """Kernel 5's path: ``myers_compute_tab`` on c4's table-tier buckets,
    its three launch counts set to 0 just before and read just after; then
    the checks and timings on the same pairs.  Returns (launches, {name:
    case dicts}).  Raises on any disagreement."""
    import torch

    from phasm_tpu_torch._build import index_tensors
    from phasm_tpu_torch.configs import ladder
    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap import myers_cuda as MC
    from phasm_tpu_torch.overlap.routing import route, tab2_fits
    from phasm_tpu_torch.state import DeviceReads, MyersTables

    c4 = next(r for r in ladder() if r.name.startswith("c4"))
    rs, ka, kb, kd, la, lb = _candidates(c4, 64)
    reads = DeviceReads.from_reads(rs, "cuda")
    tables, build_ms = _event_once(lambda: MyersTables.from_reads(reads))
    _say(f"c4 Myers tables: peq {list(tables.peq.shape)}, bpk {list(tables.bpk.shape)}, "
         f"{tables.nbytes} bytes, built in {build_ms:.1f} ms")
    batches = []
    for W, J in TAB_BUCKETS:
        assert route("myers_pallas", W, J) == "myers" and not tab2_fits(W, J), (W, J)
        idx = _bucket(c4, ka, kd, la, lb, W, J)
        batches.append((W, J, *index_tensors(reads.device, ka[idx], kb[idx], kd[idx])))

    MC.myers_fwd_fetch_launches = MC.myers_fwd_win_launches = MC.myers_rev_win_launches = 0
    entry = [  # (outputs, wall ms); the first call also loads torch's gather code
        _wall_ms(lambda: MC.myers_compute_tab(tables, reads.lengths, a, b, d, W, J))
        for W, J, a, b, d in batches
    ]
    launches = {k: getattr(MC, f"{k}_launches") for k in
                ("myers_fwd_fetch", "myers_fwd_win", "myers_rev_win")}
    _say("table tier launches:", json.dumps(launches))
    for name, n in launches.items():
        if n < len(batches):
            raise AssertionError(f"myers_compute_tab did not launch {name} for every batch")

    cases: dict = {k: [] for k in launches}
    for (W, J, a, b, d), (out, wall_ms) in zip(batches, entry):
        label, B = f"c4.W{W}.J{J}", a.shape[0]
        want, pair_ms = _wall_ms(lambda: MC.myers_pair(reads, a, b, d, W, J))
        _, warm_ms = _wall_ms(lambda: MC.myers_compute_tab(tables, reads.lengths, a, b, d, W, J))
        entry_err = _max_abs_err(out, want)

        # kernel 5, its plain gather, and one torch indexing expression
        m0 = plain.fwd_anchor(d, W)
        sfw = (m0 + plain.F_TAB).int()
        win, ms5 = _warm_time(lambda: MC.myers_fwd_fetch(tables, a, b, sfw, W, J), 20)
        win_plain, plain5 = _event_once(lambda: MC.myers_fwd_fetch_plain(tables, a, b, sfw, W, J))
        NBLK = J // 32 + plain.K_of(W)
        padded = torch.nn.functional.pad(tables.peq[:, :4], (0, NBLK))  # zero pad, untimed
        ai = a.long()[None, None, :]
        ci = torch.arange(4, device=reads.device)[None, :, None]
        si = sfw.long()[None, None, :]
        ki = torch.arange(NBLK, device=reads.device)[:, None, None]
        lib_out, lib_ms = _warm_time(lambda: padded[ai, ci, si + ki], 20)
        err5 = max(_max_abs_err(win, win_plain), _max_abs_err([win[0]], [lib_out]))

        # window-fed kernel 1 beside the resident kernel 1 on the same pairs
        la_t, lb_t = reads.lengths[a.long() >> 1], reads.lengths[b.long() >> 1]
        fw, ms_fw = _warm_time(lambda: MC.myers_fwd_win(la_t, lb_t, d, win[0], win[1], W, J))
        fr, ms_fr = _warm_time(lambda: MC.myers_fwd(reads, a, b, d, W, J))
        iend, jend = (fw[1] + 32 * m0).int(), fw[2]
        err_f = _max_abs_err((fw[0], iend, fw[2], fw[3]), fr)
        (peq_r, bpk_r, row_off), prep_ms = _event_once(lambda: plain.rev_prep_tab(
            tables.peq, tables.bpk, a, b, tables.LA, iend, jend, d, W, J))
        row_off = row_off.int()
        rw, ms_rw = _warm_time(lambda: MC.myers_rev_win(row_off, iend, jend, peq_r, bpk_r, W, J))
        rr, ms_rr = _warm_time(lambda: MC.myers_rev(reads, a, b, d, iend, jend, W, J))
        err_r = _max_abs_err(rw, rr)
        plain_f = plain_r = None
        if (W, J) == (64, 4096):  # the plain Myers core costs seconds a batch
            pf, plain_f = _event_once(
                lambda: plain.fwd_win_plain(la_t, lb_t, d, win[0], win[1], W, J))
            pr, plain_r = _event_once(
                lambda: plain.rev_win_plain(row_off, iend, jend, peq_r, bpk_r, W, J))
            err_f = max(err_f, _max_abs_err(fw, pf))
            err_r = max(err_r, _max_abs_err(rw, pr))
        cases["myers_fwd_fetch"].append(dict(
            case=label, pairs=B, W=W, J=J, ms=ms5, plain_ms=plain5, library_ms=lib_ms,
            max_abs_err=err5, entry_wall_ms=wall_ms, entry_warm_ms=warm_ms,
            myers_pair_wall_ms=pair_ms, rev_prep_tab_ms=prep_ms,
            **fetch_bound(tables, a, b, sfw, W, J)))
        cases["myers_fwd_win"].append(dict(
            case=label, pairs=B, W=W, J=J, ms=ms_fw, resident_ms=ms_fr, plain_ms=plain_f,
            max_abs_err=err_f, **myers_win_bound(lb_t, plain.K_of(W), J, 16, int_rate)))
        cases["myers_rev_win"].append(dict(
            case=label, pairs=B, W=W, J=J, ms=ms_rw, resident_ms=ms_rr, plain_ms=plain_r,
            max_abs_err=err_r, **myers_win_bound(jend, plain.rev_K(W), J, 8, int_rate)))
        _say(f"  table tier {label}: pairs={B}; entry point {wall_ms:.2f} ms wall (first call), "
             f"{warm_ms:.2f} ms (again) vs myers_pair {pair_ms:.2f} ms (max_abs_err {entry_err}); "
             f"kernel 5 {ms5:.4f} ms, plain {plain5:.3f} ms, one torch indexing expression "
             f"{lib_ms:.4f} ms, bound {cases['myers_fwd_fetch'][-1]['bound_ms']:.4f} ms (bytes; "
             f"{cases['myers_fwd_fetch'][-1]['per_pair_bound_ms']:.4f} ms counting every window read), "
             f"max_abs_err {err5}; rev_prep_tab {prep_ms:.3f} ms")
        _say(f"  table tier {label}: window-fed fwd {ms_fw:.3f} ms vs resident {ms_fr:.3f} ms, "
             f"rev {ms_rw:.3f} ms vs resident {ms_rr:.3f} ms; plain fwd {plain_f} ms, plain rev "
             f"{plain_r} ms; max_abs_err fwd {err_f}, rev {err_r}")
        if max(entry_err, err5, err_f, err_r) != 0:
            raise AssertionError(f"table tier {label}: disagrees with the resident path or a plain version")
    return launches, cases


def _tab2_batches():
    """Phase 7's batches: [(label, reads, blocked table, W, J, a, b, d)], each
    rung's read set and blocked table on the card (built once a rung), the
    pairs as device index vectors.  It uses only port APIs as old as the
    tab2 tier, so ``tab2_ms`` can time an older tree."""
    import numpy as np

    from phasm_tpu_torch._build import index_tensors
    from phasm_tpu_torch.configs import ladder
    from phasm_tpu_torch.overlap.routing import route, tab2_fits
    from phasm_tpu_torch.state import DeviceReads, MyersBlockedTables

    rungs = {r.name.split("_")[0]: r for r in ladder()}
    seeded, batches = {}, []
    for tag, W, J in TAB2_BATCHES:
        assert route("myers_pallas", W, J) == "myers" and tab2_fits(W, J), (W, J)
        if tag not in seeded:
            rs, ka, kb, kd, la, lb = _candidates(rungs[tag], 64)
            reads = DeviceReads.from_reads(rs, "cuda")
            seeded[tag] = (reads, MyersBlockedTables.from_reads(reads), ka, kb, kd, la, lb)
        reads, t2, ka, kb, kd, la, lb = seeded[tag]
        if J == 2048:  # no c4 bucket: the W = 64 pairs whose need fits
            idx = np.nonzero(np.minimum(lb, la - kd + W).astype(np.int64) + W <= J)[0]
        else:
            idx = _bucket(rungs[tag], ka, kd, la, lb, W, J)
        batches.append((f"{tag}.W{W}.J{J}", reads, t2, W, J,
                        *index_tensors(reads.device, ka[idx], kb[idx], kd[idx])))
    return batches


def tab2_ms(reps: int = 30) -> dict:
    """Tab2 kernels 1 and 2 on phase 7's batches: {label: [fwd ms, rev ms]},
    each the mean of reps launches after three warm-up calls, the reverse
    pass at the forward pass's ends.  It uses only port APIs as old as the
    tab2 tier, so a copy of this script times an older tree on the same card
    (``compare_trees``)."""
    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap import myers_cuda as MC

    out = {}
    for label, reads, t2, W, J, a, b, d in _tab2_batches():
        fw, ms_f = _warm_time(lambda: MC.myers_fwd_tab2(t2, reads.lengths, a, b, d, W, J), reps)
        iend, jend = (fw[1] + 32 * plain.fwd_anchor(d, W)).int(), fw[2]
        _, ms_r = _warm_time(lambda: MC.myers_rev_tab2(t2, a, b, d, iend, jend, W, J), reps)
        out[label] = [ms_f, ms_r]
    return out


def _tab2_variant_lib():
    """csrc/myers.cu built once more with ``-DPHASM_TAB2_FORCE``, for
    ``tab2_bodies_ms``: its ``phasm_tab2_force(L)`` makes every batch run one
    pair a thread (L = 1), the slab body at L lanes a pair (2..5) or the
    fixed rule (L = 0).  A measurement build only: the port's library has no
    such hook."""
    import ctypes

    from phasm_tpu_torch import _build

    out = _build.BUILD_DIR / "tab2_bodies"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libmyers_bodies.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DPHASM_TAB2_FORCE", "-shared", "-o", str(so),
                    str(_build._CSRC / "myers.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for name in ("phasm_myers_fwd_tab2", "phasm_myers_rev_tab2", "phasm_myers_tab2_lanes"):
        getattr(lib, name).argtypes = _build.ENTRIES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.phasm_tab2_force.argtypes = [ctypes.c_int]
    return lib


# tab2_bodies_ms's cuts of phase 7's batches, between the slab's and the
# thread body's measured wins: (batch, pairs kept)
TAB2_CUTS = (("c2.W64.J1024", 6000), ("c2.W64.J1024", 8000), ("c2.W64.J1024", 10000),
             ("c2.W64.J1024", 12000), ("c2.W64.J1024", 14000), ("c2.W64.J1024", 16000),
             ("c4.W64.J2048", 4000), ("c4.W64.J2048", 6000), ("c4.W64.J2048", 8000),
             ("c4.W64.J2048", 10000), ("c4.W64.J2048", 12000), ("c4.W64.J2048", 14000))


def tab2_bodies_ms(reps: int = 30) -> dict:
    """Both tab2 bodies on phase 7's batches and on TAB2_CUTS, the evidence
    for the entries' fixed body rule (not part of ``main``; about 4 min
    with the builds):
    {label: {...}} with, for tab2 kernels 1 and 2, the one-pair-a-thread
    body (the reverse pass in pair order, and in column order with the sort
    inside and alone), the slab body at 2..5 lanes a pair, and the slab's
    reverse pass on pairs already in column order; each the mean of reps
    launches after three warm-up calls, every output held equal to the
    thread body's."""
    import torch

    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap.extend import column_order

    lib = _tab2_variant_lib()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def fwd(t2, lengths, a, b, d, W, J):
        outs = torch.empty((4, a.shape[0]), dtype=torch.int32, device=a.device).unbind()
        assert lib.phasm_myers_fwd_tab2(
            a.data_ptr(), b.data_ptr(), d.data_ptr(), lengths.data_ptr(), t2.win.data_ptr(), t2.n_o,
            plain.blocked_counts(t2.LA)[0], a.shape[0], W, J, *(o.data_ptr() for o in outs),
            stream()) == 0
        return outs

    def rev(t2, a, b, d, ie, je, W, J, order=None):
        outs = torch.empty((2, a.shape[0]), dtype=torch.int32, device=a.device).unbind()
        if order is None:
            order = torch.arange(a.shape[0], device=a.device)
        NBb, NBc = plain.blocked_counts(t2.LA)
        assert lib.phasm_myers_rev_tab2(
            order.data_ptr(), a.data_ptr(), b.data_ptr(), d.data_ptr(), ie.data_ptr(), je.data_ptr(),
            t2.win.data_ptr(), t2.LA, t2.n_o, NBb, NBc, a.shape[0], W, J,
            *(o.data_ptr() for o in outs), stream()) == 0
        return outs

    import numpy as np

    batches = _tab2_batches()
    by_label = {bt[0]: bt for bt in batches}
    for label, n in TAB2_CUTS:  # seeded random subsets, kept in batch order
        _, reads, t2, W, J, a, b, d = by_label[label]
        keep = np.sort(np.random.default_rng(n).choice(a.shape[0], n, replace=False))
        keep = torch.from_numpy(keep).to(a.device)
        batches.append((f"{label}.cut{n}", reads, t2, W, J, a[keep], b[keep], d[keep]))
    out = {}
    for label, reads, t2, W, J, a, b, d in batches:
        r = {"pairs": a.shape[0]}
        lib.phasm_tab2_force(1)
        ref_f, r["fwd_thread"] = _warm_time(lambda: fwd(t2, reads.lengths, a, b, d, W, J), reps)
        iend, jend = (ref_f[1] + 32 * plain.fwd_anchor(d, W)).int(), ref_f[2]
        ref_r, r["rev_thread_pair_order"] = _warm_time(lambda: rev(t2, a, b, d, iend, jend, W, J), reps)
        _, r["rev_thread_sorted"] = _warm_time(
            lambda: rev(t2, a, b, d, iend, jend, W, J, column_order(jend, J)), reps)
        srt, r["sort"] = _warm_time(lambda: column_order(jend, J), reps)
        err = 0
        for L in (2, 3, 4, 5):
            lib.phasm_tab2_force(L)
            f, r[f"fwd_slab{L}"] = _warm_time(lambda: fwd(t2, reads.lengths, a, b, d, W, J), reps)
            v, r[f"rev_slab{L}"] = _warm_time(lambda: rev(t2, a, b, d, iend, jend, W, J), reps)
            err = max(err, _max_abs_err(f, ref_f), _max_abs_err(v, ref_r))
        lib.phasm_tab2_force(0)
        r["rule"] = [lib.phasm_myers_tab2_lanes(a.shape[0], W, J, rev_) for rev_ in (0, 1)]
        lib.phasm_tab2_force(r["rule"][1] if r["rule"][1] > 1 else 2)
        a2, b2, d2, i2, j2 = (t[srt].contiguous() for t in (a, b, d, iend, jend))
        _, r["rev_slab_presorted"] = _warm_time(lambda: rev(t2, a2, b2, d2, i2, j2, W, J), reps)
        lib.phasm_tab2_force(0)
        r["max_abs_err"] = err
        out[label] = r
        _say(f"  tab2 bodies {label}: {json.dumps(r)}")
        if err:
            raise AssertionError(f"tab2 bodies {label}: the bodies disagree")
    return out


def tab2_tier(int_rate: float) -> tuple[dict, dict]:
    """The tab2 tier: ``myers_compute_tab2`` on TAB2_BATCHES, its two launch
    counts set to 0 just before and read just after; then the checks and
    timings on the same pairs.  Returns (launches, {name: case dicts}).
    Raises on any disagreement."""
    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap import myers_cuda as MC
    from phasm_tpu_torch.overlap.extend import column_order
    from phasm_tpu_torch.state import MyersBlockedTables, MyersTables

    batches = _tab2_batches()
    tables = {}  # the table tier's tables, held beside it, a read set each
    for label, reads, t2, *_ in batches:
        if id(reads) not in tables:
            _, build_ms = _event_once(lambda: MyersBlockedTables.from_reads(reads))
            _say(f"{label.split('.')[0]} blocked table: win {list(t2.win.shape)} (n_o {t2.n_o}, "
                 f"LA {t2.LA}), {t2.nbytes} bytes, built in {build_ms:.1f} ms")
            tables[id(reads)] = MyersTables.from_reads(reads)

    MC.myers_fwd_tab2_launches = MC.myers_rev_tab2_launches = 0
    entry = []  # (outputs, wall ms) of each batch's first call
    for label, reads, t2, W, J, a, b, d in batches:
        before = (MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches)
        entry.append(_wall_ms(lambda: MC.myers_compute_tab2(t2, reads.lengths, a, b, d, W, J)))
        if (MC.myers_fwd_tab2_launches, MC.myers_rev_tab2_launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"myers_compute_tab2 {label} did not launch both tab2 kernels")
    launches = {"myers_fwd_tab2": MC.myers_fwd_tab2_launches,
                "myers_rev_tab2": MC.myers_rev_tab2_launches}
    _say("tab2 tier launches:", json.dumps(launches))

    cases: dict = {k: [] for k in launches}
    for (label, reads, t2, W, J, a, b, d), (out, wall_ms) in zip(batches, entry):
        B, tables_r = a.shape[0], tables[id(reads)]
        bodies = [MC.tab2_body(B, W, J, rev) for rev in (False, True)]
        want, pair_ms = _wall_ms(lambda: MC.myers_pair(reads, a, b, d, W, J))
        tab_out, tab_ms = _wall_ms(lambda: MC.myers_compute_tab(tables_r, reads.lengths, a, b, d, W, J))
        _, warm_ms = _wall_ms(lambda: MC.myers_compute_tab2(t2, reads.lengths, a, b, d, W, J))
        entry_err = max(_max_abs_err(out, want), _max_abs_err(out, tab_out))

        # tab2 kernel 1 beside the window-fed and resident kernel 1
        la_t, lb_t = reads.lengths[a.long() >> 1], reads.lengths[b.long() >> 1]
        m0 = plain.fwd_anchor(d, W)
        fw, ms_f = _warm_time(lambda: MC.myers_fwd_tab2(t2, reads.lengths, a, b, d, W, J), MYERS_REPS)
        win1 = plain.fwd_prep_tab(tables_r.peq, tables_r.bpk, a, b, la_t, d, W, J)
        win2 = plain.fwd_prep_tab2(t2.win, reads.lengths, a, b, d, t2.LA, W, J)
        fwin, ms_fw = _warm_time(lambda: MC.myers_fwd_win(la_t, lb_t, d, win1[0], win1[1], W, J),
                                 MYERS_REPS)
        fres, ms_fr = _warm_time(lambda: MC.myers_fwd(reads, a, b, d, W, J), MYERS_REPS)
        iend, jend = (fw[1] + 32 * m0).int(), fw[2]
        err_f = max(_max_abs_err(win2, win1), _max_abs_err(fw, fwin),
                    _max_abs_err((fw[0], iend, fw[2], fw[3]), fres))

        # tab2 kernel 2 beside the window-fed kernel 2 on rev_prep_tab's windows
        rw, ms_r = _warm_time(lambda: MC.myers_rev_tab2(t2, a, b, d, iend, jend, W, J), MYERS_REPS)
        sort_ms = None  # the reverse wrapper's column sort, inside ms_r, timed alone
        if bodies[1] == "thread":
            _, sort_ms = _warm_time(lambda: column_order(jend, J), MYERS_REPS)
        rwin1, prep_ms = _event_once(lambda: plain.rev_prep_tab(
            tables_r.peq, tables_r.bpk, a, b, tables_r.LA, iend, jend, d, W, J))
        rwin2, prep2_ms = _event_once(lambda: plain.rev_prep_tab2(
            t2.win, a, b, t2.LA, iend, jend, d, W, J))
        row_off = rwin1[2].int()
        rwn, ms_rw = _warm_time(lambda: MC.myers_rev_win(row_off, iend, jend, rwin1[0], rwin1[1], W, J),
                                MYERS_REPS)
        rres, ms_rr = _warm_time(lambda: MC.myers_rev(reads, a, b, d, iend, jend, W, J), MYERS_REPS)
        err_r = max(_max_abs_err(rwin2, rwin1), _max_abs_err(rw, rwn), _max_abs_err(rw, rres))
        plain_f = plain_r = None
        thread = None
        if label == "c4.W64.J1024":  # the plain Myers core costs seconds a batch
            pf, plain_f = _event_once(lambda: plain.fwd_tab2_plain(
                t2.win, reads.lengths, a, b, d, t2.LA, W, J))
            pr, plain_r = _event_once(lambda: plain.rev_tab2_plain(
                t2.win, a, b, t2.LA, iend, jend, d, W, J))
            err_f = max(err_f, _max_abs_err(fw, pf))
            err_r = max(err_r, _max_abs_err(rw, pr))
            thread = _tab2_thread_case(t2, reads, a, b, d, iend, jend, W, J, pf, pr, int_rate)
        walls = dict(entry_wall_ms=wall_ms, entry_warm_ms=warm_ms, myers_pair_wall_ms=pair_ms,
                     compute_tab_wall_ms=tab_ms)
        cases["myers_fwd_tab2"].append(dict(
            case=label, pairs=B, W=W, J=J, body=bodies[0], ms=ms_f, plain_ms=plain_f,
            window_fed_ms=ms_fw, resident_ms=ms_fr, max_abs_err=max(err_f, entry_err), **walls,
            **tab2_fwd_bound(lb_t, W, J, int_rate)))
        m0r = plain.rev_anchor(iend.long(), jend.long(), d.long(), W)
        cases["myers_rev_tab2"].append(dict(
            case=label, pairs=B, W=W, J=J, body=bodies[1], sort_ms=sort_ms, ms=ms_r, plain_ms=plain_r,
            window_fed_ms=ms_rw, resident_ms=ms_rr, rev_prep_tab_ms=prep_ms, rev_prep_tab2_ms=prep2_ms,
            max_abs_err=max(err_r, entry_err), **tab2_rev_bound(jend, m0r, W, J, int_rate)))
        sort = "no sort" if sort_ms is None else f"rev column sort {sort_ms:.4f} ms"
        _say(f"  tab2 tier {label}: pairs={B}, bodies fwd {bodies[0]} / rev {bodies[1]} ({sort}); "
             f"entry point {wall_ms:.2f} ms wall (first call), {warm_ms:.2f} ms (again) vs "
             f"myers_pair {pair_ms:.2f} ms and myers_compute_tab {tab_ms:.2f} ms "
             f"(max_abs_err {entry_err})")
        _say(f"  tab2 tier {label}: tab2 fwd {ms_f:.4f} ms vs window-fed {ms_fw:.3f} ms and resident "
             f"{ms_fr:.3f} ms, bound {cases['myers_fwd_tab2'][-1]['bound_ms']:.4f} ms; tab2 rev "
             f"{ms_r:.4f} ms vs window-fed {ms_rw:.3f} ms and resident {ms_rr:.3f} ms, bound "
             f"{cases['myers_rev_tab2'][-1]['bound_ms']:.4f} ms; rev_prep_tab {prep_ms:.3f} ms "
             f"(plain tab2 cut {prep2_ms:.3f} ms); plain fwd {plain_f} ms, plain rev {plain_r} ms; "
             f"max_abs_err fwd {err_f}, rev {err_r}")
        if thread is not None:  # after the lines above, which read this batch's cases
            cases["myers_fwd_tab2"].append(thread[0])
            cases["myers_rev_tab2"].append(thread[1])
        if max(entry_err, err_f, err_r, *(c["max_abs_err"] for c in thread or ())) != 0:
            raise AssertionError(f"tab2 tier {label}: disagrees with the other tiers or a plain version")
    return launches, cases


def _tab2_thread_case(t2, reads, a, b, d, iend, jend, W: int, J: int, pf, pr,
                      int_rate: float) -> tuple[dict, dict]:
    """The one-pair-a-thread tab2 bodies held to their plain versions: the
    batch's pairs repeated until the entries' rule picks one pair a thread
    for both passes, against the plain outputs of one copy (pf, pr)
    repeated; (fwd case, rev case), timed, plain_ms None (not re-run)."""
    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap import myers_cuda as MC

    B = a.shape[0]
    copies = next(n for n in range(2, 100)
                  if all(MC.tab2_body(n * B, W, J, rev) == "thread" for rev in (False, True)))
    ac, bc, dc, ic, jc = (t.repeat(copies) for t in (a, b, d, iend, jend))
    fw, ms_f = _warm_time(lambda: MC.myers_fwd_tab2(t2, reads.lengths, ac, bc, dc, W, J), MYERS_REPS)
    rw, ms_r = _warm_time(lambda: MC.myers_rev_tab2(t2, ac, bc, dc, ic, jc, W, J), MYERS_REPS)
    err_f = _max_abs_err(fw, [w.repeat(copies) for w in pf])
    err_r = _max_abs_err(rw, [w.repeat(copies) for w in pr])
    lb = reads.lengths[bc.long() >> 1]
    m0r = plain.rev_anchor(ic.long(), jc.long(), dc.long(), W)
    case = f"c4.W{W}.J{J} x{copies} (one pair a thread)"
    _say(f"  tab2 tier {case}: pairs={copies * B}, tab2 fwd {ms_f:.4f} ms, rev {ms_r:.4f} ms "
         f"(column sort inside), max_abs_err vs the plain versions fwd {err_f}, rev {err_r}")
    common = dict(case=case, pairs=copies * B, W=W, J=J, body="thread", plain_ms=None,
                  held_to="the plain version of one copy, repeated")
    return (dict(common, ms=ms_f, max_abs_err=err_f, **tab2_fwd_bound(lb, W, J, int_rate)),
            dict(common, ms=ms_r, max_abs_err=err_r, **tab2_rev_bound(jc, m0r, W, J, int_rate)))


def _cli(*argv) -> float:
    """Host-clock seconds of one ``phasm_tpu_torch.cli.main`` call, which
    ends in a device sync."""
    import torch

    from phasm_tpu_torch import cli

    t0 = time.perf_counter()
    cli.main([str(a) for a in argv])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _check_routed_launches(tag: str, launches: dict, counters: dict) -> None:
    """Kernels 1 and 2 serve the Myers family, kernel 3 the W-band family:
    raise unless each launched exactly when the routing sent it pairs (from
    the engine's ``overlap.family.*`` counters), and the routing sent pairs
    to the Myers family."""
    routed = {fam: any(v > 0 for k, v in counters.items()
                       if k.startswith(f"overlap.family.{fam}."))
              for fam in ("myers", "wband")}
    want_launch = {"myers_fwd": True, "myers_rev": True, "wband": routed["wband"]}
    wrong = {k: n for k, n in launches.items() if (n > 0) != want_launch[k]}
    if wrong or not routed["myers"]:
        raise AssertionError(f"{tag}: launches {launches} do not follow the routing "
                             f"(families routed: {routed})")
    if not routed["wband"]:
        _say(f"  {tag}: the routing sent no pair to the W-band family (kernel 3)")


def staged_cli() -> None:
    """Phase 8: the staged CLI on the card (see the module docstring)."""
    import filecmp
    import tempfile

    import numpy as np

    from phasm_tpu_torch import configs, metrics
    from phasm_tpu_torch.io import daligner, fasta
    from phasm_tpu_torch.overlap.engine import overlap_reads
    from phasm_tpu_torch.sim import simulate_reads

    rungs = {r.name.split("_")[0]: r for r in configs.ladder()}
    with tempfile.TemporaryDirectory(prefix="phasm_staged_cli_") as d:
        for tag, want in LADDER_R5_ALIGNMENTS.items():
            rung = rungs[tag]
            rs, _ = simulate_reads(**rung.sim)
            fa, npz = f"{d}/{tag}.fa", f"{d}/{tag}.a.npz"
            fasta.write_fasta(fa, [(rs.names[i], rs.oriented_str(2 * i)) for i in range(rs.n_reads)])
            overlap = ("overlap", fa, "--min-overlap", rung.overlap.min_overlap, "--device", "cuda")
            metrics.reset()
            _zero_launches()
            secs = _cli(*overlap, "--out", npz)
            launches = configs.launch_counts()
            counters = metrics.report()["counters"]
            table = daligner.load_table_npz(npz)
            _say(f"  {tag} staged overlap: {len(table)} alignments (LADDER_r5 {want}), "
                 f"{rs.n_reads} reads, {secs:.3f} s; launches {json.dumps(launches)}")
            _say_overlap_counters(f"  {tag}", counters)
            if len(table) != want:
                raise AssertionError(f"{tag}: staged overlap gave {len(table)} alignments, "
                                     f"LADDER_r5 has {want}")
            _check_routed_launches(tag, launches, counters)
            if tag != "c4":
                continue

            # c4: the stage file against the in-process table and the LAdump text
            mem = overlap_reads(rs, rung.overlap, device="cuda")
            if not (np.array_equal(table.as_matrix(), mem.as_matrix()) and mem.win is not None
                    and np.array_equal(table.win, mem.win)):
                raise AssertionError("c4: the staged .npz differs from overlap_reads in process")
            las_s = _cli(*overlap, "--out", f"{d}/c4.a.las")
            with open(f"{d}/c4.a.las") as fh:
                las = daligner.parse_local_alignments(fh)
            if not np.array_equal(las.as_matrix(), table.as_matrix()):
                raise AssertionError("c4: the LAdump round trip differs from the .npz table")

            # c4: filter -> layout -> phase on the card, phase again on the CPU
            pc = rung.pipeline
            stage_s = dict(overlap=secs, overlap_las=las_s)
            stage_s["filter"] = _cli("filter", fa, npz, "--out", f"{d}/c4.f.npz",
                                     "--min-read-length", pc.min_read_length,
                                     "--min-overlap-length", pc.min_overlap_length,
                                     "--max-error-rate", pc.max_error_rate)
            stage_s["layout"] = _cli("layout", fa, f"{d}/c4.f.npz", "--out", f"{d}/c4.g.gfa2",
                                     "--length-fuzz", pc.length_fuzz)
            for dev in ("cuda", "cpu"):
                stage_s[f"phase_{dev}"] = _cli(
                    "phase", fa, f"{d}/c4.g.gfa2", npz, "--out", f"{d}/c4.h.{dev}.fa",
                    "--read-assignment", f"{d}/c4.h.{dev}.tsv", "--ploidy", pc.phase.ploidy,
                    "--device", dev)
            n_hap = sum(1 for _ in fasta.iter_fasta(f"{d}/c4.h.cuda.fa"))
            with open(f"{d}/c4.h.cuda.tsv") as fh:
                n_assigned = sum(1 for _ in fh) - 1
            _say("  c4 staged stage seconds:", json.dumps(stage_s))
            _say(f"  c4 staged phase: {n_hap} haplotigs, {n_assigned} read assignments")
            for ext in ("fa", "tsv"):
                if not filecmp.cmp(f"{d}/c4.h.cuda.{ext}", f"{d}/c4.h.cpu.{ext}", shallow=False):
                    raise AssertionError(f"c4: phase's .{ext} differs between the card and the CPU")
            if n_hap <= 0 or n_assigned <= 0:
                raise AssertionError("c4: the staged phase wrote no haplotigs or no assignments")


def _table_digest(t) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256(np.ascontiguousarray(t.as_matrix()).tobytes())
    h.update(np.ascontiguousarray(t.win).tobytes())
    return h.hexdigest()


def _c4_overlap_inputs():
    from phasm_tpu_torch import configs
    from phasm_tpu_torch.sim import simulate_reads

    c4 = next(r for r in configs.ladder() if r.name.startswith("c4"))
    rs, _ = simulate_reads(**c4.sim)
    return rs, c4.overlap


def _dp_devices(n: int) -> list[str]:
    """n shards: distinct cards where there are enough, else the visible
    cards in turn (cuda:0 repeated on one card)."""
    import torch

    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)]


def dp_worker(rank: int, world: int, port: int, backend: str, device: str) -> None:
    """One process of phase 9's job: c4's overlap unsharded and on a mesh
    of one shard a process; prints ``DIGEST <rank> <rows> <unsharded>
    <mesh>``."""
    import torch
    import torch.distributed as dist

    from phasm_tpu_torch.overlap.engine import overlap_reads
    from phasm_tpu_torch.parallel import distributed, make_mesh

    torch.cuda.set_device(device)
    got = distributed.initialize(f"localhost:{port}", world, rank, backend=backend)
    if got != backend:
        raise AssertionError(f"asked for {backend}, the job runs {got}")
    rs, cfg = _c4_overlap_inputs()
    local = overlap_reads(rs, cfg, device=device)
    mesh = make_mesh(devices=[device])
    if (mesh.size, mesh.rank) != (world, rank):
        raise AssertionError(f"mesh {mesh} in process {rank} of {world}")
    sharded = overlap_reads(rs, cfg, device=device, mesh=mesh)
    torch.cuda.synchronize()
    _say(f"DIGEST {rank} {len(local)} {_table_digest(local)} {_table_digest(sharded)}")
    dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_job(want_digest: str) -> None:
    """Phase 9's 2-process job; raises unless every digest is want_digest."""
    import torch

    two = torch.cuda.device_count() >= 2
    backend, devices = ("nccl", ["cuda:0", "cuda:1"]) if two else ("gloo", ["cuda:0", "cuda:0"])
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r), "2", str(port),
             backend, dev],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r, dev in enumerate(devices)
    ]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append((*p.communicate(timeout=600), p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    digests = []
    for out, err, rc in outs:
        if rc != 0:
            raise AssertionError(f"dp worker failed rc={rc}\n{out[-2000:]}\n{err[-4000:]}")
        digests += [line.split()[1:] for line in out.splitlines() if line.startswith("DIGEST ")]
    _say(f"  2-process job ({backend}, {' and '.join(devices)}): {time.perf_counter() - t0:.1f} s "
         f"wall, both processes; digests [rank, rows, unsharded, mesh]: {json.dumps(digests)}")
    if sorted(int(d[0]) for d in digests) != [0, 1]:
        raise AssertionError(f"missing digests: {digests}")
    bad = [d for d in digests if d[2] != want_digest or d[3] != want_digest]
    if bad:
        raise AssertionError(f"digests differ from this process's unsharded table: {bad}")


def _busy_ms(events, names=None) -> float:
    """Union of the device intervals (ms) of trace events of category
    kernel / gpu_memcpy / gpu_memset, or of the kernels whose name holds one
    of ``names``."""
    spans = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("ph") == "X" and (
            e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") if names is None
            else e.get("cat") == "kernel" and any(n in e.get("name", "") for n in names))
    )
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e3


def data_parallel() -> None:
    """Phase 9: the data-parallel overlap (see the module docstring)."""
    import numpy as np

    from phasm_tpu_torch import configs
    from phasm_tpu_torch.overlap.engine import overlap_reads, overlap_reads_blocked
    from phasm_tpu_torch.parallel import make_mesh

    rs, cfg = _c4_overlap_inputs()
    walls = []
    for _ in range(2):  # the first call in a process is cold (upload, tables, allocator)
        want, ms = _wall_ms(lambda: overlap_reads(rs, cfg, device="cuda"))
        walls.append(ms)
    want_digest = _table_digest(want)
    _say(f"  unsharded overlap_reads: {len(want)} rows, {walls[0]:.1f} ms, again {walls[1]:.1f} ms")
    if len(want) != LADDER_R5_ALIGNMENTS["c4"]:
        raise AssertionError(f"c4: {len(want)} alignments, LADDER_r5 has {LADDER_R5_ALIGNMENTS['c4']}")
    for n in (2, 4):
        devices = _dp_devices(n)
        mesh = make_mesh(devices=devices)
        for label, fn in (
            ("overlap_reads", lambda: overlap_reads(rs, cfg, device="cuda", mesh=mesh)),
            ("overlap_reads_blocked n_blocks=3",
             lambda: overlap_reads_blocked(rs, cfg, n_blocks=3, device="cuda", mesh=mesh)),
        ):
            _zero_launches()
            got, ms = _wall_ms(fn)
            launches = configs.launch_counts()
            same = np.array_equal(got.as_matrix(), want.as_matrix()) and np.array_equal(got.win, want.win)
            _say(f"  {label}, mesh of {n} ({', '.join(devices)}): {len(got)} rows, {ms:.1f} ms, "
                 f"equal to unsharded: {same}; launches {json.dumps(launches)}")
            if not same:
                raise AssertionError(f"{label} on {devices} differs from the unsharded table")
            if launches["myers_fwd"] <= 0 or launches["myers_rev"] <= 0 or launches["wband"] <= 0:
                raise AssertionError(f"{label} on {devices}: a kernel of the path never launched")

    _dp_job(want_digest)

    got, ms, events = _traced_wall_ms(lambda: overlap_reads(rs, cfg, device="cuda"))
    if _table_digest(got) != want_digest:
        raise AssertionError("the traced overlap_reads differs from the unsharded table")
    _say_busy("traced warm overlap_reads", events, ms)


def _traced_wall_ms(fn):
    """(result, host-clock ms, trace events) of one call that ends in a
    device sync, inside ``metrics.device_trace``."""
    import glob
    import tempfile

    from phasm_tpu_torch import metrics

    with tempfile.TemporaryDirectory(prefix="phasm_trace_") as d:
        with metrics.device_trace(d):
            got, ms = _wall_ms(fn)
        (path,) = glob.glob(os.path.join(d, "*.json"))
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return got, ms, events


def _say_busy(label: str, events, ms: float,
              kernels=("myers_fwd_kernel", "myers_rev_kernel", "wband_kernel")) -> None:
    """Print a traced call's device busy time and share (kernels, copies,
    fills) and the time of each of ``kernels``; raise if the trace names
    one of them not at all."""
    ours = {k: _busy_ms(events, [k]) for k in kernels}
    missing = [k for k, v in ours.items() if v <= 0]
    if missing:
        raise AssertionError(f"{label}: the trace names no {missing}")
    busy = _busy_ms(events)
    _say(f"  {label}: {ms:.1f} ms host clock; device busy {busy:.3f} ms "
         f"({busy / ms:.2%}: kernels, copies, fills), {json.dumps(ours)} ms "
         f"({sum(ours.values()) / ms:.2%})")


def _ladder_r5_row(name: str) -> dict:
    """The reference ladder's row of rung ``name`` (``LADDER_r5.jsonl``; of
    a rung listed twice, the last)."""
    with open(os.path.join(ROOT, "LADDER_r5.jsonl")) as fh:
        return [row for row in map(json.loads, fh) if row["name"] == name][-1]


def _row_vs_ladder_r5(tag: str, row: dict) -> dict:
    """Print a port ladder row, its stage seconds and launches, and every
    column it shares with its ``LADDER_r5`` row (``ladder.row_diff``: all
    but the name, the backend and the ``*_s`` times) whose two values
    differ; returns those ({column: [port, reference]})."""
    from phasm_tpu_torch import ladder

    _say(f"{tag} row:", json.dumps(row, sort_keys=True))
    _say(f"{tag} stage seconds:", json.dumps({k: v for k, v in row.items() if k.endswith("_s")}),
         "launches per stage:", json.dumps(
             {k: row[k] for k in ("launches_overlap", "launches_overlap_warm", "launches_assemble")}))
    shared, diff = ladder.row_diff(row, _ladder_r5_row(row["name"]))
    _say(f"{tag} vs LADDER_r5 ({len(shared)} shared columns), differing [port, reference]:",
         json.dumps(diff))
    return diff


def _check_ladder_row(tag: str, row: dict) -> None:
    """Raise unless a card row equals its ``LADDER_r5`` row in every shared
    column but the times, and kernels 1 and 2 launched in both overlap
    calls."""
    diff = _row_vs_ladder_r5(tag, row)
    if diff:
        raise AssertionError(f"{tag}: the row differs from LADDER_r5 in {sorted(diff)}")
    for stage in ("launches_overlap", "launches_overlap_warm"):
        for k in ("myers_fwd", "myers_rev"):
            if row[stage][k] <= 0:
                raise AssertionError(f"{tag}: {k} never launched in {stage}")


def rung_end_to_end(tag: str) -> dict:
    """One ladder rung end to end on the card (``configs.run_rung``), its
    row beside the reference ladder's (``LADDER_r5.jsonl``).  Not a phase
    of ``main``: a rung's round-2 polish runs minutes on the host.  Run
    alone: ``python -c "import chip_smoke as c; c.build(); c.rung_end_to_end('c3')"``.
    Prints the row, the stage timers, kernel families, wide-band retries,
    launch shapes, and every column the two rows share with its two values
    where they differ; returns the row."""
    from phasm_tpu_torch import configs, metrics

    rung = next(r for r in configs.ladder() if r.name.split("_")[0] == tag)
    metrics.reset()
    _zero_launches()
    row = configs.run_rung(rung, device="cuda")
    report = metrics.report()
    _say(f"{tag} stage timers (host clock, both overlap calls summed):", json.dumps(
        {k: round(v, 3) for k, v in sorted(report["seconds"].items())}))
    _say_overlap_counters(tag, report["counters"])
    _row_vs_ladder_r5(tag, row)
    return row


def ladder_rows(tags: str) -> list[dict]:
    """The port's ladder runner in this process (``ladder.main``, the entry
    ``python -m phasm_tpu_torch.ladder`` runs) on each rung of ``tags``
    (comma-separated prefixes, e.g. ``"c2,c5"``) in turn, ``--strict
    --device cuda``, its metrics and launch counts set to 0 just before;
    prints each row, its stage timers (``pipeline.polish2`` among them),
    kernel families and launch shapes, and raises unless every row equals
    its ``LADDER_r5`` row in every shared column but the times.  Not a
    phase of ``main`` (c2 and c5 run minutes of round-2 polish on the
    host); alone:
    ``python3 -c "import chip_smoke as c; c.build(); c.ladder_rows('c2,c5')"``."""
    import tempfile

    from phasm_tpu_torch import ladder, metrics

    rows, failed = [], []
    with tempfile.TemporaryDirectory(prefix="phasm_ladder_") as d:
        for tag in tags.split(","):
            out = os.path.join(d, f"{tag}.jsonl")
            metrics.reset()
            _zero_launches()
            t0 = time.perf_counter()
            ladder.main(["--rungs", tag, "--strict", "--device", "cuda", "--out", out])
            secs = time.perf_counter() - t0
            report = metrics.report()
            with open(out) as fh:
                (row,) = map(json.loads, fh)
            _say(f"{tag}: ladder.main {secs:.1f} s; stage timers (host clock, both overlap "
                 "calls summed):", json.dumps(
                     {k: round(v, 3) for k, v in sorted(report["seconds"].items())}))
            _say_overlap_counters(tag, report["counters"])
            try:
                _check_ladder_row(tag, row)
            except AssertionError as e:
                failed.append(str(e))
            rows.append(row)
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def _ladder_subprocess(tags: str) -> list[dict]:
    """``python -m phasm_tpu_torch.ladder --rungs <tags> --strict --device
    cuda --out <tmp>`` in a process of its own; returns the rows it wrote,
    which must be the lines it printed."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="phasm_ladder_") as d:
        out = os.path.join(d, "ladder.jsonl")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "phasm_tpu_torch.ladder", "--rungs", tags, "--strict",
             "--device", "cuda", "--out", out],
            capture_output=True, text=True, timeout=900, cwd=ROOT,
        )
        if res.returncode != 0:
            raise AssertionError(f"ladder rc={res.returncode}\n{res.stdout[-2000:]}\n"
                                 f"{res.stderr[-4000:]}")
        with open(out) as fh:
            rows = [json.loads(line) for line in fh]
    if rows != [json.loads(line) for line in res.stdout.splitlines() if line.strip()]:
        raise AssertionError("the ladder's --out file differs from its stdout")
    _say(f"  python -m phasm_tpu_torch.ladder --rungs {tags}: {time.perf_counter() - t0:.1f} s, "
         f"{len(rows)} rows")
    return rows


def scale_overlap() -> None:
    """Phase 10's scale rungs: c6's and c7's overlap stage alone
    (``overlap_reads`` in this process, launch counts and metrics set to 0
    just before each cold call); each table's length must equal
    ``SCALE_ALIGNMENTS``, kernels 1 and 2 must launch and kernel 3 exactly
    where the routing sends pairs.  On c6 a warm call runs inside
    ``metrics.device_trace``: its table must equal the cold one, and its
    trace gives the device busy share at the reference workload's scale."""
    import torch

    from phasm_tpu_torch import configs, metrics
    from phasm_tpu_torch.overlap.engine import overlap_reads
    from phasm_tpu_torch.sim import simulate_reads

    rungs = {r.name.split("_")[0]: r for r in configs.ladder()}
    for tag, want in SCALE_ALIGNMENTS.items():
        rung = rungs[tag]
        t0 = time.perf_counter()
        rs, _ = simulate_reads(**rung.sim)
        sim_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        _zero_launches()
        table, ms = _wall_ms(lambda: overlap_reads(rs, rung.overlap, device="cuda"))
        launches = configs.launch_counts()
        report = metrics.report()
        counters = report["counters"]
        _say(f"  {tag} overlap_reads: {len(table)} alignments (LADDER_r5 {want}), {rs.n_reads} "
             f"reads, {int(counters['overlap.candidates'])} candidate pairs; sim {sim_s:.1f} s, "
             f"cold call {ms:.1f} ms; peak device memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {json.dumps(launches)}")
        _say(f"  {tag} stage timers (host clock):", json.dumps(
            {k: round(v, 3) for k, v in sorted(report["seconds"].items())}))
        _say_overlap_counters(f"  {tag}", counters)
        if len(table) != want:
            raise AssertionError(f"{tag}: overlap_reads gave {len(table)} alignments, "
                                 f"LADDER_r5 has {want}")
        _check_routed_launches(tag, launches, counters)
        if tag == "c6":
            warm, ms, events = _traced_wall_ms(lambda: overlap_reads(rs, rung.overlap, device="cuda"))
            if _table_digest(warm) != _table_digest(table):
                raise AssertionError("c6: the traced warm overlap_reads differs from the cold one")
            kernels = ["myers_fwd_kernel", "myers_rev_kernel"]
            if launches["wband"]:
                kernels.append("wband_kernel")
            _say_busy("c6 traced warm overlap_reads", events, ms, kernels)


def headline_bench() -> None:
    """``python -m phasm_tpu_torch.bench`` in a process of its own: prints
    its ``#`` lines; its last stdout line must be the metric line, family
    ``myers``, value > 0."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "phasm_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    if res.returncode != 0:
        raise AssertionError(f"bench rc={res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    for line in res.stderr.splitlines():
        if line.startswith("#"):
            _say(f"  {line}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    _say(f"  python -m phasm_tpu_torch.bench: {time.perf_counter() - t0:.1f} s;", json.dumps(line))
    if line["metric"] != BENCH_METRIC or not line["value"] > 0:
        raise AssertionError(f"bench line {line}, expected {BENCH_METRIC} with a positive value")


def ladder_and_bench() -> None:
    """Phase 10: the ladder runner on c1 (a process of its own), c6's and
    c7's overlap, the headline bench (see the module docstring)."""
    (row,) = _ladder_subprocess("c1")
    _check_ladder_row("c1", row)
    scale_overlap()
    headline_bench()


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    import phasm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    environment()
    int_rate = int32_ops_per_s()
    build()
    _say("kernels vs plain versions:")
    checks = kernel_checks(int_rate)
    _say("main path:")
    launches, shapes = main_path()
    main_path_gap(checks, shapes)
    _say("batch entry point (kernel 4):")
    dense_launches, checks["wband_dense"] = batch_entry_point(int_rate)
    launches.update(dense_launches)
    _say("table tier (kernel 5):")
    tab_launches, tab_checks = table_tier(int_rate)
    launches.update(tab_launches)
    checks.update(tab_checks)
    _say("tab2 tier (kernels 1 and 2, tab2 bodies):")
    tab2_launches, tab2_checks = tab2_tier(int_rate)
    launches.update(tab2_launches)
    checks.update(tab2_checks)
    _say("staged CLI (overlap on c1 to c5; c4 through filter, layout, phase):")
    staged_cli()
    _say("data parallel (c4 overlap on meshes of 2 and 4 shards, a 2-process job, a trace):")
    data_parallel()
    _say("ladder and bench (c1 end to end, c6 and c7 overlap, the headline bench):")
    ladder_and_bench()
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        recs = checks[name]
        # the largest batch on which the plain version was also timed
        rep = max((r for r in recs if r["plain_ms"] is not None), key=lambda r: r["pairs"] * r["J"])
        line["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in recs),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep.get("library_ms"), at=rep["case"], cases=recs,
        ))
    _say(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s")
    _say(json.dumps(line))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        rank, world, port, backend, device = sys.argv[2:7]
        dp_worker(int(rank), int(world), int(port), backend, device)
        sys.exit(0)
    sys.exit(main())
