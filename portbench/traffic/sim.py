"""Read simulator of the benchmark: a frozen copy of the port's
``phasm_tpu_torch.sim.simulate_reads`` (itself the reference's), so a seed
gives the same reads whatever later changes make of the program's copy.

The random stream is the original's draw for draw; only the string round
trip (decode to ASCII, encode back) is left out, since it maps codes 0..3
to themselves.  Returns the dense code matrix and lengths, and
``oriented_matrix`` gives the [2N, Lpad] oriented rows the engine indexes.
"""
from __future__ import annotations

import numpy as np


def simulate_haplotypes(rng, genome_len, ploidy, snv_rate, indel_rate,
                        hotspots=0, hotspot_width=1500, hotspot_rate=0.05):
    """Random base haplotype plus ``ploidy - 1`` divergent copies (SNVs,
    short indels); with ``hotspots``, dense SNV windows evenly spaced."""
    base = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    rate = np.full(genome_len, snv_rate)
    if hotspots > 0:
        span = genome_len // (hotspots + 1)
        for i in range(1, hotspots + 1):
            c = i * span
            rate[max(0, c - hotspot_width // 2) : c + hotspot_width // 2] = hotspot_rate
    haps = [base]
    for _ in range(ploidy - 1):
        h = base.copy()
        snv_mask = rng.random(genome_len) < rate
        pos = np.nonzero(snv_mask)[0]
        h[pos] = (h[pos] + rng.integers(1, 4, size=pos.shape[0])) % 4
        n_ind = rng.poisson(indel_rate * genome_len)
        parts, cur = [], 0
        cuts = np.sort(rng.choice(genome_len, size=min(n_ind, genome_len // 10), replace=False))
        for c in cuts:
            parts.append(h[cur:c])
            if rng.random() < 0.5:  # insertion
                parts.append(rng.integers(0, 4, size=int(rng.integers(1, 4))).astype(np.uint8))
                cur = c
            else:  # deletion
                cur = min(genome_len, c + int(rng.integers(1, 4)))
        parts.append(h[cur:])
        haps.append(np.concatenate(parts))
    return haps


def mutate_read(rng, seq, error_rate):
    """CLR-style errors: 50 % insertions, 30 % deletions, 20 % substitutions."""
    if error_rate <= 0:
        return seq
    n = seq.shape[0]
    r = rng.random(n)
    p_ins, p_del, p_sub = 0.5 * error_rate, 0.3 * error_rate, 0.2 * error_rate
    ins = r < p_ins
    dele = (r >= p_ins) & (r < p_ins + p_del)
    sub = (r >= p_ins + p_del) & (r < p_ins + p_del + p_sub)
    out = seq.copy()
    out[sub] = (out[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reps = np.where(ins, 2, np.where(dele, 0, 1))
    res = np.repeat(out, reps)
    starts = np.cumsum(reps) - reps
    ins_pos = starts[ins]
    res[ins_pos] = rng.integers(0, 4, ins_pos.shape[0])
    return res.astype(np.uint8)


def simulate_reads(seed=0, genome_len=50_000, ploidy=2, coverage=25.0,
                   mean_read_len=5_000, min_read_len=1_000, error_rate=0.05,
                   snv_rate=0.01, indel_rate=0.0005, hotspots=0,
                   hotspot_width=1500, hotspot_rate=0.05, read_len_spread=None,
                   pad_multiple=128):
    """(codes uint8 [N, Lpad], lengths int32 [N]) of a simulated read set;
    positions past a read's length hold 0."""
    rng = np.random.default_rng(seed)
    haps = simulate_haplotypes(rng, genome_len, ploidy, snv_rate, indel_rate,
                               hotspots=hotspots, hotspot_width=hotspot_width,
                               hotspot_rate=hotspot_rate)
    n_reads = max(int(coverage * genome_len * ploidy / mean_read_len), 10)
    seqs = []
    for _ in range(n_reads):
        hap = haps[int(rng.integers(0, ploidy))]
        if read_len_spread is not None:
            lo = mean_read_len * (1.0 - read_len_spread)
            hi = mean_read_len * (1.0 + read_len_spread)
            ln = int(rng.uniform(lo, hi))
        else:
            ln = int(np.clip(rng.exponential(mean_read_len * 0.4) + mean_read_len * 0.6,
                             min_read_len, mean_read_len * 3))
        ln = min(ln, hap.shape[0])
        pos = int(rng.integers(0, hap.shape[0] - ln + 1))
        raw = mutate_read(rng, hap[pos : pos + ln], error_rate)
        if int(rng.integers(0, 2)):
            raw = (3 - raw[::-1]).astype(np.uint8)
        seqs.append(raw)
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.int32)
    lpad = -(-max(int(lengths.max()), 1) // pad_multiple) * pad_multiple
    codes = np.zeros((n_reads, lpad), dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : s.shape[0]] = s
    return codes, lengths


def oriented_matrix(codes, lengths):
    """[2N, Lpad] oriented rows: row 2i is read i, row 2i + 1 its reverse
    complement, left-aligned (padding stays 0 on the right)."""
    n, lpad = codes.shape
    out = np.zeros((2 * n, lpad), dtype=np.uint8)
    out[0::2] = codes
    for i in range(n):
        li = int(lengths[i])
        out[2 * i + 1, :li] = 3 - codes[i, :li][::-1]
    return out
