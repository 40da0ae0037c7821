"""Headline benchmark of the port: overlap alignments/s through the
PRODUCTION path (``DeviceExtender.extend_async`` + ``materialize``, the
code ``overlap_reads`` runs: index upload, routed kernel family, result
fetch).  Twin of the reference's root ``bench.py``.

    python -m phasm_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline"};
the metric names the device type, the kernel family ``routing.route``
picks, the band and the column bucket.  ``vs_baseline`` is null: no
number measured on a card exists to compare with.

Workload (``make_batch``, the reference's, copied verbatim so that a seed
gives byte-equal arrays): dovetail pairs of noisy reads that complete
inside the column window.  On the card: band 64, J = 2048, 65,536 pairs of
4,096-base reads over 512 reads, 15 timed calls (the engine's
``_MAX_BATCH``).  On the CPU: J = 1024, 256 pairs of 1,200-base reads over
1,024 reads, 3 timed calls.

On the card two ``#`` lines go to stderr: the kernel-only rate of the
window-fed Myers kernels 1w + 2w on windows cut once (kernel 5, one
forward run to fix the reverse anchors, ``rev_prep_tab``), timed with CUDA
events, and the torch / CUDA / nvcc / triton versions with the card's name
and power limit.

The reference's tunnel machinery (``robust``, ``put_chunked``, the
watchdog child, the persistent compile cache) is not ported: a CUDA card
on the local bus needs none of it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from phasm_tpu_torch.device import resolve_device
from phasm_tpu_torch.overlap.engine import DeviceExtender, OverlapConfig, _resolve_backend
from phasm_tpu_torch.overlap.routing import route
from phasm_tpu_torch.state import DeviceReads

W = 64
CARD_SHAPE = dict(jmax=2048, pairs=65536, iters=15, read_len=4096, n_reads=512)
CPU_SHAPE = dict(jmax=1024, pairs=256, iters=3, read_len=1200, n_reads=1024)


def make_batch(rng, n_reads, read_len, n_pairs, jmax, err=0.05):
    """Dovetail pairs whose alignment COMPLETES within the jmax window.

    Round 1 sampled any pair within read_len-500 bp, so most pairs needed
    ~read_len columns but the kernel ran jmax=2048 — they hit no endpoint
    and returned BIG ("no alignment"), i.e. the bench was timing a workload
    whose alignments mostly don't finish.  Keep only pairs with
    read_len - d0 + slack <= jmax so every pair ends at i == la in-window.
    """
    genome = rng.integers(0, 4, 400_000).astype(np.uint8)
    pos = rng.integers(0, genome.shape[0] - read_len, n_reads)
    codes = np.stack([genome[p : p + read_len] for p in pos])
    noise = rng.random(codes.shape) < err
    codes = np.where(
        noise, (codes + rng.integers(1, 4, codes.shape)) % 4, codes
    ).astype(np.uint8)
    lengths = np.full(n_reads, read_len, dtype=np.int32)

    d_min = max(read_len - jmax + 300, 0)
    order = np.argsort(pos, kind="stable")
    a_idx, b_idx, d0 = [], [], []
    i = 0
    while len(a_idx) < n_pairs:
        step = (i // (n_reads - 1)) % 8 + 1  # vary rank distance per pass
        xi = i % (n_reads - step)
        x = order[xi]
        y = order[xi + step]
        i += 1
        if pos[y] < pos[x]:
            x, y = y, x
        if d_min <= pos[y] - pos[x] < read_len - 500:
            a_idx.append(x)
            b_idx.append(y)
            d0.append(pos[y] - pos[x])
    a_oid = 2 * np.array(a_idx[:n_pairs])
    b_oid = 2 * np.array(b_idx[:n_pairs])
    d0 = np.array(d0[:n_pairs], dtype=np.int32)

    oriented = np.zeros((2 * n_reads, read_len), dtype=np.uint8)
    oriented[0::2] = codes
    for r in range(n_reads):
        oriented[2 * r + 1] = 3 - codes[r][::-1]
    return oriented, lengths, a_oid, b_oid, d0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def production_throughput(ext, a_oid, b_oid, d0, jmax: int, iters: int):
    """Seconds a batch in steady state: ``iters`` calls to ``extend_async``
    (index vectors uploaded each call, as ``overlap_reads`` does), ending
    in ``materialize`` of the last one and a device sync.  One warm call
    first, whose result must align more than 95 % of the pairs; returns
    (seconds a batch, the warm call's ExtendResult)."""
    M = len(a_oid)
    res = ext.materialize(*ext.extend_async(a_oid, b_oid, d0, jmax))
    n_found = int((res.diffs < (1 << 15)).sum())
    if n_found <= 0.95 * M:
        raise RuntimeError(f"bench workload broken: only {n_found}/{M} pairs aligned")
    dev = ext.reads.device
    _sync(dev)
    t0 = time.perf_counter()
    last = None
    for _ in range(iters):
        last = ext.extend_async(a_oid, b_oid, d0, jmax)
    ext.materialize(*last)
    _sync(dev)
    return (time.perf_counter() - t0) / iters, res


def myers_kernel_only(reads: DeviceReads, a_oid, b_oid, d0, jmax: int, iters: int, want):
    """Seconds a batch of the window-fed Myers kernels 1w + 2w on windows
    cut once (kernel 5 for the forward windows, one forward run to fix the
    reverse anchors, ``rev_prep_tab`` for the reverse windows), CUDA-event
    mean over ``iters`` launches of both after one warm launch.  The frozen
    windows' result must equal ``want`` (the production call's), field for
    field."""
    from phasm_tpu_torch import _build
    from phasm_tpu_torch.overlap import myers as plain
    from phasm_tpu_torch.overlap.myers_cuda import myers_fwd_fetch, myers_fwd_win, myers_rev_win
    from phasm_tpu_torch.state import MyersTables

    tables = MyersTables.from_reads(reads)
    a, b, d = _build.index_tensors(reads.device, a_oid, b_oid, d0)
    la = reads.lengths[a.long() >> 1]
    lb = reads.lengths[b.long() >> 1]
    m0 = plain.fwd_anchor(d, W)
    peq_f, bpk_f = myers_fwd_fetch(tables, a, b, (m0 + plain.F_TAB).int(), W, jmax)
    cost_f, iend_rel, jend, win = myers_fwd_win(la, lb, d, peq_f, bpk_f, W, jmax)
    iend = (iend_rel + plain.WB * m0).int()
    peq_r, bpk_r, row_off = plain.rev_prep_tab(
        tables.peq, tables.bpk, a, b, tables.LA, iend, jend, d, W, jmax
    )
    row_off = row_off.int()
    cost_r, best_row = myers_rev_win(row_off, iend, jend, peq_r, bpk_r, W, jmax)
    cost, i0, ie, je, wn = (x.cpu().numpy() for x in plain.combine(
        cost_f, iend, jend, win, cost_r, best_row))
    for name, got, ref in (("diffs", cost, want.diffs), ("a_start", i0, want.a_start),
                           ("a_end", ie, want.a_end), ("b_end", je, want.b_end),
                           ("win_cost", wn, want.win_cost)):
        if not np.array_equal(got, ref):
            raise AssertionError(f"kernel-only windows: {name} differs from the production call")

    def kernels():
        myers_fwd_win(la, lb, d, peq_f, bpk_f, W, jmax)
        myers_rev_win(row_off, iend, jend, peq_r, bpk_r, W, jmax)

    kernels()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        kernels()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def card() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def versions() -> str:
    """The torch, CUDA, nvcc and triton versions."""
    from phasm_tpu_torch import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    return f"torch {torch.__version__}, cuda {torch.version.cuda}, nvcc {nvcc}, triton {triton_v}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m phasm_tpu_torch.bench")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    shape = CARD_SHAPE if dev.type == "cuda" else CPU_SHAPE
    J, M, iters = shape["jmax"], shape["pairs"], shape["iters"]

    rng = np.random.default_rng(0)
    oriented, lengths, a_oid, b_oid, d0 = make_batch(
        rng, shape["n_reads"], shape["read_len"], M, J
    )
    reads = DeviceReads.from_arrays(oriented, lengths, dev)
    backend = _resolve_backend(OverlapConfig(), dev)
    ext = DeviceExtender(reads, band=W, backend=backend)
    dt, warm = production_throughput(ext, a_oid, b_oid, d0, J, iters)

    if dev.type == "cuda":
        dt_k = myers_kernel_only(reads, a_oid, b_oid, d0, J, iters, warm)
        print(f"# kernel-only myers fwd+rev: {M / dt_k:,.0f} aligns/s "
              f"({dt_k * 1e3:.3f} ms/batch)", file=sys.stderr)
        print(f"# {versions()}; card {card()}", file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": (f"overlap_alignments_per_sec_per_chip"
                   f"[{dev.type},production,{route(backend, W, J)},band{W},j{J}]"),
        "value": round(M / dt, 1),
        "unit": "alignments/s/chip",
        "vs_baseline": None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
