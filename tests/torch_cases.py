"""Case generators shared by the port's CPU tests and its card tests
(tests/test_torch_extend.py, tests/test_torch_cuda.py), and
``ensure_reference_native``, which the port's tests call at import.
Imports nothing of JAX, so the card tests, which run without it, can use
it."""
import fcntl
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from test_myers import random_overlap_case


def edited_pairs(rng, B, la_max, W, err=0.1):
    """random_overlap_case pairs, edited in turn: untouched, negative d0, d0
    near la, b cut short (0..19, off the multiples of 8), a shorter than the
    band (and than la_max); so that a warp holds very different pairs."""
    a, b, la, lb, d0 = random_overlap_case(rng, B=B, la_max=la_max, err=err)
    for p in range(B):
        kind = p % 5
        if kind == 1:
            d0[p] = -int(rng.integers(1, W + 40))
        elif kind == 2:
            d0[p] = la[p] - int(rng.integers(0, W))
        elif kind == 3:
            lb[p] = int(rng.integers(0, 20))
        elif kind == 4:
            la[p], lb[p] = int(rng.integers(1, min(W, a.shape[1]) + 1)), int(rng.integers(0, 12))
    return a, b, la, lb, d0


def resident_pairs(rng, B, la_max, W, err=0.1):
    """edited_pairs laid out as a resident read set holds them, with pairs at
    the matrix's edges: returns (oriented [2N, LA] uint8, zero-padded,
    lengths [N] int32, a_oid, b_oid, d0 int32 [B + 3]).  Read 2p is pair p's
    a, read 2p + 1 its b, both strand rows holding the read; pair 0 is on row
    0 with d0 < W/2; LA is no multiple of 8; the last read fills the last
    row, and three more pairs use it: as b (b_oid = 2N - 1), as a with a
    negative d0, and as a with d0 near its end, so that their windows run
    off both ends of the matrix."""
    a, b, la, lb, d0 = edited_pairs(rng, B, la_max, W, err)
    d0[0] = int(rng.integers(-(W // 2) - 8, W // 2 + 1)) if W > 1 else 0
    xa, xb, xla, xlb, xd0 = random_overlap_case(rng, B=1, la_max=la_max, err=err)
    reads = [r[:n] for p in range(B) for r, n in ((a[p], la[p]), (b[p], lb[p]))]
    reads.append(xa[0, : xla[0]])
    LA = max(len(r) for r in reads + [xb[0, : xlb[0]]])
    LA += 3 if LA % 8 == 0 else 0
    tail = rng.integers(0, 4, LA - xlb[0]).astype(np.uint8)
    reads.append(np.concatenate([xb[0, : xlb[0]], tail]))  # fills its row
    N = len(reads)
    oriented = np.zeros((2 * N, LA), dtype=np.uint8)
    for r, codes in enumerate(reads):
        oriented[2 * r, : len(codes)] = codes
        oriented[2 * r + 1, : len(codes)] = codes
    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    last, xa_oid = 2 * N - 1, 2 * (N - 2)
    a_oid = np.concatenate([4 * np.arange(B), [xa_oid, last, last]]).astype(np.int32)
    b_oid = np.concatenate([4 * np.arange(B) + 2, [last, xa_oid + 1, xa_oid]]).astype(np.int32)
    near_end = LA - int(rng.integers(0, max(W, 2)))
    d0 = np.concatenate([d0, [xd0[0], -xd0[0], near_end]]).astype(np.int32)
    return oriented, lengths, a_oid, b_oid, d0


_REPO = Path(__file__).resolve().parent.parent
REFERENCE_NATIVE = _REPO / "native" / "libphasm_native.so"


def ensure_reference_native() -> None:
    """Build the reference's native library (``native/libphasm_native.so``)
    when it is missing, with the reference's own g++ command
    (``phasm_tpu/native.py``), to a temporary name and then ``os.replace``:
    no process ever finds a partial file there.  Builders in concurrent test
    workers are serialised with an ``flock``.

    The reference's loader builds onto the final path itself, so workers
    that load it at once can find another worker's partial file; such a
    worker's loader returns None and never tries again, and its native
    polish and seeding fall back to numpy for the rest of its run.  Test
    modules are imported (collected) in every worker before any test runs,
    and by then every such build has ended; so a loader in this process
    that gave None is re-armed here, and loads the complete file at its next
    call."""
    if not REFERENCE_NATIVE.exists():
        lock_dir = _REPO / "build"
        lock_dir.mkdir(exist_ok=True)
        with open(lock_dir / "reference_native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not REFERENCE_NATIVE.exists():
                tmp = REFERENCE_NATIVE.with_name(f"{REFERENCE_NATIVE.name}.{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                         "-pthread", "-shared", "-o", str(tmp),
                         str(REFERENCE_NATIVE.with_name("phasm_native.cpp"))],
                        check=True, capture_output=True, timeout=600,
                    )
                    os.replace(tmp, REFERENCE_NATIVE)
                finally:
                    tmp.unlink(missing_ok=True)
    ref = sys.modules.get("phasm_tpu.native")
    if ref is not None and ref._lib is None:
        ref._tried = False
