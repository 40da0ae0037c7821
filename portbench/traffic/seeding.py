"""Candidate pairs of the benchmark's traffic: a frozen copy of the port's
seeding path (``phasm_tpu_torch.overlap.seeding`` with its native fast
paths), so a seed gives the same candidates whatever later changes make of
the program's seeding.

minimizers -> one radix sort by (canonical k-mer, read) -> seed-pair
emission -> (pair, strand, diagonal band) histogram, all in the C++ copy
``seeding_native.cpp``, built with g++ at first use into ``portbench/.build/``
(a fixed directory inside the checkout; the file name carries a hash of the
source, the flags and the host CPU, since ``-march=native`` code is the
host's own).  There is no numpy fallback: it takes minutes at these sizes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "seeding_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".build"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_ABI_VERSION = 5

_lib = None


@dataclasses.dataclass(frozen=True)
class SeedParams:
    k: int = 15
    window: int = 8
    max_occ: int = 64
    min_seeds: int = 3
    diag_band: int = 48


@dataclasses.dataclass
class Candidates:
    a_id: np.ndarray  # int32, a_id < b_id
    b_id: np.ndarray
    strand: np.ndarray  # relative orientation
    diag: np.ndarray  # int32 seed diagonal (a_pos - oriented b_pos)

    def __len__(self):
        return int(self.a_id.shape[0])


def _host_cpu() -> bytes:
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return os.uname().machine.encode()
    return "\n".join(sorted({ln for ln in lines if ln.startswith(("model name", "flags"))})).encode()


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"libseeding_{h.hexdigest()[:16]}.so"


def _lib_handle():
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"seeding build failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.phasm_native_abi_version.restype = ctypes.c_int64
    if lib.phasm_native_abi_version() != _ABI_VERSION:
        raise RuntimeError(f"{so}: stale seeding library")
    i64, i32, u64, u8 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, ctypes.c_uint8
    p = ctypes.POINTER
    lib.extract_minimizers.restype = i64
    lib.extract_minimizers.argtypes = [p(u8), i64, i64, p(i32), i32, i32, p(i32), p(i32), p(u64), p(u8), i64]
    lib.match_seed_pairs.restype = i64
    lib.match_seed_pairs.argtypes = [p(i32), p(i32), p(u64), p(u8), i64, p(i32), i32, i32, i32, i32,
                                     p(i32), p(i32), p(i32), p(i32), i64]
    lib.sort_u64_order.restype = None
    lib.sort_u64_order.argtypes = [p(u64), i64, p(i64)]
    lib.pair_histogram.restype = i64
    lib.pair_histogram.argtypes = [p(i32), p(i32), p(i32), p(i32), i64, i64, i32, i32,
                                   p(i32), p(i32), p(i32), p(i32), p(i32), i64]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _minimizers(codes, lengths, k: int, w: int):
    lib = _lib_handle()
    n, lpad = codes.shape
    cap = int(n * max(lpad // max(w // 2, 1), 8) + 1024)
    while True:
        rid, pos = np.empty(cap, np.int32), np.empty(cap, np.int32)
        canon, ori = np.empty(cap, np.uint64), np.empty(cap, np.uint8)
        got = lib.extract_minimizers(_ptr(codes, ctypes.c_uint8), n, lpad, _ptr(lengths, ctypes.c_int32),
                                     k, w, _ptr(rid, ctypes.c_int32), _ptr(pos, ctypes.c_int32),
                                     _ptr(canon, ctypes.c_uint64), _ptr(ori, ctypes.c_uint8), cap)
        if got >= 0:
            return rid[:got], pos[:got], canon[:got], ori[:got]
        cap *= 2


def _sort(rid, pos, canon, ori, k: int):
    """Seeds by (canonical k-mer, read id): the packed key's radix argsort
    where it fits 64 bits, numpy's lexsort otherwise (the same order)."""
    n = rid.shape[0]
    if not n:
        return rid, pos, canon, ori
    ridbits = max(int(rid.max()), 1).bit_length()
    if 2 * k + ridbits <= 64:
        key = np.ascontiguousarray((canon << np.uint64(ridbits)) | rid.astype(np.uint64))
        order = np.empty(n, dtype=np.int64)
        _lib_handle().sort_u64_order(_ptr(key, ctypes.c_uint64), n, _ptr(order, ctypes.c_int64))
    else:
        order = np.lexsort((rid, canon))
    return rid[order], pos[order], canon[order], ori[order]


def _pairs(rid, pos, canon, ori, lengths, k: int, max_occ: int):
    lib = _lib_handle()
    arrs = [np.ascontiguousarray(x) for x in (rid, pos, canon, ori)]
    cap = max(int(rid.shape[0]) * 8, 1 << 16)
    while True:
        out = [np.empty(cap, np.int32) for _ in range(4)]
        got = lib.match_seed_pairs(_ptr(arrs[0], ctypes.c_int32), _ptr(arrs[1], ctypes.c_int32),
                                   _ptr(arrs[2], ctypes.c_uint64), _ptr(arrs[3], ctypes.c_uint8),
                                   rid.shape[0], _ptr(lengths, ctypes.c_int32), k, max_occ, -1, 1,
                                   *(_ptr(o, ctypes.c_int32) for o in out), cap)
        if got >= 0:
            return [o[:got] for o in out]
        cap *= 2


def _histogram(a, b, st, diag, n_reads: int, diag_band: int, min_seeds: int):
    lib = _lib_handle()
    cap = max(int(a.shape[0]), 1024)
    while True:
        out = [np.empty(cap, np.int32) for _ in range(5)]
        got = lib.pair_histogram(*(_ptr(x, ctypes.c_int32) for x in (a, b, st, diag)), a.shape[0],
                                 n_reads, diag_band, min_seeds, *(_ptr(o, ctypes.c_int32) for o in out), cap)
        if got >= 0:
            return [o[:got] for o in out]
        cap *= 2


def candidates(codes: np.ndarray, lengths: np.ndarray, p: SeedParams) -> Candidates:
    """Candidate overlap pairs of a read set, as the port's ``overlap_reads``
    seeds them (minimizers, one sort, presorted matching, histogram)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    seeds = _sort(*_minimizers(codes, lengths, p.k, p.window), p.k)
    a, b, st, diag = _pairs(*seeds, lengths, p.k, p.max_occ)
    if a.shape[0] == 0:
        z = np.zeros(0, np.int32)
        return Candidates(z, z, z, z)
    a_u, b_u, st_u, d0, _cnt = _histogram(a, b, st, diag, lengths.shape[0], p.diag_band, p.min_seeds)
    return Candidates(a_id=a_u, b_id=b_u, strand=st_u, diag=d0)


def reorder(c: Candidates, rng) -> Candidates:
    """The same candidate pairs in an order drawn from ``rng``: every seed
    gives the same work, batched differently."""
    perm = rng.permutation(len(c))
    return Candidates(a_id=c.a_id[perm], b_id=c.b_id[perm], strand=c.strand[perm], diag=c.diag[perm])
