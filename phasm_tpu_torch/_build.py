"""Build ``csrc/*.cu`` with nvcc into one shared library and load it with
ctypes (plain C interface: no PyTorch headers, so the build takes seconds;
one nvcc per source, run in parallel, then one link).

The library lands in ``build/phasm_tpu_torch/lib<hash>.so`` at the repo
root, where the hash covers the sources' names and contents, so an edited
kernel is rebuilt and an unchanged one is reused.  The build happens at
first use.  Every C entry returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.  ``check_launch_inputs`` and
``index_tensors`` are the wrappers' shared argument plumbing;
``count_shape`` their per-shape launch record.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from phasm_tpu_torch import metrics

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "phasm_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P, I = ctypes.c_void_p, ctypes.c_int
# C entry -> argtypes (pointers and the stream as c_void_p, ints as c_int)
ENTRIES = {
    "phasm_myers_fwd": [P, P, P, P, P, P, I, P, I, I, I, I, P, P, P, P, P],
    "phasm_myers_rev": [P, P, P, P, P, P, P, P, I, P, I, I, I, I, P, P, P],
    "phasm_wband": [P, P, P, P, P, P, I, I, I, I, I, P, P],
    "phasm_wband_dense": [P, P, P, P, P, P, I, I, I, P, P],
    "phasm_myers_fwd_win": [P, P, P, P, P, I, I, I, P, P, P, P, P],
    "phasm_myers_rev_win": [P, P, P, P, P, I, I, I, P, P, P],
    "phasm_myers_fwd_fetch": [P, P, P, P, I, P, I, I, I, I, P, P, P],
    "phasm_myers_fwd_tab2": [P, P, P, P, P, I, I, I, I, I, P, P, P, P, P],
    "phasm_myers_rev_tab2": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P, P],
    "phasm_myers_tab2_lanes": [I, I, I, I],
}

_lib = None
build_info: dict = {}  # seconds, path, ptxas log of the build in this process


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: CUDA kernels cannot be built here")
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def _compile_all(so: Path) -> str:
    """One nvcc per source, all started together, then one link; returns
    the compilers' output (ptxas register and spill lines included)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [
        subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(_sources(), objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, so)
    return log


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    t0 = time.perf_counter()
    log = "" if so.exists() else _compile_all(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(seconds=time.perf_counter() - t0, path=str(so), log=log)
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def count_shape(name: str, B: int, W: int, J: int) -> None:
    """Record one launch of kernel name on B pairs at band W, column bucket
    J: metrics counters ``kernel.<name>.W<W>.J<J>`` (pairs) and
    ``kernel.<name>.W<W>.J<J>.launches``."""
    key = f"kernel.{name}.W{W}.J{J}"
    metrics.incr(key, B)
    metrics.incr(f"{key}.launches")


def check_launch_inputs(reads, table, *idx: torch.Tensor) -> None:
    """Raise unless the read set (a ``state.DeviceReads``), the kernel's
    table (when it reads one) and the per-pair vectors are what the CUDA
    kernels take: contiguous, uint8 codes / int32 lengths / int32 tables,
    equal-length int32 vectors, all on the reads' device."""
    dev = reads.device
    arrays = [("codes", reads.codes, torch.uint8, 2), ("lengths", reads.lengths, torch.int32, 1)]
    if table is not None:
        arrays.append(("table", table, torch.int32, 3))
    for name, t, dt, nd in arrays:
        if t.device != dev or t.dtype != dt or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {nd}-d on {dev}")
    check_pair_vectors(dev, *idx)


def check_pair_vectors(dev, *idx: torch.Tensor) -> None:
    """Raise unless every per-pair vector is a contiguous int32 [n] on dev."""
    n = idx[0].shape[0]
    for t in idx:
        if (
            t.device != dev or t.dtype != torch.int32 or t.dim() != 1
            or t.shape[0] != n or not t.is_contiguous()
        ):
            raise ValueError(f"per-pair vectors: expected contiguous int32 [{n}] on {dev}")


def index_tensors(device, *arrays: np.ndarray):
    """Host index vectors -> contiguous int32 device vectors (one upload)."""
    stacked = torch.from_numpy(
        np.stack([np.asarray(a, dtype=np.int32) for a in arrays])
    ).to(device)
    return tuple(stacked[i] for i in range(len(arrays)))
