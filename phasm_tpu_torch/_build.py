"""Build ``csrc/*.cu`` with nvcc into one shared library and load it with
ctypes (plain C interface: no PyTorch headers, so the build takes seconds).

The library lands in ``build/phasm_tpu_torch/lib<hash>.so`` at the repo
root, where the hash covers the sources' names and contents, so an edited
kernel is rebuilt and an unchanged one is reused.  The build happens at
first use.  Every C entry returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "phasm_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

P, I = ctypes.c_void_p, ctypes.c_int
# C entry -> argtypes (pointers and the stream as c_void_p, ints as c_int)
ENTRIES = {
    "phasm_myers_fwd": [P, P, P, P, P, I, P, I, I, I, I, P, P, P, P, P],
    "phasm_myers_rev": [P, P, P, P, P, P, P, I, P, I, I, I, I, P, P, P],
    "phasm_wband": [P, P, P, P, P, I, I, I, I, P, P],
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


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)
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
