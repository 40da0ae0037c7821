"""The CUDA source of W-band kernels 3 and 4 (``csrc/wband.cu``), built for
the host with g++ through ``csrc/host_warp_shim.h`` (a warp's 32 lanes run
as fibers that meet at every warp collective), == their plain versions,
integer for integer: kernel 3 against ``wband_plain`` at every width class
on pairs at the resident matrix's edges, in column order and reversed, at a
J that is no multiple of 8, on a matrix laid against inaccessible pages so
that any read outside it faults; kernel 4 against ``wband_dense_plain``.

This guards the kernels' index arithmetic (the segmented shuffles at 8, 16
and 32 lanes a pair, the step vote, the live-column stop, the resident
code source's word funnel and its clamped byte path) on a machine without
a card.  The library is cached in the git-ignored ``build/phasm_tpu_torch/``,
keyed by the two files' contents and the flags.
"""
import ctypes
import hashlib
import mmap
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from phasm_tpu_torch._build import ENTRIES
from phasm_tpu_torch.overlap import extend as X

from torch_cases import resident_pairs

_CSRC = Path(__file__).resolve().parent.parent / "phasm_tpu_torch" / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "phasm_tpu_torch"
_FLAGS = ["-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-x", "c++", "-DPHASM_HOST_SHIM",
          "-include", str(_CSRC / "host_warp_shim.h")]
_PAGE = mmap.PAGESIZE


@pytest.fixture(scope="module")
def lib():
    h = hashlib.sha256()
    for name in ("host_warp_shim.h", "wband.cu"):
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS[:-1]).encode())
    so = _BUILD / f"libwband_host_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_CSRC / "wband.cu")], check=True)
        os.replace(tmp, so)
    out = ctypes.CDLL(str(so))
    for name in ("phasm_wband", "phasm_wband_dense"):
        getattr(out, name).argtypes = ENTRIES[name]
        getattr(out, name).restype = ctypes.c_int
    return out


_pages = []  # the guarded mappings stay alive as long as the module


def _guarded(arr: np.ndarray, at_end: bool) -> torch.Tensor:
    """A copy of arr in a mapping whose pages before and after are
    inaccessible, laid against the page after (at_end) or before it."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    n = arr.size
    pages = (n + _PAGE - 1) // _PAGE
    m = mmap.mmap(-1, (pages + 2) * _PAGE)
    base = ctypes.addressof(ctypes.c_char.from_buffer(m))
    t = torch.frombuffer(m, dtype=torch.uint8, count=n,
                         offset=_PAGE + (pages * _PAGE - n if at_end else 0))
    t.copy_(torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)))
    for at in (base, base + (pages + 1) * _PAGE):
        assert libc.mprotect(at, _PAGE, 0) == 0  # PROT_NONE
    _pages.append(m)
    return t.view(arr.shape)


def _kernel3(lib, codes, lengths, a, b, d, W, J, order):
    out = torch.full((5, a.shape[0]), -7, dtype=torch.int32)
    err = lib.phasm_wband(order.data_ptr(), a.data_ptr(), b.data_ptr(), d.data_ptr(),
                          lengths.data_ptr(), codes.data_ptr(), codes.shape[0], codes.shape[1],
                          a.shape[0], W, J, out.data_ptr(), None)
    assert err == 0
    return out


def _equal(got, want):
    assert torch.equal(got, torch.stack([w.int() for w in want]))


@pytest.mark.parametrize("W", [20, 64, 128, 200, 256, 300, 512])
def test_wband_kernels_match_plain_on_the_host(lib, W):
    rng = np.random.default_rng(500 + W)
    oriented, lengths, a_oid, b_oid, d0 = resident_pairs(rng, 10, 300, W)
    lens = torch.from_numpy(lengths)
    a, b, d = (torch.from_numpy(x) for x in (a_oid, b_oid, d0))
    la, lb = lens[a.long() >> 1], lens[b.long() >> 1]
    for J, at_end in ((500, True), (512, False)):
        codes = _guarded(oriented, at_end)
        want = X.wband_plain(codes, lens, a, b, d, W, J)
        order = X.column_order(X.dense_live_cols(la, lb, d, W, J), J)
        _equal(_kernel3(lib, codes, lens, a, b, d, W, J, order), want)
        _equal(_kernel3(lib, codes, lens, a, b, d, W, J, order.flip(0).contiguous()), want)
    if W <= X.DENSE_MAX_BAND:  # kernel 4, the same body on staged windows
        a2, b2, la32, lb32 = X.stage_pairs(codes, lens, a, b, d, W, J)
        out = torch.full((5, a.shape[0]), -7, dtype=torch.int32)
        err = lib.phasm_wband_dense(order.data_ptr(), a2.data_ptr(), b2.data_ptr(), la32.data_ptr(),
                                    lb32.data_ptr(), d.data_ptr(), a.shape[0], W, J,
                                    out.data_ptr(), None)
        assert err == 0
        _equal(out, want)
