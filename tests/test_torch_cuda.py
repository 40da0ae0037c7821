"""CUDA kernels (phasm_tpu_torch/csrc) == their plain torch versions on
the card, integer for integer, on the random cases of tests/test_myers.py.

Needs a CUDA card and nvcc (the kernels build at first use); skips
without a card.  Run on the card, whose machine has no JAX (so skip
tests/conftest.py, which imports it):
    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from phasm_tpu_torch.overlap import extend as X
from phasm_tpu_torch.overlap import myers as plain
from phasm_tpu_torch.overlap import myers_cuda as MC
from phasm_tpu_torch.overlap.myers_cuda import index_tensors
from phasm_tpu_torch.state import DeviceReads

from test_myers import as_oriented, random_overlap_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_reads():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    def make(seed, B=64, la_max=700, err=0.1):
        rng = np.random.default_rng(seed)
        a, b, la, lb, d0 = random_overlap_case(rng, B=B, la_max=la_max, err=err)
        oriented, lengths, a_oid, b_oid = as_oriented(a, b, la, lb)
        reads = DeviceReads.from_arrays(oriented, lengths, "cuda")
        return reads, index_tensors(reads.device, a_oid, b_oid, d0)

    return make


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("W", [64, 128])
def test_myers_kernels_match_plain(cuda_reads, W):
    reads, (a, b, d) = cuda_reads(W)
    J = 1024
    n0, r0 = MC.myers_fwd_launches, MC.myers_rev_launches
    fwd = MC.myers_fwd(reads, a, b, d, W, J)
    _equal(fwd, plain.fwd_plain(reads.codes, reads.lengths, a, b, d, W, J))
    ie, je = fwd[1], fwd[2]
    rev = MC.myers_rev(reads, a, b, d, ie, je, W, J)
    _equal(rev, plain.rev_plain(reads.codes, reads.lengths, a, b, d, ie, je, W, J))
    assert (MC.myers_fwd_launches, MC.myers_rev_launches) == (n0 + 1, r0 + 1)


@pytest.mark.parametrize("W", [20, 64, 96, 128, 200, 256, 512])
def test_wband_kernel_matches_plain(cuda_reads, W):
    reads, (a, b, d) = cuda_reads(W + 1, B=32, la_max=500)
    J = 1024
    n0 = X.wband_launches
    _equal(X.wband(reads, a, b, d, W, J), X.wband_plain(reads.codes, reads.lengths, a, b, d, W, J))
    assert X.wband_launches == n0 + 1


def test_kernels_reject_what_they_do_not_take(cuda_reads):
    reads, (a, b, d) = cuda_reads(1, B=4, la_max=200)
    with pytest.raises(ValueError):
        MC.myers_fwd(reads, a.long(), b, d, 64, 1024)
    with pytest.raises(ValueError):
        MC.myers_fwd(reads, a, b, d, 256, 1024)
    with pytest.raises(ValueError):
        X.wband(reads, a, b, d, 513, 1024)


def test_extender_runs_every_kernel_band_through_the_kernel(cuda_reads):
    """A band that is not a multiple of 32 at a long bucket (W-band
    routing) reaches kernel 3 on the card, not the plain version."""
    reads, (a, b, d) = cuda_reads(7, B=16, la_max=500)
    ext = X.DeviceExtender(reads, band=64, backend="myers_pallas")
    n0 = X.wband_launches
    out, M = ext.extend_async(a.cpu().numpy(), b.cpu().numpy(), d.cpu().numpy(), 12288, band=96)
    assert X.wband_launches == n0 + 1 and M == 16
    _equal(out, X.wband_plain(reads.codes, reads.lengths, a, b, d, 96, 12288))
