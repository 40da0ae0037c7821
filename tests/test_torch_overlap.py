"""Port overlap engine (phasm_tpu_torch.overlap.engine) == the JAX
reference engine: the whole alignment table (``as_matrix()`` and ``win``)
on a small simulated diploid read set, for the W-band family (``jnp`` on
both sides) and for the port's Myers routing (``myers_pallas``) against the
reference's ``myers`` backend, plus the blocked engine.
"""
import numpy as np
import pytest
import torch

from phasm_tpu.overlap import OverlapConfig
from phasm_tpu.overlap import overlap_reads as ref_overlap
from phasm_tpu.overlap.engine import _bucket_edges, _normalize_candidates
from phasm_tpu.overlap import seeding
from phasm_tpu.sim import simulate_reads
from phasm_tpu_torch.overlap import extend as X
from phasm_tpu_torch.overlap.engine import overlap_reads

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers


@pytest.fixture(scope="module")
def reads():
    rs, _ = simulate_reads(
        seed=3, genome_len=12_000, ploidy=2, coverage=8, mean_read_len=1500,
        error_rate=0.04, hotspots=2, hotspot_rate=0.1, hotspot_width=1500,
        read_len_spread=0.2,
    )
    return rs


@pytest.fixture(scope="module")
def ref_wband(reads):
    return ref_overlap(reads, OverlapConfig(min_overlap=500, backend="jnp"))


def _same(want, got):
    assert len(got) == len(want) > 0
    assert np.array_equal(got.as_matrix(), want.as_matrix())
    assert np.array_equal(got.win, want.win)


def test_overlap_wband_matches_reference(reads, ref_wband):
    cfg = OverlapConfig(min_overlap=500, backend="jnp")
    _same(ref_wband, overlap_reads(reads, cfg, device="cpu"))


def test_overlap_myers_routing_matches_reference_myers(reads):
    """The port's myers_pallas routing and the reference's myers backend
    agree whenever every bucket at bands <= 128 routes to Myers (J <= 8192
    here); asserted first."""
    cfg = OverlapConfig(min_overlap=500, backend="myers_pallas")
    lengths = reads.lengths.astype(np.int32)
    seeds = seeding.sort_seeds(seeding.extract_minimizers(reads.codes, lengths, cfg.seed))
    cands = seeding.match_seeds(seeds, lengths, cfg.seed, presorted=True)
    *_, ka, kb, kd, la, lb, _ = _normalize_candidates(cands, lengths, cfg.band)
    for W in (cfg.band,) + tuple(w for w in cfg.wide_bands if w <= X.MYERS_MAX_BAND):
        need = np.minimum(lb, la - kd + W).astype(np.int64) + W
        for J in _bucket_edges(need, cfg):
            assert X.route("myers_pallas", W, J) == "myers", (W, J)
    want = ref_overlap(reads, OverlapConfig(min_overlap=500, backend="myers"))
    _same(want, overlap_reads(reads, cfg, device="cpu"))


def test_blocked_engine_matches_reference(reads, ref_wband):
    cfg = OverlapConfig(min_overlap=500, backend="jnp")
    _same(ref_wband, overlap_reads(reads, cfg, n_blocks=2, device="cpu"))
