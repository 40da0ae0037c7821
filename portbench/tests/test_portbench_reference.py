"""The plain reference against the port's plain versions at a tiny size:
the Myers-family DP (written cell by cell here) equals the port's
bit-vector Myers core, the W-band copy equals the port's dp_core path, and
groups run together give what each gives alone."""
import numpy as np
import pytest
import torch

from portbench.reference import check, myers_dp, wband_dp
from portbench.traffic import batches, seeding, sim
from phasm_tpu_torch.overlap import extend as port_extend
from phasm_tpu_torch.overlap import myers as port_myers


@pytest.fixture(scope="module")
def pairs():
    codes, lengths = sim.simulate_reads(seed=5, genome_len=20_000, ploidy=2, coverage=6,
                                        mean_read_len=2500, error_rate=0.06, hotspots=2,
                                        hotspot_rate=0.15, hotspot_width=800, read_len_spread=0.4)
    frame = batches.normalize(seeding.candidates(codes, lengths, seeding.SeedParams()), lengths)
    return (torch.from_numpy(sim.oriented_matrix(codes, lengths)), torch.from_numpy(lengths), frame)


def _case(pairs, n, seed, jitter):
    codes, lengths, f = pairs
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(f), n, replace=False)
    d = f.kd[idx].astype(np.int64) + rng.integers(-jitter, jitter + 1, n)  # off-seed diagonals too
    return codes, lengths, torch.from_numpy(f.ka[idx]), torch.from_numpy(f.kb[idx]), torch.from_numpy(np.maximum(d, 0))


@pytest.mark.parametrize("W,J", [(32, 1024), (64, 1024), (64, 2048), (128, 1024), (128, 4096)])
def test_myers_dp_equals_the_port_bit_vector_core(pairs, W, J):
    codes, lengths, a, b, d = _case(pairs, 120, W + J, 40)
    got = myers_dp.myers_pairs(codes, lengths, a, b, d, W, J)
    want = port_myers.pair_core(*port_myers._rows(codes, lengths, a.int(), b.int(), d.int()), W, J)
    for g, w in zip(got, want):
        assert torch.equal(g, w.long())
    assert int((got[0] < myers_dp.BIG).sum()) > 30  # most pairs find an endpoint


@pytest.mark.parametrize("W,J", [(64, 1024), (128, 2048), (256, 4096), (512, 1024)])
def test_wband_copy_equals_the_port_dp_core(pairs, W, J):
    codes, lengths, a, b, d = _case(pairs, 80, W * J, 40)
    got = wband_dp.wband_pairs(codes, lengths, a, b, d, W, J)
    want = port_extend.wband_plain(codes, lengths, a.int(), b.int(), d.int(), W, J)
    for g, w in zip(got, want):
        assert torch.equal(g, w.long())


def test_groups_run_together_equal_each_alone(pairs):
    codes, lengths, f = pairs
    rng = np.random.default_rng(1)
    groups = [(W, J, fam, rng.choice(len(f), 40, replace=False))
              for fam in ("myers", "wband") for W in (64, 128) for J in (1024, 2048, 4096)]
    assert any((f.lb[g[3]] > g[1]).any() for g in groups)  # pairs longer than their bucket
    got = check.reference_answers(codes, lengths, f, groups)
    off = 0
    for W, J, fam, idx in groups:
        a, b = torch.from_numpy(f.ka[idx]), torch.from_numpy(f.kb[idx])
        d = torch.from_numpy(f.kd[idx].astype(np.int64))
        want = torch.stack([x.long() for x in check.family_fn(fam)(codes, lengths, a, b, d, W, J)]).numpy()
        assert np.array_equal(got[:, off : off + idx.shape[0]], want), (fam, W, J)
        off += idx.shape[0]


def test_the_two_families_differ(pairs):
    """The routing matters: on the same pairs the Myers window and the
    W-band give different answers for some pairs."""
    codes, lengths, a, b, d = _case(pairs, 120, 3, 0)
    m = torch.stack(myers_dp.myers_pairs(codes, lengths, a, b, d, 64, 4096))
    w = torch.stack(wband_dp.wband_pairs(codes, lengths, a, b, d, 64, 4096))
    assert bool((m != w).any())
