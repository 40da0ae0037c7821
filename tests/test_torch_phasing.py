"""Port phasing (phasm_tpu_torch.phasing) == the JAX reference: the
batched torch scorer against ``_get_jit_score`` / ``_get_jit_score_v``
within float32 tolerance (torch and XLA ``log`` and reduction order may
differ in the last ulp), and identical decisions (surviving candidates,
read assignments, haplotype paths, phase breaks) on the tests/test_phasing*
scenarios, sequential and lockstep-batched.
"""
import numpy as np
import pytest
import torch

from phasm_tpu.bubbles import build_chains, find_superbubbles
from phasm_tpu.bubbles_linear import find_superbubbles_linear
from phasm_tpu.phasing import PhaseConfig, _ChainDP, _get_jit_score, _get_jit_score_v
from phasm_tpu.phasing import phase_all as ref_phase_all
from phasm_tpu.phasing import read_touch_errs
from phasm_tpu_torch.phasing import phase_all, score_step

from test_phasing import chain_fixture
from test_phasing_batch import many_chains_fixture
from test_phasing_stress import long_chain_fixture

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers

RTOL, ATOL = 1e-5, 1e-4


def _decisions(r):
    return (
        r.haplotype_choices,
        [tuple(p) for p in r.haplotype_paths],
        [h.tobytes() for h in r.haplotigs],
        r.n_candidates_final,
        sorted((k, tuple(v)) for k, v in r.read_assignment.items()),
        r.phase_breaks,
    )


def _port_score(args_list, cfg):
    st = [torch.from_numpy(np.stack([a[j] for a in args_list])) for j in range(8)]
    err = torch.tensor(cfg.err, dtype=torch.float32)
    beta = torch.tensor(cfg.coverage_weight, dtype=torch.float32)
    return score_step(*st[:7], err, beta, st[7]).numpy()


def _assert_close(want, got):
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def test_scorer_matches_reference_single_and_batched():
    cfg = PhaseConfig(ploidy=2)
    # one chain, every bubble step: the unbatched reference scorer
    ug, reads, aln, _ = chain_fixture(link="parallel")
    chain = build_chains(ug, find_superbubbles(ug))[0]
    dp = _ChainDP(ug, reads, aln, chain, cfg, read_touch_errs(ug, reads.n_reads, aln))
    for i in range(dp.n_b):
        args, meta = dp.prep(i)
        want = _get_jit_score()(*args[:7], np.float32(cfg.err), np.float32(cfg.coverage_weight), args[7])
        _assert_close(want, _port_score([args], cfg)[0])
        dp.apply(meta, np.asarray(want)[: meta[1], : meta[2]])
    # same-shape chains stacked: the vmapped reference scorer
    ug, reads, aln, _ = many_chains_fixture(4, n_bubbles=3)
    chains = build_chains(ug, find_superbubbles_linear(ug))
    touch = read_touch_errs(ug, reads.n_reads, aln)
    group = [_ChainDP(ug, reads, aln, c, cfg, touch).prep(0)[0] for c in chains]
    assert len({tuple(a.shape for a in g) for g in group}) == 1
    stacked = [np.stack([g[j] for g in group]) for j in range(8)]
    want = _get_jit_score_v()(*stacked[:7], np.float32(cfg.err), np.float32(cfg.coverage_weight), stacked[7])
    _assert_close(want, _port_score(group, cfg))


@pytest.mark.parametrize("n_arms,link,k", [(2, "parallel", 2), (2, "crossed", 2), (3, "parallel", 3)])
def test_chain_fixture_decisions_match_reference(n_arms, link, k):
    ug, reads, aln, _ = chain_fixture(n_arms=n_arms, link=link)
    chains = build_chains(ug, find_superbubbles(ug))
    cfg = PhaseConfig(ploidy=k)
    want = ref_phase_all(ug, reads, aln, chains, cfg)
    got = phase_all(ug, reads, aln, chains, cfg, device="cpu")
    for w, g in zip(want, got, strict=True):
        assert _decisions(g) == _decisions(w)
        assert g.score == pytest.approx(w.score, rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("batch", [True, False])
def test_many_chains_lockstep_matches_reference(batch):
    ug, reads, aln, _ = many_chains_fixture(7, n_bubbles=3, vary=True)
    chains = build_chains(ug, find_superbubbles_linear(ug))
    cfg = PhaseConfig(ploidy=2)
    want = ref_phase_all(ug, reads, aln, chains, cfg, batch=batch)
    got = phase_all(ug, reads, aln, chains, cfg, batch=batch, device="cpu")
    for w, g in zip(want, got, strict=True):
        assert _decisions(g) == _decisions(w)
        assert g.score == pytest.approx(w.score, rel=RTOL, abs=ATOL)


def test_tetraploid_chain_matches_reference():
    ug, reads, aln, _ = long_chain_fixture(8, [4] * 8, k=4)
    chains = build_chains(ug, find_superbubbles(ug))
    cfg = PhaseConfig(ploidy=4)
    want = ref_phase_all(ug, reads, aln, chains, cfg)
    got = phase_all(ug, reads, aln, chains, cfg, device="cpu")
    for w, g in zip(want, got, strict=True):
        assert _decisions(g) == _decisions(w)
        assert g.score == pytest.approx(w.score, rel=RTOL, abs=ATOL)
