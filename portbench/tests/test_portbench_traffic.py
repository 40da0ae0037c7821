"""The traffic generator's frozen copies against the port they were copied
from, at a tiny size: the same reads, the same candidates, and the same
device calls (batches, buckets, chunks, retries) as the engine makes."""
import numpy as np
import pytest

from portbench import run
from portbench.traffic import batches, seeding, sim
from phasm_tpu_torch import sim as port_sim
from phasm_tpu_torch.overlap import engine, routing
from phasm_tpu_torch.overlap import seeding as port_seeding
from phasm_tpu_torch.state import readset_from_arrays

from conftest import TINY_SIM


def test_reads_follow_the_seed_and_equal_the_port_simulator():
    codes, lengths = sim.simulate_reads(seed=2**33 + 5, **TINY_SIM)
    again = sim.simulate_reads(seed=2**33 + 5, **TINY_SIM)
    other = sim.simulate_reads(seed=2**33 + 6, **TINY_SIM)
    assert np.array_equal(codes, again[0]) and np.array_equal(lengths, again[1])
    assert not np.array_equal(lengths, other[1])
    rs, _ = port_sim.simulate_reads(seed=2**33 + 5, **TINY_SIM)
    assert np.array_equal(codes, rs.codes) and np.array_equal(lengths, rs.lengths)
    assert np.array_equal(sim.oriented_matrix(codes, lengths), rs.oriented_codes_matrix())


def test_candidates_equal_the_port_seeding():
    codes, lengths = sim.simulate_reads(seed=11, **TINY_SIM)
    got = seeding.candidates(codes, lengths, seeding.SeedParams())
    cfg = port_seeding.SeedConfig()
    seeds = port_seeding.sort_seeds(port_seeding.extract_minimizers(codes, lengths, cfg))
    want = port_seeding.match_seeds(seeds, lengths, cfg, presorted=True)
    assert len(got) == len(want) > 0
    for f in ("a_id", "b_id", "strand", "diag"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("W", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("J", [1024, 2048, 4096, 8192, 12288, 16384, 32768])
@pytest.mark.parametrize("backend", ["myers_pallas", "myers", "pallas", "jnp"])
def test_routing_equals_the_port(W, J, backend):
    assert batches.route(backend, W, J) == routing.route(backend, W, J)


class _Recorder(engine.DeviceExtender):
    calls: list = []

    def extend_async(self, a_oid, b_oid, d0, jmax, band=None):
        type(self).calls.append((self.band if band is None else band, jmax,
                                 np.asarray(a_oid).copy(), np.asarray(b_oid).copy(), np.asarray(d0).copy()))
        return super().extend_async(a_oid, b_oid, d0, jmax, band=band)


def test_pass_equals_the_engine_calls(monkeypatch, bench, tiny_root):
    """Every device call of the harness's warm pass (first pass, then each
    retry band) equals the engine's own, in order, chunking included, with
    the candidates in the engine's order."""
    seed = 7
    codes, lengths = sim.simulate_reads(seed=3, **TINY_SIM)  # the tiny configuration's read set
    monkeypatch.setattr(run.seeding, "reorder", lambda c, rng: c)
    monkeypatch.setattr(engine, "DeviceExtender", _Recorder)
    monkeypatch.setattr(engine, "_MAX_BATCH", 64)
    monkeypatch.setattr(batches, "MAX_BATCH", 64)
    _Recorder.calls = []
    cfg = engine.OverlapConfig(min_overlap=1000, backend="myers_pallas")
    engine.overlap_reads(readset_from_arrays(codes, lengths), cfg, device="cpu")
    want = list(_Recorder.calls)

    cell = run.catalog.load_cell("tiny.extend", bench, tiny_root)
    p = run.prepare(cell, seed, run.make_traffic(cell), kind="cpu")
    got = [c for calls in p.stages for c in calls]
    assert len(want) == len(got) > 2 and any(c.W > 64 for c in got)
    for (W, J, a, b, d), c in zip(want, got):
        assert (W, J) == (c.W, c.J)
        assert np.array_equal(a, c.a) and np.array_equal(b, c.b) and np.array_equal(d, c.d)
    assert sum(c.a.shape[0] for c in got if c.W == 64) == len(p.frame)


def test_the_seed_orders_the_same_work(bench, tiny_root):
    """Two seeds: the same pairs, each at the same bands, in other orders."""
    cell = run.catalog.load_cell("tiny.extend", bench, tiny_root)

    traffic = run.make_traffic(cell)

    def work(seed):
        p = run.prepare(cell, seed, traffic, kind="cpu")
        calls = [c for calls in p.stages for c in calls]
        return [(c.W, tuple(sorted(zip(c.a.tolist(), c.b.tolist(), c.d.tolist())))) for c in calls], calls

    (w1, c1), (w2, c2) = work(1), work(2**40 + 3)
    by_band = lambda w: {W: sorted(p for V, ps in w if V == W for p in ps) for W in {V for V, _ in w}}  # noqa: E731
    assert by_band(w1) == by_band(w2)
    assert any(not np.array_equal(a.a, b.a) for a, b in zip(c1, c2))
