"""Port transitive reduction (phasm_tpu_torch.graph.transitive) == the
reference's ``reduce_mask_np`` and ``reduce_mask_jax``, with and without
the dirty-edge veto, on random graphs and on one graph past the 4096-edge
``auto`` threshold."""
import numpy as np
import pytest
import torch

from phasm_tpu.graph.transitive import reduce_mask_jax, reduce_mask_np
from phasm_tpu.graph.transitive import remove_transitive_edges as ref_remove
from phasm_tpu_torch.graph.transitive import reduce_mask_torch, remove_transitive_edges

from test_graph import random_graph

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers


def _check(g, fuzz, dirty):
    got = reduce_mask_torch(g, fuzz, dirty, device="cpu")
    assert np.array_equal(got, reduce_mask_np(g, fuzz, dirty))
    assert np.array_equal(got, reduce_mask_jax(g, fuzz, dirty))
    return got


@pytest.mark.parametrize("seed", range(4))
def test_mask_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = random_graph(rng)
    dirty = rng.random(g.n_edges) < 0.3
    for fuzz in (0, 10, 1000):
        _check(g, fuzz, None)
        _check(g, fuzz, dirty)


def test_large_graph_auto_path_matches_reference():
    rng = np.random.default_rng(7)
    g = random_graph(rng, n_reads=600, n_edges=9000, max_elen=400)
    assert g.n_edges >= 4096
    dirty = rng.random(g.n_edges) < 0.1
    for d in (None, dirty):
        mask = _check(g, 300, d)
        assert mask.any() and not mask.all()
        got = remove_transitive_edges(g, fuzz=300, impl="auto", dirty=d, device="cpu")
        want = ref_remove(g, fuzz=300, impl="np", dirty=d)
        assert np.array_equal(got.src, want.src) and np.array_equal(got.dst, want.dst)
