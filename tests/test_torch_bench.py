"""The port's headline bench (``phasm_tpu_torch.bench``) on the CPU: its
``make_batch`` equals the root ``bench.make_batch`` array for array, and
``main`` prints exactly one JSON line with the production metric's name
(device ``cpu``, family ``dp_core``, band 64, J = 1024) and a positive
value.  The kernel-only line runs on the card only."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from phasm_tpu_torch import bench

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers


def _reference_bench():
    path = Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("reference_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,n_reads,read_len,n_pairs,jmax", [
    (0, 64, 1200, 96, 1024),
    (7, 40, 4096, 50, 2048),
])
def test_make_batch_equals_reference(seed, n_reads, read_len, n_pairs, jmax):
    want = _reference_bench().make_batch(
        np.random.default_rng(seed), n_reads, read_len, n_pairs, jmax)
    got = bench.make_batch(np.random.default_rng(seed), n_reads, read_len, n_pairs, jmax)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_main_prints_one_metric_line(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "overlap_alignments_per_sec_per_chip[cpu,production,dp_core,band64,j1024]"
    assert line["unit"] == "alignments/s/chip" and line["vs_baseline"] is None
    assert line["value"] > 0


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
