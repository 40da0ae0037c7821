"""A whole run of a cell made from files alone, on the CPU (the harness's
look for a card skipped), and the same run with the timed path broken
underneath: each fault must turn ``correct`` false.  Also the control at a
size a test holds, and the run's refusals."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference import check

from conftest import ROOT

SEED = 2**33 + 17


def _run(bench, tiny_root, wrap=None, cell="tiny.extend"):
    result = run.run(cell, SEED, 0.1, False, kind="cpu", root=tiny_root, bench=bench, wrap=wrap)
    json.dumps(result)  # the result line is JSON
    return result


def test_a_cell_from_files_alone_runs_correct(bench, tiny_root):
    r = _run(bench, tiny_root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"pairs_per_s", "setup_s"}
    assert list(r)[-1] == "checks"
    assert r["checks"]["mismatched_results"] == {"value": 0, "limit": 0}
    assert r["checks"]["results_compared"]["value"] > 0


def test_a_mesh_cell_runs_correct(bench, tiny_root):
    assert _run(bench, tiny_root, cell="tiny.extend.mesh2")["correct"]


class _Fault:
    """The program's extender with one fault planted in its answers."""

    def __init__(self, inner, kind):
        self.inner, self.kind, self.sizes = inner, kind, {}

    def extend_async(self, a, b, d, J, band=None):
        if self.kind == "half_left_out":  # only the first half of the batch runs
            h = a.shape[0] // 2
            out, _ = self.inner.extend_async(a[:h], b[:h], d[:h], J, band=band)
            return (out, h, a.shape[0]), a.shape[0]
        return self.inner.extend_async(a, b, d, J, band=band)

    def materialize(self, out, M):
        if self.kind == "half_left_out":
            out, h, n = out
            r = self.inner.materialize(out, h)
            for f in ("a_start", "a_end", "b_end", "diffs", "win_cost", "b_start"):
                v = getattr(r, f)
                setattr(r, f, np.concatenate([v, np.zeros(n - h, v.dtype)]))
            return r
        if self.kind == "exchange_left_out":  # the other cards' rows never arrive
            (shards, chunk), _ = out, None
            shards = [shards[0]] + [torch.zeros_like(s) for s in shards[1:]]
            return self.inner.materialize((shards, chunk), M)
        r = self.inner.materialize(out, M)
        if self.kind == "answer_altered":  # one answer of each batch off by one edit
            r.diffs = r.diffs.copy()
            r.diffs[M // 2] += 1
        elif self.kind == "state_unchanged":  # the output left as allocated
            for f in ("a_start", "a_end", "b_end", "diffs", "win_cost"):
                setattr(r, f, np.zeros_like(getattr(r, f)))
        return r


@pytest.mark.parametrize("kind,cell", [
    ("answer_altered", "tiny.extend"),
    ("half_left_out", "tiny.extend"),
    ("state_unchanged", "tiny.extend"),
    ("exchange_left_out", "tiny.extend.mesh2"),
])
def test_a_broken_timed_path_is_not_correct(bench, tiny_root, kind, cell):
    r = _run(bench, tiny_root, wrap=lambda ext: _Fault(ext, kind), cell=cell)
    assert not r["correct"]
    assert r["checks"]["mismatched_results"]["value"] > r["checks"]["mismatched_results"]["limit"]


def test_the_control_fails_the_limit(bench, tiny_root):
    """The reference at half of each group's band, in the program's place."""
    cell = run.catalog.load_cell("tiny.extend", bench, tiny_root)
    p = run.prepare(cell, SEED, run.make_traffic(cell), kind="cpu")
    p.ext = None
    bad, seen = check.mismatches([[run.reference(p, band_divisor=2), 1]], run.reference(p))
    assert seen > 0 and bad > check.LIMITS["mismatched_results"]


def _cli(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "c6.extend", "--seed",
                           str(SEED), "--seconds", "1", *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=600)


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    res = _cli(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".build", "__pycache__"))
    res = _cli(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """Runs only where a card is: c6.extend once, as the check does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = _cli(ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
