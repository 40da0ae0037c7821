"""Shared fixtures of the benchmark's CPU tests: a tiny configuration
added as a file beside copies of the benchmark's own data files, and two
cells on it (one device, a mesh of two) added as BENCHMARK.json entries."""
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)

TINY_SIM = dict(genome_len=6000, ploidy=2, coverage=5, mean_read_len=700, min_read_len=400,
                error_rate=0.06, snv_rate=0.0, indel_rate=0.0, hotspots=2, hotspot_width=600,
                hotspot_rate=0.15, read_len_spread=0.2)


TINY_CELLS = [{"name": name, "config": "tiny", "traffic": "full_pass", "chips": chips, "why": "CPU test cell"}
              for name, chips in (("tiny.extend", 1), ("tiny.extend.mesh2", 2))]


@pytest.fixture(scope="session")
def bench():
    """BENCHMARK.json with two dummy cells added as entries."""
    with open(ROOT / "BENCHMARK.json") as fh:
        b = json.load(fh)
    b["workloads"] = b["workloads"] + TINY_CELLS
    return b


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A catalog root holding the benchmark's files plus a dummy
    configuration, added as a file only."""
    root = tmp_path_factory.mktemp("catalog")
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub, root / sub)
    cfg = json.loads((root / "configs" / "c6_s288c_haploid.json").read_text())
    cfg["sim"] = dict(TINY_SIM, seed=3)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    return root
