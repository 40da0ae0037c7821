"""What the benchmark loads: no JAX and no JAX package anywhere, compared
by whole top-level names (``phasm_tpu_torch`` begins with ``phasm_tpu``),
and nothing of the program in the traffic generator or the reference."""
import ast
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "phasm_tpu"}
PKG = ROOT / "portbench"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "traffic").glob("*.py")) + sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "phasm_tpu_torch" not in set(_top_level_imports(path))


def test_what_the_harness_loads():
    """The harness, its readers and the program's modules the run loads,
    in a fresh interpreter: no forbidden top-level name among them."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import run, catalog\n"
        "from phasm_tpu_torch.overlap.engine import DeviceExtender\n"
        "from phasm_tpu_torch.parallel import make_mesh\n"
        "from phasm_tpu_torch.state import DeviceReads\n"
        "import torch.profiler\n"
        "bench = json.load(open(%r))\n"
        "for m in bench['end_to_end'] + bench['per_layer']: catalog.reader(m['name'])\n"
        "print(json.dumps(run.forbidden_modules()))\n" % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
