"""The port's slice as a whole: simulate -> overlap -> assemble (filter,
layout, phasing, both polish rounds) gives byte-equal haplotig and contig
FASTA against the JAX reference, for the W-band family and for the Myers
routing; and the whole slice runs with JAX and the reference package made
unimportable, and no module of the port (nor chip_smoke.py) imports either.
"""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from phasm_tpu.overlap import OverlapConfig
from phasm_tpu.overlap import overlap_reads as ref_overlap
from phasm_tpu.phasing import PhaseConfig
from phasm_tpu.pipeline import PipelineConfig
from phasm_tpu.pipeline import assemble as ref_assemble
from phasm_tpu.sim import simulate_reads
from phasm_tpu_torch.overlap.engine import OverlapConfig as PortOverlapConfig
from phasm_tpu_torch.overlap.engine import overlap_reads
from phasm_tpu_torch.phasing import PhaseConfig as PortPhaseConfig
from phasm_tpu_torch.pipeline import PipelineConfig as PortPipelineConfig
from phasm_tpu_torch.pipeline import assemble
from phasm_tpu_torch.state import readset_from_arrays

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reads():
    rs, _ = simulate_reads(
        seed=4, genome_len=12_000, ploidy=2, coverage=8, mean_read_len=1500,
        error_rate=0.03, hotspots=2, hotspot_rate=0.12, hotspot_width=1500,
        read_len_spread=0.2,
    )
    return rs


PIPE_ARGS = dict(
    min_read_length=500, min_overlap_length=500, max_error_rate=0.12,
    length_fuzz=300, evidence_max_error=0.5, adaptive_error=True, polish=True,
)
PIPE = PipelineConfig(phase=PhaseConfig(ploidy=2), **PIPE_ARGS)
PORT_PIPE = PortPipelineConfig(phase=PortPhaseConfig(ploidy=2), **PIPE_ARGS)


@pytest.mark.parametrize("ref_backend,port_backend", [("jnp", "jnp"), ("myers", "myers_pallas")])
def test_slice_fasta_byte_equal(reads, tmp_path, ref_backend, port_backend):
    want_tab = ref_overlap(reads, OverlapConfig(min_overlap=500, backend=ref_backend))
    want = ref_assemble(reads, want_tab, PIPE)
    port_reads = readset_from_arrays(reads.codes, reads.lengths, reads.names)
    got_tab = overlap_reads(
        port_reads, PortOverlapConfig(min_overlap=500, backend=port_backend), device="cpu"
    )
    assert np.array_equal(got_tab.as_matrix(), want_tab.as_matrix())
    got = assemble(port_reads, got_tab, PORT_PIPE, device="cpu")
    assert got.stats == want.stats
    assert want.stats["n_haplotigs"] > 0
    want.write_fasta(str(tmp_path / "ref.fa"))
    got.write_fasta(str(tmp_path / "port.fa"))
    assert (tmp_path / "port.fa").read_bytes() == (tmp_path / "ref.fa").read_bytes()


GUARD = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError
    sys.modules["phasm_tpu"] = None  # and so does any import of the reference
    sys.modules["bench"] = None  # and of the reference's bench and scripts
    sys.modules["scripts"] = None
    from phasm_tpu_torch import bench, cli, configs, ladder  # noqa: F401
    from phasm_tpu_torch.overlap import myers_cuda
    from phasm_tpu_torch.overlap import extend
    out = sys.argv[1]
    cli.main(["simulate", "--out", out + "/reads.fa", "--seed", "2", "--genome-len",
              "8000", "--coverage", "8", "--read-len", "1500", "--hotspots", "1",
              "--hotspot-rate", "0.1", "--read-len-spread", "0.2"])
    cli.main(["pipeline", out + "/reads.fa", "--out", out + "/asm.fa", "--device", "cpu",
              "--backend", "myers_pallas", "--min-overlap-length", "500",
              "--length-fuzz", "300", "--adaptive-error", "--polish"])
    assert open(out + "/asm.fa").read().startswith(">")
    assert sys.modules["jax"] is None
    assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "phasm_tpu."))
                   for m, v in sys.modules.items() if v is not None)
    assert myers_cuda.myers_fwd_launches == 0 and extend.wband_launches == 0
    print("NO_JAX_OK")
""")


def test_slice_runs_without_jax(tmp_path):
    """Subprocess (tests/conftest.py imports jax into every test process):
    the CLI's simulate + pipeline on the CPU with jax and phasm_tpu
    unimportable."""
    env = dict(
        os.environ, OMP_NUM_THREADS="1",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
    )
    res = subprocess.run(
        [sys.executable, "-c", GUARD, str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path),
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout


def _imports(path):
    """(line, module) of every import statement in a file, however nested."""
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            yield from ((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_port_imports_neither_jax_nor_the_reference():
    """Static guard: no import statement anywhere in phasm_tpu_torch/ or
    chip_smoke.py names jax or phasm_tpu, or the reference's top-level
    ``bench`` or ``scripts`` (the port keeps its own bench and ladder
    runner), at module level or inside a function (where the subprocess
    guard would not reach it)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "phasm_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [
        (os.path.relpath(f, REPO), line, mod)
        for f in files for line, mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "phasm_tpu", "bench", "scripts")
    ]
    assert bad == []
