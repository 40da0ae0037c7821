"""The port's staged CLI (``phasm_tpu_torch.cli``) == the reference's
(``phasm_tpu.cli``), stage file for stage file, on the CPU.

Each stage of both CLIs gets the same input files and writes its own; text
files (LAdump, GFA2, haplotig FASTA, read-assignment TSV) must be
byte-equal and .npz tables equal array by array (zip members carry their
write times).  Read sets: the 8 kb haploid set and the 20 kb diploid set
with hotspots of ``test_io``'s CLI tests.  On the haploid set each CLI runs
every stage, the reference with ``--backend jnp`` and the port with
``--backend jnp --device cpu``; the diploid set's alignments come from one
reference ``overlap --backend myers`` (its W-band overlap costs over a
minute of CPU in the two packages together) and feed both CLIs' filter,
layout and phase.  A tiny read set holds the ``myers_pallas`` overlap
(interpret-mode Pallas in the reference, the kernels' plain versions in the
port) to the reference through LAdump text.
"""
import filecmp

import numpy as np
import pytest
import torch

from phasm_tpu import cli as ref_cli
from phasm_tpu_torch import cli as port_cli
from torch_cases import ensure_reference_native

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers
ensure_reference_native()  # before any test of this worker loads it

# test_io.test_cli_stage_pipeline's and test_cli_phase_content_matches_in_memory's
# read sets and filter settings
SETS = {
    "haploid": ("--seed 3 --genome-len 8000 --ploidy 1 --coverage 10 --read-len 2000 "
                "--error-rate 0.04", "0.15"),
    "diploid": ("--seed 9 --genome-len 20000 --ploidy 2 --coverage 14 --read-len 2500 "
                "--error-rate 0.03 --hotspots 2 --hotspot-rate 0.15 --hotspot-width 2000 "
                "--read-len-spread 0.2", "0.10"),
}
TINY = "--seed 5 --genome-len 1500 --ploidy 1 --coverage 4 --read-len 600 --error-rate 0.04 --read-len-spread 0.1"
CLIS = {"ref": (ref_cli, ""), "port": (port_cli, " --device cpu")}


def _main(cli, line: str) -> None:
    cli.main(line.split())


def _stages(d: str, max_err: str, aln: dict) -> None:
    """filter -> layout -> phase of both CLIs; aln[tag] is each one's
    overlap table."""
    for tag, (cli, dev) in CLIS.items():
        _main(cli, f"filter {d}/r.fa {aln[tag]} --out {d}/{tag}.f.npz --min-read-length 500 "
                   f"--min-overlap-length 400 --max-error-rate {max_err}")
        _main(cli, f"layout {d}/r.fa {d}/{tag}.f.npz --out {d}/{tag}.g.gfa2 --length-fuzz 400")
        _main(cli, f"phase {d}/r.fa {d}/{tag}.g.gfa2 {aln[tag]} --out {d}/{tag}.h.fa "
                   f"--read-assignment {d}/{tag}.h.tsv{dev}")


@pytest.fixture(scope="module")
def stage_dirs(tmp_path_factory):
    """{read set: directory holding both CLIs' stage files}, each set run
    once, at its first use."""
    done: dict = {}

    def get(name: str) -> str:
        if name not in done:
            d = str(tmp_path_factory.mktemp(name))
            sim, max_err = SETS[name]
            _main(ref_cli, f"simulate --out {d}/r.fa {sim}")
            if name == "haploid":
                for tag, (cli, dev) in CLIS.items():
                    _main(cli, f"overlap {d}/r.fa --out {d}/{tag}.a.npz --backend jnp{dev}")
                _stages(d, max_err, {tag: f"{d}/{tag}.a.npz" for tag in CLIS})
            else:
                _main(ref_cli, f"overlap {d}/r.fa --out {d}/a.npz --backend myers")
                _stages(d, max_err, {tag: f"{d}/a.npz" for tag in CLIS})
            done[name] = d
        return done[name]

    return get


def _npz_equal(a: str, b: str) -> int:
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files) and "win" in za.files, (za.files, zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k]), k
    return len(za["matrix"])


@pytest.mark.parametrize("case", [
    "haploid-a.npz", "haploid-f.npz", "haploid-g.gfa2", "haploid-h.fa", "haploid-h.tsv",
    "diploid-f.npz", "diploid-g.gfa2", "diploid-h.fa", "diploid-h.tsv",
])
def test_stage_file_matches_reference(stage_dirs, case):
    """One stage file of the port's CLI == the reference CLI's: overlap
    (.npz, haploid), filter (.npz), layout (GFA2), phase (haplotig FASTA,
    read-assignment TSV).  The diploid set's files must carry content: a
    graph that leaves reads out (phase remaps its node ids), haplotigs and
    assigned reads."""
    name, what = case.split("-")
    d = stage_dirs(name)
    ref, port = f"{d}/ref.{what}", f"{d}/port.{what}"
    if what.endswith(".npz"):
        assert _npz_equal(ref, port) > 0
        return
    assert filecmp.cmp(ref, port, shallow=False), what
    if name == "diploid":
        text = open(port).read()
        if what == "g.gfa2":
            n_reads = open(f"{d}/r.fa").read().count(">")
            assert 0 < text.count("\nS\t") < n_reads
        else:
            assert text.count(">" if what == "h.fa" else "\n") > 1


def test_myers_pallas_overlap_matches_reference(tmp_path):
    """``overlap --backend myers_pallas`` on a tiny read set: the
    reference's Pallas kernels in interpret mode and the port's plain twins
    give the same LAdump text."""
    d = str(tmp_path)
    _main(ref_cli, f"simulate --out {d}/r.fa {TINY}")
    for tag, (cli, dev) in CLIS.items():
        _main(cli, f"overlap {d}/r.fa --out {d}/{tag}.las --backend myers_pallas "
                   f"--min-overlap 300{dev}")
    assert filecmp.cmp(f"{d}/ref.las", f"{d}/port.las", shallow=False)
    assert open(f"{d}/port.las").read().count("\nP ") > 10


def test_device_stages_default_to_the_card(tmp_path, monkeypatch):
    """``overlap``, ``phase`` and ``pipeline`` default to ``--device cuda``,
    and without a card ``overlap`` and ``phase`` raise before any work (no
    CPU fallback); ``filter`` and ``layout`` take no device."""
    p = port_cli.build_parser()
    d = str(tmp_path)
    for line in (f"overlap r.fa --out {d}/a.npz", f"phase r.fa g.gfa2 a.npz --out {d}/h.fa",
                 f"pipeline r.fa --out {d}/asm.fa"):
        assert p.parse_args(line.split()).device == "cuda"
    for line in (f"filter r.fa a.npz --out {d}/f.npz", f"layout r.fa f.npz --out {d}/g.gfa2"):
        assert not hasattr(p.parse_args(line.split()), "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for line in (f"overlap {d}/r.fa --out {d}/a.npz", f"phase {d}/r.fa {d}/g.gfa2 {d}/a.npz --out {d}/h.fa"):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            _main(port_cli, line)
