"""The port's ladder runner (``phasm_tpu_torch.ladder``) against the
reference's ``phasm_tpu.configs.run_rung``, on the CPU.

A tiny triploid rung (5 kb, ploidy 3, two het hotspots, c5's pipeline
settings with the read-length and overlap floors scaled to its 740-base
reads, both polish rounds on) stands in for ``configs.ladder()``: its JSON
line must equal the reference's row on the same rung, both with
``backend="jnp"``, in every column they share apart from the name, the
backend and the ``*_s`` times.  It is the first ploidy-3 equality through
``assemble``; the reference row has two chains and six haplotigs, so the
comparison cannot pass on an empty assembly.  The reads fit J = 1024 even
at the band-128 retry, which keeps the reference's padded retry batches
off J = 4096.  The runner's filter, append, error line and exit status run
on stubs.
"""
import json

import pytest
import torch

from phasm_tpu import configs as ref_configs
from phasm_tpu.overlap import OverlapConfig
from phasm_tpu.phasing import PhaseConfig
from phasm_tpu.pipeline import PipelineConfig
from phasm_tpu_torch import configs, ladder
from phasm_tpu_torch.overlap.engine import OverlapConfig as PortOverlapConfig
from phasm_tpu_torch.phasing import PhaseConfig as PortPhaseConfig
from phasm_tpu_torch.pipeline import PipelineConfig as PortPipelineConfig
from torch_cases import ensure_reference_native

torch.set_num_threads(1)  # small CPU shapes: more threads only contend with the other test workers
ensure_reference_native()  # before any test of this worker loads it

NAME = "c5_tiny_triploid"
SIM = dict(
    seed=3, genome_len=5_000, ploidy=3, coverage=6, mean_read_len=740,
    error_rate=0.03, indel_rate=0.0, snv_rate=0.0, hotspots=2, hotspot_rate=0.15,
    hotspot_width=600, read_len_spread=0.2,
)
PIPE = dict(
    min_read_length=500, min_overlap_length=500, max_error_rate=0.10, length_fuzz=300,
    evidence_max_error=0.5, adaptive_error=True, polish=True,
)


def _rung(name=NAME, sim=SIM):
    return configs.LadderConfig(
        name=name, description="tiny triploid", sim=dict(sim),
        overlap=PortOverlapConfig(min_overlap=500),
        pipeline=PortPipelineConfig(phase=PortPhaseConfig(ploidy=3), **PIPE),
    )


def _lines(text):
    return [json.loads(s) for s in text.splitlines() if s.strip()]


def test_triploid_rung_row_equals_reference(monkeypatch, capsys, tmp_path):
    # a second rung that --rungs must filter out: its simulation would raise
    decoy = _rung("c9_decoy", dict(no_such_argument=1))
    monkeypatch.setattr(configs, "ladder", lambda: [_rung(), decoy])
    out = tmp_path / "ladder.jsonl"
    out.write_text('{"name": "earlier"}\n')
    rc = ladder.main(["--rungs", "c5", "--device", "cpu", "--backend", "jnp", "--strict",
                      "--out", str(out)])
    assert rc == 0
    (row,) = _lines(capsys.readouterr().out)
    assert _lines(out.read_text()) == [{"name": "earlier"}, row]  # appended

    ref = ref_configs.run_rung(ref_configs.LadderConfig(
        name=NAME, description="tiny triploid", sim=dict(SIM),
        overlap=OverlapConfig(min_overlap=500),
        pipeline=PipelineConfig(phase=PhaseConfig(ploidy=3), **PIPE),
    ), backend="jnp")
    assert ref["n_chains"] >= 1 and ref["n_haplotigs"] >= 3
    shared, diff = ladder.row_diff(row, ref)
    assert {"n_alignments", "n_chains", "n_haplotigs", "qc_kmer_identity",
            "qc_allele_purity", "qc_purity_haplotigs_measured"} <= set(shared)
    assert diff == {}
    assert (row["name"], row["backend"], row["device"]) == (NAME, "jnp", "cpu")
    assert row["launches_overlap"] == {"myers_fwd": 0, "myers_rev": 0, "wband": 0}


def test_failed_rung_error_line_and_exit_status(monkeypatch, capsys):
    rungs = [_rung("c1_fails"), _rung("c2_runs")]
    monkeypatch.setattr(configs, "ladder", lambda: rungs)

    def run_rung(cfg, backend=None, device="cuda"):
        if cfg.name == "c1_fails":
            raise ValueError("boom")
        return {"name": cfg.name, "backend": backend, "device": str(device)}

    monkeypatch.setattr(configs, "run_rung", run_rung)
    assert ladder.main(["--device", "cpu"]) == 1
    assert _lines(capsys.readouterr().out) == [
        {"name": "c1_fails", "error": "ValueError('boom')"},
        {"name": "c2_runs", "backend": None, "device": "cpu"},
    ]
    with pytest.raises(ValueError, match="boom"):
        ladder.main(["--device", "cpu", "--strict"])
    assert ladder.main(["--device", "cpu", "--rungs", "c2"]) == 0


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(configs, "ladder", lambda: pytest.fail("ran a rung without a card"))
    with pytest.raises(RuntimeError, match="is_available"):
        ladder.main([])
