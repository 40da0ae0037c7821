"""BENCHMARK.json against the files the harness finds by name, and the
format's limits on names, units and keys."""
import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PKG = ROOT / "portbench"


@pytest.fixture(scope="module")
def b():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(b):
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1].startswith("portbench/")
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_find_their_files(b):
    configs = {c["name"]: c for c in b["configs"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and (PKG / "mixes" / f"{w['traffic']}.json").exists()
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (c["source"], c["reduced"]) == (f["source"], f["reduced"])
        assert all(k in f["sim"] for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])


def test_metrics(b):
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (PKG / "metrics" / f"{m['name']}.py").exists(), m["name"]
        names.add(m["name"])
    assert len(names) == len(b["end_to_end"]) + len(b["per_layer"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
