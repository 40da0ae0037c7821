"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

  BENCHMARK.json "workloads"  the cell: its configuration, traffic mix, chips
  configs/<config>.json       a read set: simulator, seeding and overlap parameters
  mixes/<traffic>.json        a traffic mix: what one pass of the window drives
  metrics/<metric>.py         one reader a metric: ``read(record) -> float | None``

A later change adds a cell as an entry of BENCHMARK.json, and a
configuration, a mix or a metric as a new file and entry; no file here
needs an edit for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def _load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict, root: Path = HERE) -> Cell:
    """The cell ``name`` of BENCHMARK.json (parsed as ``bench``), with its
    files under ``root`` and the metrics it reports."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    w = found[0]
    return Cell(
        name=name,
        config=_load_json(root / "configs" / f"{w['config']}.json"),
        mix=_load_json(root / "mixes" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, root: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py`` under ``root``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, record: dict, root: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of each entry whose reader finds a value."""
    out = {}
    for m in entries:
        v = reader(m["name"], root)(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
