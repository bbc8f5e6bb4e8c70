"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file found by its name: ``configs/<config>.json`` (the
file the configuration entry gives), ``traffic/<traffic>.json`` and
``limits/<cell>.json`` (the limits that decide ``correct``).  A per-layer
metric is ``metrics/<metric>.py``.  A later change adds a cell, a traffic
mix or a metric by adding files and entries, without editing any file
here.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the perfbench directory
REPO = ROOT.parent  # the checkout that holds BENCHMARK.json
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def check_name(name: str, what: str = "name") -> str:
    """``name`` if it is a valid name (a letter, digit or ``_`` first, at
    most 64 of letters, digits, ``_``, ``.`` and ``-``), else ValueError."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"invalid {what}: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    """One cell: its entry, its configuration and traffic, and the
    metrics BENCHMARK.json gives it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple  # metric entries this cell reports with --trace 0
    per_layer: tuple  # metric entries this cell reports with --trace 1


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:  # a per-layer metric without a cell list
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    check_name(name, "workload")
    bench = load_json(bench_path or REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config_name = check_name(entry["config"], "config")
    traffic_name = check_name(entry["traffic"], "traffic")
    conf = next(c for c in bench["configs"] if c["name"] == config_name)
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name, set()))
    e2e_names = {m["name"] for m in e2e}
    per_layer = tuple(m for m in bench["per_layer"]
                      if _reports(m, name, e2e_names))
    for m in (*e2e, *per_layer):
        check_name(m["name"], "metric")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(REPO / conf["file"]),
        traffic=load_json(ROOT / "traffic" / f"{traffic_name}.json"),
        limits=load_json(ROOT / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer,
    )


def metric_path(name: str) -> Path:
    return ROOT / "metrics" / f"{check_name(name, 'metric')}.py"
