"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file found by its name: ``configs/<config>.json`` (the
file the configuration entry gives), ``traffic/<traffic>.json`` and
``limits/<cell>.json`` (the limits that decide ``correct``).  The
configuration's ``family`` key names its model family,
``families/<family>.py``; the traffic's ``kind`` names its runner,
``lib/<kind>.py``.  A per-layer metric is ``metrics/<metric>.py``.  A
later change adds a model family, a cell, a traffic mix or a metric by
adding files and entries, without editing any file here.

A model family is a module with

- ``leaf_specs(cfg)``: ``(path, shape, init, std)`` of every leaf, in the
  order the leaves are seeded (leaf ``i`` draws from ``leaf_seed(seed,
  i)``, at most 65536 leaves); a path is a top-level key path, or
  ``("layers", i, ...)`` for layer ``i``'s leaves (the tuple layout), and
  the paths alone give the tree's nesting; ``init`` is ``normal``,
  ``ones`` or ``zeros``;
- ``build(cfg, traffic, device)``: the port's model, with
  ``init_opt_state(opt, params)`` and ``make_train_step(opt)``; it checks
  that the port can run ``cfg`` as written and raises where it cannot;
- ``reference(cfg, precision)``: the plain model (``reference/``), whose
  ``loss_and_grads(tree, leaves, ids, tgt)`` gives the mean loss (a float)
  and the gradient by each of ``leaves``, the tensors ``tree`` holds, in
  ``leaf_specs`` order; ``precision`` is ``f32`` or the control's
  ``fp8``;
- ``train_flops_per_token(cfg)``: the frozen training FLOPs a token;
- ``RANGE_PREFIX``: the prefix of the port's profiler ranges for the
  model (the per-layer metrics read the ranges without it).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

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
    family: ModuleType  # families/<config's family>.py
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
    config = load_json(REPO / conf["file"])
    if "family" not in config:
        raise ValueError(f"{conf['file']} names no model family: give it "
                         f"\"family\": <name> of {ROOT / 'families'}/<name>.py")
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        family=load_family(config["family"]),
        traffic=load_json(ROOT / "traffic" / f"{traffic_name}.json"),
        limits=load_json(ROOT / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer,
    )


@functools.cache
def load_file(path: Path, what: str) -> ModuleType:
    """The Python file ``path`` loaded as a module of its own, once in a
    process, entered in ``sys.modules`` (as ``dataclasses`` and ``pickle``
    look it up there)."""
    name = re.sub(r"[^A-Za-z0-9_]", "_", f"perfbench_{what}_{path.stem}")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def family_path(name: str) -> Path:
    return ROOT / "families" / f"{check_name(name, 'family')}.py"


def load_family(name: str) -> ModuleType:
    """The model family ``families/<name>.py``; ValueError if there is no
    such file."""
    path = family_path(name)
    if not path.is_file():
        raise ValueError(f"unknown model family {name!r}: no file {path}")
    return load_file(path, "family")


def range_prefixes() -> tuple[str, ...]:
    """Every model family's ``RANGE_PREFIX``, in the order of their files'
    names."""
    return _range_prefixes(ROOT / "families")


@functools.cache
def _range_prefixes(families: Path) -> tuple[str, ...]:
    return tuple(load_family(p.stem).RANGE_PREFIX
                 for p in sorted(families.glob("*.py")))


def metric_path(name: str) -> Path:
    return ROOT / "metrics" / f"{check_name(name, 'metric')}.py"
