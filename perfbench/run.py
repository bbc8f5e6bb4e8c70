"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; both are data files.  The traffic's
``kind`` picks the runner, ``lib/<kind>.py`` (``train``: ``lib/train.py``),
and the configuration's ``family`` the model, ``families/<family>.py``.  The run
measures ``learning_at_home_tpu_torch`` on the CUDA card: set-up (counted
as ``setup_s`` from the process's start), a window of ``--seconds``, with
``--trace 1`` a profiled stretch after it, then the check against the
plain reference (``reference/``).  The last line on standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
each read by ``metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit.
It exits 2, printing no result, without a card or with fewer cards than
the cell asks for, and 3 if JAX or the JAX package got loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench.lib import spec  # noqa: E402
from perfbench.lib.check import verdict  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "learning_at_home_tpu")
LIB = Path(__file__).resolve().parent / "lib"


def runner(kind: str):
    """The runner of a traffic ``kind``: the module ``lib/<kind>.py``."""
    path = LIB / f"{spec.check_name(kind, 'traffic kind')}.py"
    if not path.is_file():
        raise ValueError(f"unknown traffic kind {kind!r}: no file {path}")
    mod = importlib.import_module(f"perfbench.lib.{kind}")
    if not callable(getattr(mod, "run", None)):
        raise ValueError(f"unknown traffic kind {kind!r}: {path} has no run")
    return mod


def read_metric(name: str, run: dict):
    return spec.load_file(spec.metric_path(name), "metric").read(run)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t0: float = T0, program_cls=None) -> dict:
    """Run ``cell`` on ``device``; the result object (without ``device``)
    and the run's own numbers under ``run``.  ``program_cls`` replaces the
    runner's system under test (the tests plant faults with it)."""
    extra = {} if program_cls is None else {"program_cls": program_cls}
    run = runner(cell.traffic["kind"]).run(cell, seed, seconds, trace, device,
                                           t0, **extra)
    run["cell"] = cell
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, checks = verdict(run["numbers"], cell.limits)
    result = {"correct": correct and run["failed"] == 0,
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics}
    if trace:
        t = run["trace"]
        result["breakdown"] = {"device_ops": t.device_ops,
                               "idle_gaps": t.idle_gaps}
    result["checks"] = checks
    return {"result": result, "run": run}


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    result, run = out["result"], out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"] = run["trace"].busy_s
        device["window_s"] = run["trace"].window_s
    checks = result.pop("checks")
    result["device"] = device
    result["checks"] = checks
    found = loaded_forbidden()
    if found:
        print(f"perfbench: JAX modules loaded in the measuring process: "
              f"{found}", file=sys.stderr)
        return 3
    print("setup " + ", ".join(f"{k} {v:.3f} s" for k, v in
                               run["setup_parts"].items()), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
