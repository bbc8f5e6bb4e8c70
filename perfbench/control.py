"""Readings that set a cell's limits: the program's, the control's and the
faults', each against the plain reference, seed by seed.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out readings.jsonl]

For each seed of ``--seeds`` it takes the program's readings as a run's
check takes them (the checked steps through the train step and its feed)
and prints the numbers compared.  For each seed of ``--control-seeds`` it
takes the same numbers of

- the control: the reference computed with fp8 (e4m3) matrix operands,
  put in the program's place;
- a fault: half of each batch left out, the mean taken over the rest
  (the reference in the program's place).  A state left unchanged reads
  1 by the change's measure and needs no run.

The last line is a summary: each number's largest program reading (the
lower reading) and the smallest reading of each control or fault.  Not
run by the benchmark's runs; it needs the card for the cells' sizes, and
runs on the CPU for a configuration small enough
(``tests/test_perfbench_control.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench.lib import check, spec, train  # noqa: E402
from perfbench.reference.run import train_readings  # noqa: E402


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def train_seed(cell, seed: int, device, faults: bool) -> list[dict]:
    cfg, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    prog = train.Program(cell, seed, device)
    readings = prog.checked_steps()
    ids, tgt = prog.checked_batches()
    del prog
    _free(device)
    t1 = time.perf_counter()
    ref = train_readings(cell.family, cfg, traffic, seed, ids, tgt, device)
    names = ["/".join(map(str, path)) for path, *_ in cell.family.leaf_specs(cfg)]
    rows = [{"side": "program", **check.train_gaps(readings, ref, names)}]
    rows[0]["detail"]["seconds"] = {"program": t1 - t0,
                                    "reference": time.perf_counter() - t1}
    if faults:
        for side, kw in (("control_fp8", {"precision": "fp8"}),
                         ("half_batch", {"rows": traffic["batch"] // 2})):
            t = time.perf_counter()
            got = train_readings(cell.family, cfg, traffic, seed, ids, tgt,
                                 device, **kw)
            rows.append({"side": side, **check.train_gaps(got, ref, names)})
            rows[-1]["detail"]["seconds"] = time.perf_counter() - t
            _free(device)
    return rows


def summarize(rows: list[dict]) -> dict:
    out: dict = {}
    for row in rows:
        for name, value in row.items():
            if name in ("side", "seed", "detail"):
                continue
            slot = out.setdefault(name, {})
            pick = max if row["side"] == "program" else min
            key = "lower" if row["side"] == "program" else row["side"]
            slot[key] = value if key not in slot else pick(slot[key], value)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | control):
        for row in train_seed(cell, seed, args.device, seed in control):
            row["seed"] = seed
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if args.out is not None:
                with open(args.out, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
    print(json.dumps({"workload": args.workload, "summary": summarize(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
