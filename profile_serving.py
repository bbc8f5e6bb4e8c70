#!/usr/bin/env python3
"""Where the port's serving time goes on one CUDA card.

Builds ``flagship-8k`` (as in ``chip_smoke.py``: the 256-expert
DMoE-Transformer at seq_len 8192, random weights from a seed), warms up,
then traces with ``torch.profiler`` (a) the prefill, ``generate`` with one
new token on 2 prompts of 4096 tokens, and (b) the decode steps, the
difference between ``generate`` with 1 + DECODE_STEPS new tokens and with
one, per step.  For each it prints the wall time, the summed device time
of the kernels, the device's busy share (summed kernel time over wall
time; the port runs on one stream, so kernels do not overlap) and the
kernels that take the most device time.

    python3 profile_serving.py [--top 12] [--trace-dir chiprun_out]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import FLAGSHIP_8K, card_line

DECODE_STEPS = 8


def device_us(evt) -> float:
    """Self device time of a key_averages row, in µs."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler rows carry no device time")


def traced(fn, trace_path: Path | None):
    """``(wall_ms, rows, prof)`` of one run of ``fn`` under the profiler:
    rows ``(kernel, device ms, count)`` by device time."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    # device-side rows only (kernels, copies, sets): a CPU op's row repeats
    # the time of the kernels it launched
    rows = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return wall_ms, sorted(rows, key=lambda r: -r[1]), prof


def report(label: str, wall_ms: float, rows, top: int, minus=None,
           per: int = 1) -> dict:
    """Print (and return) one breakdown.  ``minus``: a breakdown whose
    per-kernel times are subtracted first; ``per``: the result is divided
    by it (the decode steps: the long run minus the prefill run, per
    step)."""
    times = {name: (ms, n) for name, ms, n in rows}
    if minus is not None:
        for name, (ms, n) in minus["kernels"].items():
            old_ms, old_n = times.get(name, (0.0, 0))
            times[name] = (old_ms - ms, old_n - n)
        wall_ms -= minus["wall_ms"]
    times = {name: (ms / per, n / per) for name, (ms, n) in times.items()}
    wall_ms /= per
    kernel_ms = sum(ms for ms, _ in times.values())
    print(f"-- {label}: wall {wall_ms:.3f} ms, kernels {kernel_ms:.3f} ms, "
          f"busy share {kernel_ms / wall_ms:.3f}")
    for name, (ms, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"   {ms:9.3f} ms {100 * ms / kernel_ms:5.1f} %  x{n:<7g} {name[:90]}")
    return {"wall_ms": wall_ms, "kernel_ms": kernel_ms, "kernels": times}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="write chrome traces of both runs here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from learning_at_home_tpu_torch.random import PRNGKey
    from learning_at_home_tpu_torch.models.transformer import (
        DMoETransformerConfig,
        DMoETransformerLM,
    )

    cfg = DMoETransformerConfig(**FLAGSHIP_8K)
    model = DMoETransformerLM(cfg, device="cuda")
    params = model.init_params(PRNGKey(0))
    prompts = torch.randint(
        0, cfg.vocab_size, (2, 4096), dtype=torch.int32, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    lengths = (1, 1 + DECODE_STEPS)
    for n in lengths:  # warm-up: cuBLAS handles, the kernel library
        model.generate(params, prompts, n, use_cache=True)

    runs = []
    for n in lengths:
        path = None
        if args.trace_dir is not None:
            args.trace_dir.mkdir(parents=True, exist_ok=True)
            path = args.trace_dir / f"serving_{n}tok.trace.json"
        runs.append(traced(
            lambda: model.generate(params, prompts, n, use_cache=True),
            path)[:2])
    print(f"{card_line()}; flagship-8k, 2 x 4096-token prompts")
    prefill = report("prefill (generate, 1 new token)", *runs[0], args.top)
    decode = report(f"decode, per step (of {DECODE_STEPS})", *runs[1],
                    args.top, minus=prefill, per=DECODE_STEPS)
    print(json.dumps({name: {"wall_ms": r["wall_ms"], "kernel_ms": r["kernel_ms"]}
                      for name, r in (("prefill", prefill), ("decode_step", decode))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
