#!/usr/bin/env python3
"""Where the port's training time goes on one CUDA card.

Builds a training configuration of ``chip_smoke.py`` by name (random
weights from a seed, fused CE, fused Adafactor 1e-3):

- ``flagship-train``: the 256-expert DMoE-Transformer at seq_len 256 with
  bf16 params, remat "full" and the per-layer tuple layout, batch 176;
- ``flagship-8k-train``: the same recipe at seq_len 8192, batch 4, where
  the flash-attention kernels run forward and backward;
- ``flagship-train-balanced``, ``flagship-train-expert-choice`` and
  ``flagship-train-dots``: ``flagship-train`` with router jitter 0.1 and
  aux-loss weight 5e-2, with expert-choice gating, and with remat "dots"
  (no balance steps here: the weights are the seed's).

It takes two warm-up steps on one fixed batch, then traces ``--steps``
more with ``torch.profiler``.  It prints, per step, the wall time, the
summed device time of the kernels, the device's busy share (summed kernel
time over wall time; the port runs on one stream, so kernels do not
overlap), the device time by kind of kernel, the kernels that take the
most device time, and the device time of the model's profiler ranges
(``models/transformer.py`` ``PROFILE_RANGE``: each layer's attention and
MoE, the loss, the backward, the optimizer update), each without the
ranges inside it, by kind of kernel.  The traced steps run the backward
on the calling thread (autograd's device threads off), so that its
kernels fall in the backward's range; remat's recompute of a layer falls
in that layer's ranges.

    python3 profile_training.py [--config flagship-8k-train] [--steps 2]
                                [--top 15] [--trace-dir traces]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType

from chip_smoke import TRAINING, build_train, card_line
from learning_at_home_tpu_torch.models.transformer import PROFILE_RANGE
from profile_serving import report, traced

# kernel name patterns, first match wins
KINDS = [
    ("fused CE (K1-K3)", r"fused_ce"),
    ("flash attention forward (K5 fwd)", r"flash_attn_fwd"),
    ("flash attention backward (K5 dkv, dq)", r"flash_attn_bwd"),
    ("scan (routing cumsum)", r"scan"),
    ("matmul (cuBLAS)", r"gemm|nvjet|xmma|cutlass|sm90_"),
    ("reduce", r"reduce|Reduce|norm"),
    ("copy / cast", r"copy|Copy|Memcpy|Memset|cast"),
    ("index / scatter / gather", r"index|scatter|gather|Index|Scatter|Gather"),
    ("elementwise", r"elementwise|Elementwise|vectorized|unrolled"),
]


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def range_device_ms(prof, per: int) -> dict[str, dict[str, float]]:
    """{range name: {kind of kernel: device ms per step}} of the model's
    profiler ranges, each without the ranges nested in it, layer ranges
    merged over layers ("layer*/attention")."""
    out: dict[str, dict[str, float]] = {}
    for evt in prof.events():
        if (evt.device_type != DeviceType.CPU
                or not evt.name.startswith(PROFILE_RANGE)):
            continue
        name = re.sub(r"layer\d+", "layer*", evt.name[len(PROFILE_RANGE):])
        slot = out.setdefault(name, {})
        stack = [evt]
        while stack:  # the range's ops, down to the next nested range
            e = stack.pop()
            for k in e.kernels:
                kind = kind_of(k.name)
                slot[kind] = slot.get(kind, 0.0) + k.duration / 1e3 / per
            stack.extend(c for c in e.cpu_children
                         if not c.name.startswith(PROFILE_RANGE))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(TRAINING),
                    default="flagship-train")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace-dir", type=Path, default=None,
                    help="write a chrome trace of the traced steps here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    model, params, _, opt_state, step, ids, tgt = build_train(args.config)
    state = {"params": params, "opt_state": opt_state}

    def run(n):
        for _ in range(n):
            state["params"], state["opt_state"], _, _ = step(
                state["params"], state["opt_state"], ids, tgt)

    run(2)  # warm-up: cuBLAS handles, the kernel library, the allocator
    path = None
    if args.trace_dir is not None:
        args.trace_dir.mkdir(parents=True, exist_ok=True)
        path = args.trace_dir / f"{args.config}_step.trace.json"
    with torch.autograd.set_multithreading_enabled(False):
        wall_ms, rows, prof = traced(lambda: run(args.steps), path)
    # the ranges' own device-side rows span kernels, they are none
    rows = [r for r in rows if not r[0].startswith(PROFILE_RANGE)]
    print(f"{card_line()}; {args.config}, batch {ids.shape[0]} x "
          f"{model.cfg.seq_len} tokens")
    out = report(f"train step (mean of {args.steps})", wall_ms, rows,
                 args.top, per=args.steps)
    kinds: dict[str, float] = {}
    for name, (ms, _) in out["kernels"].items():
        kinds[kind_of(name)] = kinds.get(kind_of(name), 0.0) + ms
    print("-- device time per step by kind of kernel")
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"   {ms:9.3f} ms {100 * ms / out['kernel_ms']:5.1f} %  {kind}")
    ranges = range_device_ms(prof, args.steps)
    ranges["(outside)"] = {
        kind: ms - sum(r.get(kind, 0.0) for r in ranges.values())
        for kind, ms in kinds.items()}
    print("-- device time per step by profiler range (without the ranges "
          "inside it), by kind of kernel")
    for name, by_kind in sorted(ranges.items(),
                                key=lambda kv: -sum(kv[1].values())):
        top = sorted(by_kind.items(), key=lambda kv: -kv[1])[:4]
        print(f"   {sum(by_kind.values()):9.3f} ms  {name}: "
              + ", ".join(f"{kind} {ms:.2f}" for kind, ms in top))
    print(json.dumps({"train_step": {"config": args.config,
                                     "wall_ms": out["wall_ms"],
                                     "kernel_ms": out["kernel_ms"],
                                     "by_kind_ms": kinds,
                                     "by_range_ms": ranges}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
