"""Per-variant step timing + optional device trace for the flagship.

The port of ``experiments/profile_step.py``, the MFU ladder tool: times
the 256-expert flagship train step under combinations of the model's
perf knobs (stacked or per-layer params, remat policy, batch, optimizer)
with host clocks around work that ends in ``torch.cuda.synchronize()``.
Its flags, its stderr ``variant:`` line and its one stdout JSON line are
the JAX script's, plus ``--device`` (default: the CUDA card; without one
it raises, and never falls back to the CPU).  ``--device cpu`` takes the
JAX script's CPU branch: 8 experts, f32 compute and params, 3 timed
steps.

It sizes the variant with ``utils/sizing.py`` (bench.py's analytic
memory, plus the extra activations of ``remat_policy="dots"``) and, on
the card, REFUSES a variant whose estimate exceeds 0.75 of the card's
memory (exit code 2) before any parameter or batch is allocated.

The JSON line: ``step_ms`` and ``tokens_per_sec`` of the timed steps;
``compile_s``, the first step's seconds (on the card this includes
loading the built kernels, cuBLAS's handles and the allocator's first
blocks; the port compiles no graph); ``mfu`` where ``utils/sizing.py``
has the card's bf16 peak; ``hbm_peak_gb`` from
``torch.cuda.max_memory_allocated()``, reset before the first step.
``--trace DIR`` runs 3 more steps under ``utils/profiling.device_trace``.
``main(argv)`` returns the JSON line's dict plus ``est_peak_bytes``,
``step_s`` (unrounded) and ``trace_file``.

Usage (on the card):
    python -m learning_at_home_tpu_torch.experiments.profile_step \\
        --batch 176 --no-stack --optimizer fused
    python -m learning_at_home_tpu_torch.experiments.profile_step \\
        --batch 112 --remat-policy dots
    python -m learning_at_home_tpu_torch.experiments.profile_step \\
        --batch 176 --trace traces/
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import sys
import time

import numpy as np
import torch

# the refusal's share of the card's memory
BUDGET_SHARE = 0.75


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=176)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--no-scan", action="store_true",
                    help="unrolled layer loop (scan_layers=False)")
    ap.add_argument("--no-stack", action="store_true",
                    help="per-layer param tuple (implies --no-scan)")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--optimizer", default="adafactor",
                    choices=["adafactor", "adamw", "fused"])
    ap.add_argument("--trace", default=None,
                    help="capture a torch.profiler trace of 3 steps here")
    ap.add_argument("--deadline", type=int, default=420)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    return ap


def make_optimizer(name: str):
    """``fused`` -> ``ops.fused_adafactor``, ``adafactor`` -> optax's
    chain (``optim.adafactor``), ``adamw`` -> ``optim.adamw``; lr 1e-3."""
    from learning_at_home_tpu_torch import optim
    from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor

    make = {"fused": fused_adafactor, "adafactor": optim.adafactor,
            "adamw": optim.adamw}[name]
    return make(1e-3)


def check_budget(need: int, hbm_bytes: int) -> None:
    """Exit 2 when the estimated peak ``need`` exceeds the budget, 0.75 of
    the card's ``hbm_bytes``."""
    budget = BUDGET_SHARE * hbm_bytes
    if need > budget:
        print(
            f"REFUSED: estimated peak {need / 1e9:.1f} GB > budget "
            f"{budget / 1e9:.1f} GB (0.75 of the card's "
            f"{hbm_bytes / 1e9:.1f} GB; never OOM-probe the card)",
            file=sys.stderr,
        )
        sys.exit(2)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    # the process's own stderr: an in-process caller may have replaced
    # sys.stderr with a stream that has no file descriptor
    faulthandler.dump_traceback_later(args.deadline, exit=True,
                                      file=sys.__stderr__)
    try:
        return _run(args)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _run(args) -> dict:
    from learning_at_home_tpu_torch import random as prng
    from learning_at_home_tpu_torch.device import resolve_device
    from learning_at_home_tpu_torch.models.transformer import DMoETransformerLM
    from learning_at_home_tpu_torch.utils import sizing

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    cfg = sizing.flagship_config(
        param_dtype=torch.bfloat16 if on_card else torch.float32,
        remat=not args.no_remat,
        remat_policy=args.remat_policy,
        scan_layers=not (args.no_scan or args.no_stack),
        stack_layers=not args.no_stack,
    )
    if not on_card:
        cfg = dataclasses.replace(cfg, num_experts=8, dtype=torch.float32)
    optimizer = make_optimizer(args.optimizer)

    need = sizing.estimated_peak_bytes(cfg, optimizer, args.batch)
    if on_card:
        check_budget(need, sizing.card_hbm_bytes(dev))
    print(f"variant: batch={args.batch} scan={cfg.scan_layers} "
          f"remat={cfg.remat}/{cfg.remat_policy} opt={args.optimizer} "
          f"est_peak={need / 1e9:.1f} GB", file=sys.stderr)

    model = DMoETransformerLM(cfg, device=dev)
    params = model.init_params(prng.PRNGKey(0))
    opt_state = model.init_opt_state(optimizer, params)
    step = model.make_train_step(optimizer)
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(
        rs.randint(0, cfg.vocab_size, (args.batch, cfg.seq_len))).to(dev)
    tgt = torch.as_tensor(
        rs.randint(0, cfg.vocab_size, (args.batch, cfg.seq_len))).to(dev)

    def fence() -> None:
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t_c0 = time.perf_counter()
    params, opt_state, loss, _ = step(params, opt_state, ids, tgt)
    fence()
    compile_s = time.perf_counter() - t_c0

    n = args.steps if on_card else 3
    t0 = time.perf_counter()
    for _ in range(n):
        params, opt_state, loss, metrics = step(params, opt_state, ids, tgt)
    fence()
    elapsed = time.perf_counter() - t0

    trace_file = None
    if args.trace:
        from learning_at_home_tpu_torch.utils.profiling import device_trace

        with device_trace(args.trace) as trace_file:
            for _ in range(3):
                params, opt_state, loss, metrics = step(
                    params, opt_state, ids, tgt
                )
            fence()

    step_s = elapsed / n
    tps = args.batch * cfg.seq_len / step_s
    out = {
        "batch": args.batch,
        "scan_layers": cfg.scan_layers,
        "remat": cfg.remat,
        "remat_policy": cfg.remat_policy,
        "optimizer": args.optimizer,
        "step_ms": round(1000 * step_s, 2),
        "tokens_per_sec": round(tps, 1),
        "compile_s": round(compile_s, 1),
        "loss": round(float(loss), 4),
    }
    if on_card:
        name = torch.cuda.get_device_name(dev)
        if name in sizing.CARD_PEAK_BF16:
            out["mfu"] = round(
                sizing._model_flops_per_step(cfg, args.batch) / step_s
                / sizing.CARD_PEAK_BF16[name],
                4,
            )
        out["hbm_peak_gb"] = round(torch.cuda.max_memory_allocated(dev) / 1e9,
                                   2)
    print(json.dumps(out), flush=True)
    return dict(out, est_peak_bytes=need, step_s=step_s,
                trace_file=trace_file)


if __name__ == "__main__":
    main()
