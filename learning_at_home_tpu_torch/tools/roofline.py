"""Card-constant memory/compute roofline for the flagship bench recipe.

The port of the JAX repo's ``tools/roofline.py``.  It answers one
question about a measured step: is the single-card flagship at batch
``--batch`` bandwidth-bound on parameter traffic -- in which case the
gradient-accumulation ladder can lift MFU -- or is the param-traffic
share already small enough that accumulation cannot get there?

Method: exact state bytes come from meta tensors of the REAL flagship
(``utils/sizing.py``: bf16 params, remat, the per-layer tuple layout,
the optimizer's own ``init``; nothing allocated, so it runs on the CPU
as well as beside the card); traversal counts are read off the train
step's structure:

  per microbatch   forward reads every param once            1×P
                   remat recompute reads them again          1×P
                   backward dgrad matmuls read them again    1×P
                   gradient write (param dtype)              1×G
  accum>1 only     f32 accum buffer read-modify-write        2×A32 + 1×G
  per opt step     the optimizer: read params+grads, rw      2×P + 1×Gin
                   its state, write params (ONE fused            + 2×O
                   traversal, ops/fused_adafactor.py)

Compute floors use ``sizing._model_flops_per_step`` (algorithmic, the
MFU numerator) and a 4/3 remat-recompute factor for *executed* FLOPs.

Constants: the card's dense bf16 peak and memory bandwidth from
``utils/sizing.py``, for ``torch.cuda.get_device_name()`` when a card is
present and for the H100 when none is.
Measured anchor: ``--step-ms``, a step time measured on that card at
``--batch`` (``experiments/profile_step.py``'s ``step_ms`` for the same
recipe: ``--no-stack --optimizer fused``).  The verdicts are derived
from these numbers: the step is called param-bandwidth-bound when the
param traffic takes at least half of the measured step, and accum>1 is
predicted net negative when the accum RMW costs more than the
optimizer pass it amortizes.

Run: ``python -m learning_at_home_tpu_torch.tools.roofline --step-ms MS``
"""

from __future__ import annotations

import argparse

import torch

from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.tree import tree_leaves
from learning_at_home_tpu_torch.utils import sizing
from learning_at_home_tpu_torch.utils.sizing import H100


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--step-ms", type=float, required=True,
                    help="the measured step time on the card, ms")
    ap.add_argument("--batch", type=int, default=176)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    card = torch.cuda.get_device_name() if torch.cuda.is_available() else H100
    if card not in sizing.CARD_PEAK_BF16:
        raise SystemExit(f"roofline: no constants for {card!r} "
                         f"(utils/sizing.py has {sorted(sizing.CARD_PEAK_BF16)})")
    peak_bf16 = sizing.CARD_PEAK_BF16[card]
    hbm_bps = sizing.CARD_HBM_BPS[card]
    batch = args.batch
    cfg = sizing.flagship_config(
        param_dtype=torch.bfloat16, remat=True,
        scan_layers=False, stack_layers=False,
    )
    opt = fused_adafactor(1e-3)
    measured_step_s = args.step_ms / 1e3

    aparams = sizing.abstract_params(cfg)
    P = sizing._tree_bytes(aparams)  # bf16 params
    G = P  # cotangents carry the param dtype
    n_params = sum(t.numel() for t in tree_leaves(aparams))
    A32 = 4 * n_params
    O = sizing._tree_bytes(opt.init(aparams))

    flops = sizing._model_flops_per_step(cfg, batch)  # algorithmic (MFU numerator)
    t_alg = flops / peak_bf16
    t_exec = flops * (4.0 / 3.0) / peak_bf16  # remat recompute included

    def ms(nbytes: float) -> float:
        return nbytes / hbm_bps * 1e3

    fwd_bwd = 3 * P + G          # per microbatch, accum or not
    accum_rmw = 2 * A32 + G      # per microbatch, accum>1 only
    opt_pass = 2 * P + 2 * O + A32  # once per opt step (reads f32 sums when accum>1)
    opt_pass_a1 = 2 * P + 2 * O + G  # accum=1: reads the bf16 grad tree

    print(f"flagship: {n_params/1e9:.3f} B params | P(bf16) {P/1e9:.2f} GB | "
          f"opt state {O/1e9:.2f} GB | f32 accum buffer {A32/1e9:.2f} GB")
    print(f"algorithmic FLOPs/step (batch {batch}): {flops/1e12:.2f} TF "
          f"-> compute floor {t_alg*1e3:.1f} ms algorithmic, "
          f"{t_exec*1e3:.1f} ms executed (remat 4/3)")
    print(f"measured step: {measured_step_s*1e3:.1f} ms "
          f"(MFU {flops/measured_step_s/peak_bf16:.3f})")
    print()
    print(f"param-sized HBM traffic per optimizer step @ {hbm_bps/1e9:.0f} "
          f"GB/s:")
    residual = None
    for accum in (1, 2, 4):
        if accum == 1:
            traffic = fwd_bwd + opt_pass_a1
            step_ms = measured_step_s * 1e3
        else:
            traffic = accum * (fwd_bwd + accum_rmw) + opt_pass
            # model: each micro costs the measured non-opt time plus the
            # accum RMW; the single opt pass replaces accum=1's per-step one
            micro_ms = (measured_step_s * 1e3 - ms(opt_pass_a1)
                        + ms(accum_rmw))
            step_ms = accum * micro_ms + ms(opt_pass)
        tokens = accum * batch * cfg.seq_len
        mfu = accum * flops / (step_ms / 1e3) / peak_bf16
        print(f"  accum={accum}: traffic {traffic/1e9:6.1f} GB = "
              f"{ms(traffic):5.1f} ms floor | predicted step "
              f"{step_ms:6.1f} ms | tok/s {tokens/(step_ms/1e3)/1e3:6.1f}k | "
              f"MFU {mfu:.3f}")
        if accum == 1:
            residual = measured_step_s * 1e3 - ms(traffic) - t_exec * 1e3
    print()
    print(f"decomposition of the measured {args.step_ms:g} ms (accum=1): "
          f"executed matmuls >= {t_exec*1e3:.1f} ms, param traffic >= "
          f"{ms(fwd_bwd+opt_pass_a1):.1f} ms, residual (activations, CE "
          f"chunks, dispatch, non-matmul ops, matmul inefficiency) ~= "
          f"{residual:.1f} ms")
    share = ms(fwd_bwd + opt_pass_a1) / (measured_step_s * 1e3)
    verdict = "NOT param-bandwidth-bound" if share < 0.5 else \
        "param-bandwidth-bound"
    print(f"param-traffic share of the step: {share:.1%} -> the step is "
          f"{verdict} at batch {batch}")
    best_no_param = measured_step_s * 1e3 - ms(opt_pass_a1)
    if ms(accum_rmw) > ms(opt_pass_a1):
        compare, sign = "exceeds", "NET NEGATIVE"
    else:
        compare, sign = "does not exceed", "NET POSITIVE"
    print(f"accum ceiling: even amortizing the optimizer pass to zero, "
          f"MFU <= {flops/(best_no_param/1e3)/peak_bf16:.3f}; the f32 accum "
          f"RMW ({ms(accum_rmw):.1f} ms/micro) {compare} the amortized "
          f"optimizer saving ({ms(opt_pass_a1):.1f} ms/step), so accum>1 is "
          f"predicted {sign} at this shape")


if __name__ == "__main__":
    main()
