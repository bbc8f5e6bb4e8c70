"""Quantify the expert-choice -> token-choice decode routing gap.

The port of ``experiments/decode_gap_eval.py``: its flags, JSON keys and
errors, plus ``--device`` (default: the CUDA card; without one it
raises).  Launched on N ranks (``torchrun --nproc-per-node N -m
learning_at_home_tpu_torch.experiments.decode_gap_eval ...``, or the
ranks of ``parallel/launch.RankGroup``) it runs on the JAX script's mesh
``{"expert": N}``, over ``nccl`` on the cards or ``gloo`` with ``--device
cpu``: each rank trains and evaluates on its rows of every batch, the
CEs are the whole batch's, and rank 0 prints.  On one rank it runs on the
single-device model.

Expert-choice gating routes each expert to its top-C tokens OF THE BATCH,
so autoregressive decode cannot reproduce the training-time routing and
``DMoETransformerLM.decode_model()`` falls back to token-choice top-k over
the same gate affinities.  This script produces the number:

1. train a DMoE-Transformer with ``gating='expert_choice'``;
2. evaluate teacher-forced CE on held-out batches under (a) the TRAINING
   routing (expert-choice, batch-dependent) and (b) the DECODE routing
   (the token-choice fallback generation uses);
3. report both and the gap.  A token-choice-trained control with the same
   budget puts the gap beside the alternative gating.

Usage:
  python -m learning_at_home_tpu_torch.experiments.decode_gap_eval \\
      --data corpus.txt --steps 150 --num-experts 16 --d-model 128
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default=None, help="corpus path (.txt)")
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--num-experts", type=int, default=16)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-control", action="store_true",
                   help="skip the token-choice-trained control run")
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: the CUDA "
                        "card; 'cpu' to run on the CPU)")
    return p


def _expert_mesh(args, dev):
    """The JAX script's mesh ``{"expert": N}`` over the job's N ranks, or
    None for one rank (the single-device model).  Joins the job ``torchrun``
    describes in the environment when no process group exists yet."""
    import torch
    import torch.distributed as dist

    from learning_at_home_tpu_torch.parallel.mesh import make_mesh, rank_device

    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        if dev.type != "cpu":
            torch.cuda.set_device(rank_device(args.device))
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
    n = dist.get_world_size()
    if args.batch_size % n:
        raise SystemExit(
            f"--batch-size {args.batch_size} must divide across the "
            f"{n} token shards of the expert mesh"
        )
    if n == 1:
        return None
    # the rank's card (cuda:LOCAL_RANK) unless --device names one
    return make_mesh({"expert": n}, device=args.device)


def main(argv=None) -> dict:
    """Runs the evaluation; prints and returns its JSON result (every rank
    returns it, rank 0 prints)."""
    args = build_parser().parse_args(argv)

    import torch

    from learning_at_home_tpu_torch import optim
    from learning_at_home_tpu_torch import random as prng
    from learning_at_home_tpu_torch.device import resolve_device
    from learning_at_home_tpu_torch.models.data import (
        VOCAB_SIZE,
        LMBatcher,
        load_corpus,
    )
    from learning_at_home_tpu_torch.models.transformer import (
        DMoETransformerConfig,
        DMoETransformerLM,
    )

    dev = resolve_device(args.device)
    mesh = _expert_mesh(args, dev)
    if mesh is not None:
        dev = mesh.device
    printing = mesh is None or mesh.rank == 0

    def note(text: str) -> None:
        if printing:
            print(text, file=sys.stderr, flush=True)

    tokens = load_corpus(args.data, seed=args.seed)
    # train/eval split: DISJOINT stream halves (reseeding the batcher
    # alone would sample overlapping windows of the same stream, and the
    # held-out CE would partly measure memorization)
    split = int(0.9 * len(tokens))
    train_tokens, eval_tokens = tokens[:split], tokens[split:]

    def make_model(gating: str) -> DMoETransformerLM:
        cfg = DMoETransformerConfig(
            vocab_size=VOCAB_SIZE,
            d_model=args.d_model,
            n_layers=args.n_layers,
            seq_len=args.seq_len,
            num_experts=args.num_experts,
            k=args.k,
            dtype=torch.bfloat16 if dev.type != "cpu" else torch.float32,
            gating=gating,
        )
        return DMoETransformerLM(cfg, device=dev, mesh=mesh)

    def train(model: DMoETransformerLM):
        params = model.init_params(prng.PRNGKey(args.seed))
        optimizer = optim.adamw(args.lr)
        opt_state = model.init_opt_state(optimizer, params)
        step_fn = model.make_train_step(optimizer)
        # a fresh batcher per run: both gating variants train on the SAME
        # batch stream, or the control comparison is confounded
        batches = iter(LMBatcher(train_tokens, args.batch_size, args.seq_len,
                                 seed=args.seed))
        t0 = time.perf_counter()
        for step in range(args.steps):
            ids, tgt = next(batches)
            params, opt_state, loss, metrics = step_fn(
                params, opt_state, model.local_batch(torch.from_numpy(ids)),
                model.local_batch(torch.from_numpy(tgt)))
            if step % 25 == 0 or step == args.steps - 1:
                note(f"#   step {step}: loss {float(loss):.4f} "
                     f"ce {float(metrics['ce']):.4f} "
                     f"({time.perf_counter() - t0:.0f}s)")
        return params

    @torch.no_grad()
    def eval_ce(model: DMoETransformerLM, params) -> float:
        """Teacher-forced CE over held-out batches under MODEL's routing
        (on a mesh each rank feeds its rows; the CE is the batch's)."""
        eval_batches = LMBatcher(eval_tokens, args.batch_size, args.seq_len,
                                 seed=args.seed + 10_000)
        total, n = 0.0, 0
        for _, (ids, tgt) in zip(range(args.eval_batches), eval_batches):
            ids = model.local_batch(torch.from_numpy(ids)).to(dev)
            tgt = model.local_batch(torch.from_numpy(tgt)).to(dev)
            _, metrics = model.loss_fn(params, ids, tgt)
            total += float(metrics["ce"])
            n += 1
        return total / n

    note("# training expert-choice model")
    ec_model = make_model("expert_choice")
    ec_params = train(ec_model)
    ce_train_routing = eval_ce(ec_model, ec_params)
    # decode_model(): the SAME weights under the token-choice fallback
    # routing that autoregressive generation actually uses
    ce_decode_routing = eval_ce(ec_model.decode_model(), ec_params)

    out = {
        "gating": "expert_choice",
        "steps": args.steps,
        "num_experts": args.num_experts,
        "eval_ce_training_routing": round(ce_train_routing, 4),
        "eval_ce_decode_fallback_routing": round(ce_decode_routing, 4),
        "decode_gap_nats": round(ce_decode_routing - ce_train_routing, 4),
    }
    if not args.skip_control:
        note("# training token-choice control")
        tc_model = make_model("topk")
        tc_params = train(tc_model)
        out["control_topk_eval_ce"] = round(eval_ce(tc_model, tc_params), 4)
    if printing:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
