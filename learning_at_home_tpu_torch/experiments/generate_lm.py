"""Autoregressive generation from a pod-mode DMoE-Transformer checkpoint.

The port of ``experiments/generate_lm.py``: its flags, JSON lines and exit
codes, plus ``--device`` (default: the CUDA card; without one it raises).
It restores a checkpoint saved by ``train_lm --mode pod --checkpoint-dir``
(the port's on-disk form), decodes continuations for a prompt with the
KV-cache decoder (``generate(use_cache=True)``) or the re-forward one
(``--no-cache``), and reports decode steps/sec; ``--no-checkpoint`` runs
on random weights from ``--seed`` as a throughput probe.  At ``--seq-len``
8192 on the card the prefill runs the flash-attention kernel (the
``attn_impl="auto"`` rule).

``--swarm`` decodes against live expert servers instead: the trunk runs
here and every MoE layer goes over the wire through the serving gateway's
:class:`~learning_at_home_tpu_torch.models.swarm_decoder.SwarmKVDecoder`,
dense or paged, with experts typed (``--expert-server``) or discovered
(``--initial-peers``).

Usage:
  python -m learning_at_home_tpu_torch.experiments.generate_lm \\
      --checkpoint-dir ckpt --prompt "the meaning of life" \\
      --max-new-tokens 64
  python -m learning_at_home_tpu_torch.experiments.generate_lm \\
      --no-checkpoint --bench 128
  python -m learning_at_home_tpu_torch.experiments.generate_lm \\
      --no-checkpoint --swarm --expert-server 127.0.0.1:31337 \\
      --prompt "the " --max-new-tokens 16
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_ep(s: str) -> tuple[str, int]:
    host, sep, port = s.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"endpoint {s!r} must be host:port")
    return (host, int(port))


def _restore_params(checkpoint_dir: str, params):
    """The newest complete step's params as whole leaves on ``params``'
    devices and in their dtypes (a bf16 checkpoint widens exactly, as
    orbax casts to its template), whether one process or the ranks of a
    mesh (``train_lm --mode pod`` on N ranks) saved it."""
    from learning_at_home_tpu_torch.convert import numpy_to_tensor
    from learning_at_home_tpu_torch.utils.checkpoint import (
        latest_step,
        restore_pytree,
    )
    from learning_at_home_tpu_torch.utils.nested import nested_map

    step = latest_step(checkpoint_dir)
    if step is None:
        raise SystemExit(f"no checkpoint under {checkpoint_dir}")

    def leaf(arr, t):
        if tuple(arr.shape) != tuple(t.shape):
            raise SystemExit(
                f"checkpoint leaf of shape {tuple(arr.shape)} where the "
                f"model has {tuple(t.shape)}: pass train_lm's widths")
        return numpy_to_tensor(arr, t.device).to(t.dtype)

    params = nested_map(leaf, restore_pytree(checkpoint_dir, step, "params",
                                             params), params)
    print(f"# restored step {step}", file=sys.stderr, flush=True)
    return params


def _swarm_main(p, args, dev) -> dict:
    """The ``--swarm`` arm: local trunk + remote experts through the
    gateway's own KV decoder."""
    from learning_at_home_tpu_torch import random as prng
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.routing import StaticExpertSource
    from learning_at_home_tpu_torch.models.data import (
        VOCAB_SIZE,
        encode_bytes,
    )
    from learning_at_home_tpu_torch.models.swarm_decoder import (
        SwarmKVDecoder,
    )
    from learning_at_home_tpu_torch.models.transformer_swarm import (
        SwarmDMoETransformerLM,
        SwarmTransformerConfig,
    )

    dht = None
    if args.initial_peers:
        from learning_at_home_tpu_torch.dht import DHT

        source = dht = DHT(
            initial_peers=[_parse_ep(s) for s in args.initial_peers])
    elif args.expert_server:
        eps = [_parse_ep(s) for s in args.expert_server]
        if len(eps) == 1:
            eps = eps * args.n_layers
        if len(eps) != args.n_layers:
            p.error(f"--expert-server: pass 1 endpoint or exactly "
                    f"n_layers ({args.n_layers})")
        source = StaticExpertSource({
            f"{args.uid_prefix}{layer}.{e}": eps[layer]
            for layer in range(args.n_layers)
            for e in range(args.experts_per_layer)
        })
    else:
        p.error("--swarm needs --expert-server or --initial-peers")

    cfg = SwarmTransformerConfig(
        vocab_size=VOCAB_SIZE,
        d_model=args.d_model,
        n_layers=args.n_layers,
        seq_len=args.seq_len,
        grid_size=(args.experts_per_layer,),
        k_best=args.k,
        uid_prefix=args.uid_prefix,
    )
    model = SwarmDMoETransformerLM(cfg, source)
    params = model.init_params(prng.PRNGKey(args.seed), device=dev)
    if args.checkpoint_dir:
        params = _restore_params(args.checkpoint_dir, params)

    prompt = [int(t) for t in encode_bytes(args.prompt)]
    if not prompt:
        raise SystemExit("--prompt must encode to at least one byte")
    if len(prompt) + args.max_new_tokens > cfg.seq_len:
        raise SystemExit(
            f"prompt ({len(prompt)}) + max_new_tokens "
            f"({args.max_new_tokens}) exceeds seq_len {cfg.seq_len}"
        )
    kv_kwargs = {"kv_layout": args.kv_layout, "device": dev}
    if args.kv_layout == "paged":
        kv_kwargs["page_len"] = args.page_len
    out = {}
    try:
        dec = SwarmKVDecoder(model, params, max_slots=args.batch, **kv_kwargs)
        outs = dec.generate([prompt] * args.batch, args.max_new_tokens)
        out["tokens"] = outs
        text = bytes(t for t in outs[0] if t < 256).decode(
            "utf-8", errors="replace")
        print(json.dumps({"completion": text, "mode": "swarm"}), flush=True)
        if args.bench:
            n = args.bench
            if len(prompt) + n > cfg.seq_len:
                raise SystemExit(f"--bench {n} exceeds seq_len headroom")
            bench_dec = SwarmKVDecoder(model, params, max_slots=args.batch,
                                       **kv_kwargs)
            t0 = time.perf_counter()
            bench_dec.generate([prompt] * args.batch, n)
            dt = time.perf_counter() - t0
            out["bench_s"] = dt
            print(json.dumps({
                "decode_steps_per_sec": round(n / dt, 1),
                "tokens_per_sec": round(args.batch * n / dt, 1),
                "mode": "swarm",
                "batch": args.batch,
                "seq_len": cfg.seq_len,
                "kv_layout": args.kv_layout,
            }), flush=True)
    finally:
        if dht is not None:
            dht.shutdown()
        reset_client_rpc()
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--no-checkpoint", action="store_true",
                   help="random init (throughput probe)")
    p.add_argument("--prompt", default="the ")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--batch", type=int, default=1,
                   help="decode the prompt this many times in parallel")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--num-experts", type=int, default=256)
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--no-cache", action="store_true",
                   help="use the O(S^2) re-forward decoder instead")
    p.add_argument("--bench", type=int, default=0, metavar="N",
                   help="also time N decode steps (steady state)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--swarm", action="store_true",
                   help="decode against live expert servers (the gateway's "
                        "KV decoder) instead of the pod-mode model")
    p.add_argument("--kv-layout", choices=("dense", "paged"),
                   default="dense",
                   help="[swarm] KV cache layout: the static per-slot "
                        "table, or the paged pool the gateway serves from "
                        "(the same tokens either way)")
    p.add_argument("--page-len", type=int, default=16,
                   help="[swarm] tokens per KV page for --kv-layout paged")
    p.add_argument("--expert-server", action="append", default=[],
                   metavar="HOST:PORT",
                   help="[swarm] expert server endpoint; one entry maps "
                        "every expert to it, n_layers entries map layer-wise")
    p.add_argument("--initial-peers", nargs="+", default=None,
                   metavar="HOST:PORT",
                   help="[swarm] DHT bootstrap peers (experts discovered "
                        "instead of typed)")
    p.add_argument("--uid-prefix", default="ffn",
                   help="[swarm] expert uid prefix (layer l expert e is "
                        "<prefix><l>.<e>)")
    p.add_argument("--experts-per-layer", type=int, default=2)
    p.add_argument("--device", default=None,
                   help="torch device of the model (default: the CUDA "
                        "card; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> dict:
    """Runs the CLI; returns ``{"tokens": ..., "bench_s": ...}`` (the
    generated ids and the timed run's seconds) for callers in-process."""
    p = build_parser()
    args = p.parse_args(argv)
    if not args.checkpoint_dir and not args.no_checkpoint:
        p.error("pass --checkpoint-dir or --no-checkpoint")
    from learning_at_home_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.swarm:
        if args.temperature > 0 or args.no_cache:
            p.error("--swarm decodes greedily through the KV decoder "
                    "(no --temperature / --no-cache)")
        return _swarm_main(p, args, dev)

    import numpy as np
    import torch

    from learning_at_home_tpu_torch import random as prng
    from learning_at_home_tpu_torch.models.data import (
        VOCAB_SIZE,
        encode_bytes,
    )
    from learning_at_home_tpu_torch.models.transformer import (
        DMoETransformerConfig,
        DMoETransformerLM,
    )

    cfg = DMoETransformerConfig(
        vocab_size=VOCAB_SIZE,
        d_model=args.d_model,
        n_layers=args.n_layers,
        seq_len=args.seq_len,
        num_experts=args.num_experts,
        k=args.k,
        dtype=torch.bfloat16 if dev.type != "cpu" else torch.float32,
    )
    model = DMoETransformerLM(cfg, device=dev)
    params = model.init_params(prng.PRNGKey(args.seed))
    if args.checkpoint_dir:
        params = _restore_params(args.checkpoint_dir, params)

    prompt = np.asarray(encode_bytes(args.prompt), np.int32)
    if len(prompt) == 0:
        raise SystemExit(
            "--prompt must encode to at least one byte (an empty prompt "
            "would mis-index the decode buffer)")
    if len(prompt) + args.max_new_tokens > cfg.seq_len:
        raise SystemExit(
            f"prompt ({len(prompt)}) + max_new_tokens "
            f"({args.max_new_tokens}) exceeds seq_len {cfg.seq_len}")
    ids = torch.from_numpy(np.tile(prompt[None, :], (args.batch, 1)))
    rng = prng.PRNGKey(args.seed) if args.temperature > 0 else None

    gen_kw = dict(temperature=args.temperature, rng=rng,
                  use_cache=not args.no_cache)
    out_ids = model.generate(params, ids, args.max_new_tokens, **gen_kw)
    tokens = out_ids.cpu().numpy()
    text = bytes(int(t) for t in tokens[0] if int(t) < 256).decode(
        "utf-8", errors="replace")
    print(json.dumps({"completion": text}), flush=True)
    out = {"tokens": tokens}

    if args.bench:
        n = args.bench
        if len(prompt) + n > cfg.seq_len:
            raise SystemExit(f"--bench {n} exceeds seq_len headroom")

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        # warm up, and let the warm-up's work finish before the timer
        model.generate(params, ids, n, **gen_kw)
        sync()
        t0 = time.perf_counter()
        model.generate(params, ids, n, **gen_kw)
        sync()
        dt = time.perf_counter() - t0
        out["bench_s"] = dt
        print(json.dumps({
            "decode_steps_per_sec": round(n / dt, 1),
            "tokens_per_sec": round(args.batch * n / dt, 1),
            "use_cache": not args.no_cache,
            "temperature": args.temperature,
            "batch": args.batch,
            "seq_len": cfg.seq_len,
        }), flush=True)
    return out


if __name__ == "__main__":
    main()
