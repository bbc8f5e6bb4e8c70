"""Swarm-mode DMoE-Transformer: local trunk, network-remote expert FFNs.

The port of ``learning_at_home_tpu/models/transformer_swarm.py``, the
reference's headline training setup: the trainer owns the
embeddings, attention and gates and steps them with its own optimizer;
every MoE FFN layer is a :class:`RemoteMixtureOfExperts` whose experts
live on DHT-discovered servers and update themselves asynchronously on
each backward RPC.

The trunk is plain torch on the params' device (the plain attention of
``models/trunk.py`` and an f32 cross-entropy, as the JAX package computes
this model with XLA's attention and optax's loss); the remote dispatch is
the client's autograd functions, which cross to the host and back.  The
parameter tree is the JAX package's (``convert.swarm_params_from_jax``
carries one across).

Deployment note: run trainers and expert servers in SEPARATE processes
(``python -m learning_at_home_tpu_torch.server``), the normal swarm
topology; ``background_server`` in-process is for light tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.routing import ExpertSource
from learning_at_home_tpu_torch.device import resolve_device
from learning_at_home_tpu_torch.initializers import lecun_normal, normal
from learning_at_home_tpu_torch.models.trunk import causal_attention, layer_norm


@dataclasses.dataclass(frozen=True)
class SwarmTransformerConfig:
    """The JAX package's fields and defaults; ``dtype`` is a torch dtype
    (the params' dtype)."""

    vocab_size: int = 258
    d_model: int = 256
    n_layers: int = 2
    n_heads: int = 8
    seq_len: int = 128
    grid_size: tuple = (16, 16)  # 256-expert grid, [BJ] config 3
    k_best: int = 4
    k_min: int = 1
    backward_k_min: int = 1
    uid_prefix: str = "ffn"
    routing: str = "enumerate"
    dtype: Any = torch.float32
    # generous defaults: a server's first call of a batch bucket happens
    # inside the RPC window
    forward_timeout: float = 60.0
    backward_timeout: float = 60.0
    timeout_after_k_min: float = 1.0
    # "bfloat16"/"float16": downcast activation/grad payloads on the wire
    wire_dtype: Any = None
    # wire codec pin ("none"/"bf16"/"f16"/"u8"/"blockq8"); None = adaptive
    wire_codec: Any = None
    # > 0: debit each expert's selection score by this × its endpoint's
    # RTT EMA (seconds); 0 = off
    latency_weight: float = 0.0
    # latency-aware routing cost model (client/routing.py
    # RoutingCostModel); None falls back to latency_weight; 0 = off
    routing_cost_weight: Any = None
    # DHT scope of the ``load.<prefix>`` heartbeats the cost model reads
    # (must match the servers' --telemetry-prefix)
    telemetry_prefix: str = "swarm"


def _token_tensor(a, device) -> torch.Tensor:
    """Token ids or targets (numpy, list or tensor) as int64 on ``device``."""
    return torch.as_tensor(a).to(device=device, dtype=torch.int64)


class SwarmDMoETransformerLM:
    """Trainer-side model; expert parameters never touch this process."""

    def __init__(self, config: SwarmTransformerConfig, source: ExpertSource):
        self.cfg = config
        # one MoE layer object per transformer layer: layers route to
        # different uid prefixes (ffn0., ffn1., ...) so experts specialize
        self.moes = [
            RemoteMixtureOfExperts(
                in_features=config.d_model,
                grid_size=config.grid_size,
                uid_prefix=f"{config.uid_prefix}{i}",
                source=source,
                k_best=config.k_best,
                k_min=config.k_min,
                backward_k_min=config.backward_k_min,
                routing=config.routing,
                forward_timeout=config.forward_timeout,
                backward_timeout=config.backward_timeout,
                timeout_after_k_min=config.timeout_after_k_min,
                wire_dtype=config.wire_dtype,
                wire_codec=config.wire_codec,
                latency_weight=config.latency_weight,
                routing_cost_weight=config.routing_cost_weight,
                telemetry_prefix=config.telemetry_prefix,
            )
            for i in range(config.n_layers)
        ]

    def init_params(self, rng: torch.Tensor, device=None) -> dict:
        """The JAX package's tree and values for the key ``rng``
        (``random.PRNGKey``): ``embed`` [V, d] and ``pos`` [S, d]
        normal(1/sqrt(d)), ``ln_f``, and per layer ``ln1``, ``wq``, ``wk``,
        ``wv``, ``wo`` (lecun_normal [d, d]), ``ln2`` and the gate's
        ``w0..`` (``init_gate_params``), from ``split(rng, 3 + 6 *
        n_layers)`` consumed in order; drawn on ``device`` (None: the CUDA
        card)."""
        dev = resolve_device(device)
        cfg = self.cfg
        d, v, s = cfg.d_model, cfg.vocab_size, cfg.seq_len
        dt = cfg.dtype
        keys = iter(jrandom.split(rng.to(dev), 3 + 6 * cfg.n_layers))

        def ln():
            return {"scale": torch.ones(d, dtype=dt, device=dev),
                    "bias": torch.zeros(d, dtype=dt, device=dev)}

        params = {
            "embed": normal(next(keys), (v, d), 1.0 / math.sqrt(d), dt),
            "pos": normal(next(keys), (s, d), 1.0 / math.sqrt(d), dt),
            "ln_f": ln(),
            "layers": [],
        }
        for i in range(cfg.n_layers):
            params["layers"].append({
                "ln1": ln(),
                "wq": lecun_normal(next(keys), (d, d), dt),
                "wk": lecun_normal(next(keys), (d, d), dt),
                "wv": lecun_normal(next(keys), (d, d), dt),
                "wo": lecun_normal(next(keys), (d, d), dt),
                "ln2": ln(),
                "gate": self.moes[i].init_gate_params(next(keys)),
            })
        return params

    def _embed(self, params, token_ids) -> torch.Tensor:
        ids = _token_tensor(token_ids, params["embed"].device)
        s = ids.shape[1]
        # F.embedding: its backward is a sorted segment sum, deterministic
        # on both devices (an indexed add with atomics is not)
        return F.embedding(ids, params["embed"]) + params["pos"][None, :s]

    def _logits(self, params, x) -> torch.Tensor:
        return layer_norm(params["ln_f"], x) @ params["embed"].T

    def apply(self, params, token_ids) -> torch.Tensor:
        """Logits [B, S, V] of token ids [B, S]."""
        x = self._embed(params, token_ids)
        b, s, d = x.shape
        for i, lp in enumerate(params["layers"]):
            x = x + causal_attention(lp, layer_norm(lp["ln1"], x),
                                     self.cfg.n_heads)
            moe_in = layer_norm(lp["ln2"], x).reshape(b * s, d)
            moe_out = self.moes[i](moe_in, lp["gate"])
            x = x + moe_out.reshape(b, s, d)
        return self._logits(params, x)

    def apply_overlapped(self, params, token_ids, *, overlap: bool = True):
        """The shortcut-connected parallel-branch wiring, as the JAX
        package's: each layer's MoE branch reads ``ln2`` of the layer
        INPUT (not the post-attention residual), so the expert fan-out for
        layer *i* can be FIRED before its attention.  The overlapped
        schedule fires, computes the attention while the RPCs fly, and
        joins where the residual add needs the replies; the backward
        mirrors it (the join op's backward fires the gradient fan-out, the
        fire op's backward joins it).

        ``overlap=False`` runs the SAME ops in the serial schedule (join
        right after fire): only host-side scheduling differs, so the two
        schedules' outputs and gradients are bitwise equal."""
        x = self._embed(params, token_ids)
        b, s, d = x.shape
        for i, lp in enumerate(params["layers"]):
            moe = self.moes[i]
            moe_in = layer_norm(lp["ln2"], x).reshape(b * s, d)
            pending = moe.fire(moe_in, lp["gate"])
            try:
                if not overlap:  # serial schedule: wait right here
                    moe_out = moe.join(*pending)
                x = x + causal_attention(lp, layer_norm(lp["ln1"], x),
                                         self.cfg.n_heads)
                if overlap:  # join as late as the data dependency allows
                    moe_out = moe.join(*pending)
            except Exception:
                # a raise between fire and join must not leak the
                # in-flight fan-out (no-op if the join consumed it)
                moe.discard(*pending)
                raise
            x = x + moe_out.reshape(b, s, d)
        return self._logits(params, x)

    @staticmethod
    def _cross_entropy(logits, targets) -> torch.Tensor:
        """Mean integer-label softmax cross-entropy in f32 (optax's)."""
        tgt = _token_tensor(targets, logits.device)
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               tgt.reshape(-1))

    def loss_fn(self, params, token_ids, targets) -> torch.Tensor:
        return self._cross_entropy(self.apply(params, token_ids), targets)

    def loss_fn_overlapped(self, params, token_ids, targets, *,
                           overlap: bool = True) -> torch.Tensor:
        return self._cross_entropy(
            self.apply_overlapped(params, token_ids, overlap=overlap), targets)

    @staticmethod
    def _step(grad_fn: Callable, optimizer: optim.GradientTransformation
              ) -> Callable:
        def step(params, opt_state, ids, targets):
            loss, grads = grad_fn(params, ids, targets)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optim.applied_updates(params, updates), opt_state, loss

        return step

    def make_train_step(self, optimizer: optim.GradientTransformation
                        ) -> Callable:
        """Eager train step ``(params, opt_state, ids, targets) -> (params,
        opt_state, loss)``: local grads by autograd (backward RPCs fire
        inside), the optimizer on trunk and gates only; returns a new
        params tree."""
        return self._step(optim.value_and_grad(self.loss_fn), optimizer)

    def make_overlapped_train_step(
        self, optimizer: optim.GradientTransformation, *,
        overlap: bool = True,
    ) -> Callable:
        """Train step over the shortcut architecture; ``overlap`` selects
        the schedule (overlapped or serial) without changing an op."""

        def loss(params, ids, targets):
            return self.loss_fn_overlapped(params, ids, targets,
                                           overlap=overlap)

        return self._step(optim.value_and_grad(loss), optimizer)
