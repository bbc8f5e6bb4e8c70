"""Analytic sizing of the flagship train step: FLOPs, state and
activation bytes, and the card's constants.

The port's copy of the JAX repo's ``bench.py`` sizing
(``_model_flops_per_step``, ``_tree_bytes``, ``_static_state_bytes``,
``_activation_bytes``), of ``experiments/profile_step.py``'s
``dots_extra_bytes`` and of the single-device flagship configuration of
``__graft_entry__.py`` (:func:`flagship_config`), under the same names.
Where the JAX code sizes a tree with ``jax.eval_shape``, the port builds
the tree of meta tensors (shapes and dtypes, no memory) in the model's
layout (``convert.param_shapes``: stacked or a tuple of layers) and runs
the optimizer's own ``init`` on it, so the state's bytes are the
optimizer's, whichever it is.  Nothing here allocates on a device.

The card's constants take the place of the TPU tables, keyed by
``torch.cuda.get_device_name()``: :data:`CARD_PEAK_BF16` (dense bf16
FLOP/s, the MFU denominator), :data:`CARD_HBM_BPS` (memory bytes a
second, the roofline's bandwidth floor) and :func:`card_hbm_bytes` (the
card's own ``total_memory``).  The numbers are NVIDIA's data-sheet peaks
of the SXM part at its full 700 W power limit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from learning_at_home_tpu_torch.convert import param_shapes
from learning_at_home_tpu_torch.models.transformer import DMoETransformerConfig
from learning_at_home_tpu_torch.tree import tree_leaves

H100 = "NVIDIA H100 80GB HBM3"
# dense bf16 FLOP/s a card, by torch.cuda.get_device_name()
CARD_PEAK_BF16 = {H100: 989e12}
# memory bandwidth, bytes a second, by torch.cuda.get_device_name()
CARD_HBM_BPS = {H100: 3.35e12}


def card_hbm_bytes(device=None) -> int:
    """The card's memory in bytes (``total_memory``)."""
    return torch.cuda.get_device_properties(device).total_memory


def flagship_config(**overrides) -> DMoETransformerConfig:
    """The 256-expert flagship ([BJ] config 3's grid) of the JAX repo's
    single-device entry point, with ``overrides`` replacing fields."""
    cfg = DMoETransformerConfig(
        vocab_size=32768,
        d_model=512,
        n_layers=4,
        n_heads=8,
        seq_len=256,
        num_experts=256,
        k=2,
        dtype=torch.bfloat16,
    )
    return dataclasses.replace(cfg, **overrides)


def _model_flops_per_step(cfg, batch: int) -> float:
    """Analytic model FLOPs for one train step (fwd+bwd ≈ 3× fwd matmuls)."""
    d, s, v, L = cfg.d_model, cfg.seq_len, cfg.vocab_size, cfg.n_layers
    f = 4 * d  # ShardedMixtureOfExperts ffn_mult=4
    per_token_fwd = (
        2 * d * v  # logits projection (tied embedding)
        + L * (8 * d * d + 4 * s * d + cfg.k * 4 * d * f)
    )
    return 3.0 * per_token_fwd * batch * s


def _tree_bytes(tree) -> int:
    """Bytes of a tree of tensors (meta tensors included)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def abstract_params(cfg):
    """The param tree of ``cfg`` in its layout as meta tensors of
    ``cfg.param_dtype``: the counterpart of ``jax.eval_shape`` of
    ``init_params``."""

    def meta(shapes):
        if isinstance(shapes, dict):
            return {key: meta(val) for key, val in shapes.items()}
        if shapes and isinstance(shapes[0], dict):  # the tuple layout
            return tuple(meta(layer) for layer in shapes)
        return torch.empty(shapes, dtype=cfg.param_dtype, device="meta")

    return meta(param_shapes(cfg))


def _static_state_bytes(cfg, optimizer) -> int:
    """Exact params+opt-state+grads bytes of a model of ``cfg`` (the JAX
    function takes the model; the shapes are its config's) from meta
    tensors: no device allocation, batch-independent."""
    params = abstract_params(cfg)
    params_b = _tree_bytes(params)
    opt_b = _tree_bytes(optimizer.init(params))
    return 2 * params_b + opt_b  # cotangents live alongside params


def _activation_bytes(cfg, batch: int) -> int:
    """Dominant activation terms for one train step (f32 logits fwd+bwd,
    per-layer residual stream, MoE dispatch buffers)."""
    s, v, d, L, E = (
        cfg.seq_len, cfg.vocab_size, cfg.d_model, cfg.n_layers,
        cfg.num_experts,
    )
    tokens = batch * s
    cap = math.ceil(cfg.capacity_factor * cfg.k * tokens / E)
    act_dtype = cfg.dtype.itemsize
    ce_chunk = min(cfg.ce_chunk, tokens)
    if cfg.remat:
        # checkpointed layers save only their INPUT; internals (attn
        # saves, dispatch buffers, router scores) live for one layer at
        # a time during the recomputing backward
        per_layer = tokens * d * act_dtype * 2 * L
        live = (
            tokens * d * act_dtype * 10
            + E * cap * d * act_dtype * 4
            + tokens * E * 4 * 2
        )
    else:
        per_layer = tokens * d * act_dtype * 10 * L
        live = E * cap * d * act_dtype * 4 * L + tokens * E * 4 * 2
    return (
        ce_chunk * v * 4 * 3  # f32 logits+grads+temps, ONE CE chunk at a time
        + tokens * d * act_dtype * 2  # saved final hidden + its cotangent
        + per_layer
        + live
    )


def dots_extra_bytes(cfg, batch: int) -> int:
    """Extra live bytes of remat_policy='dots' vs 'full': per-layer saved
    matmul outputs (qkv, attention out, wo out, MoE h/ye, router logits)."""
    s, d, L, E = cfg.seq_len, cfg.d_model, cfg.n_layers, cfg.num_experts
    tokens = batch * s
    cap = math.ceil(cfg.capacity_factor * cfg.k * tokens / E)
    act = cfg.dtype.itemsize
    per_layer = (
        tokens * d * act * 5  # q, k, v, attn-out, wo-out
        + E * cap * (4 * d) * act  # MoE hidden h [E, C, ffn]
        + E * cap * d * act  # MoE ye
        + tokens * E * 4  # router logits (f32)
    )
    return per_layer * L


def estimated_peak_bytes(cfg, optimizer, batch: int) -> int:
    """profile_step's estimate of a variant's peak: the static state, the
    activations and, under ``remat_policy="dots"``, its saved matmul
    outputs."""
    need = _static_state_bytes(cfg, optimizer) + _activation_bytes(cfg, batch)
    if cfg.remat and cfg.remat_policy == "dots":
        need += dots_extra_bytes(cfg, batch)
    return need
