"""Expert layer zoo: the sample blocks servers can host, by registry name.

The port of ``learning_at_home_tpu/models/layers.py``.  Each block is an
``nn.Module`` built of flax-shaped pieces (:class:`Dense`,
:class:`LayerNorm`, :class:`MultiHeadDotProductAttention`) whose
parameter names and layouts are flax's, so :func:`params_tree` of a block
is the tree ``module.init`` gives in the JAX package, e.g.
``{"params": {"Dense_0": {"kernel": [in, out], "bias": [out]},
"LayerNorm_0": {"scale", "bias"}, ...}}``, and weights convert leaf for
leaf (``convert.py``).  Servers run the blocks functionally:
:func:`make_expert` returns ``(apply_fn, params)`` with
``apply_fn(params, *inputs)`` a ``torch.func.functional_call`` of a block
built on the meta device, so the one parameter tree lives with the
optimizer state on the backend's device.  :func:`make_expert` draws the
parameters ``module.init(key, ...)`` draws in the JAX package: each
kernel from flax's key for its module path and ``lecun_normal``'s
truncated normal through ``random.py`` (JAX's threefry and XLA's f32
``erf_inv``), so a port server and a JAX server hosting one uid start
from the same weights.

Numerics follow flax: ``nn.gelu`` is the tanh approximation, LayerNorm
uses eps 1e-6 and flax's fast variance (mean of squares minus squared
mean), and attention scales the query by ``1/sqrt(head_dim)``.  The
deterministic-dropout block draws JAX's threefry masks bit for bit
(``random.py``), so backward's re-forward sees the forward's mask.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.device import resolve_device

LAYER_NORM_EPS = 1e-6  # flax's default (the trunk's norm uses 1e-5)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation by default."""
    return F.gelu(x, approximate="tanh")


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, kernel [in, out]."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = (nn.Parameter(torch.empty(features)) if use_bias
                     else None)

    def forward(self, x):
        y = x.to(self.dtype) @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, ``var = mean(x²) - mean²``
    clamped at 0, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, features: int, dtype=torch.float32,
                 eps: float = LAYER_NORM_EPS):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        mean2 = (x32 * x32).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x32 - mean) * mul + self.bias).to(self.dtype)


class _DenseGeneral(nn.Module):
    """The projections of flax's attention: kernel [*in_shape, *out_shape]
    (``query``/``key``/``value``: [d, heads, head_dim]; ``out``: [heads,
    head_dim, d]), bias of the output shape."""

    def __init__(self, in_shape: tuple, out_shape: tuple):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape))
        self.bias = nn.Parameter(torch.empty(*out_shape))

    def forward(self, x):
        contract = list(range(x.dim() - self.n_in, x.dim()))
        y = torch.tensordot(x, self.kernel,
                            dims=(contract, list(range(self.n_in))))
        return y + self.bias


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads)(x, x)`` with its
    defaults: q/k/v of width d, biases, no mask, no dropout.  Attention
    runs over the second-to-last axis of ``x`` (a 2-D [rows, d] input
    attends across its rows, as flax's does)."""

    def __init__(self, features: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"hidden_dim {features} is not a multiple of "
                             f"num_heads {num_heads}")
        self.dtype = dtype
        self.head_dim = features // num_heads
        proj = ((features,), (num_heads, self.head_dim))
        self.query = _DenseGeneral(*proj)
        self.key = _DenseGeneral(*proj)
        self.value = _DenseGeneral(*proj)
        self.out = _DenseGeneral((num_heads, self.head_dim), (features,))

    def forward(self, x):
        x = x.to(self.dtype)
        q = self.query(x) / math.sqrt(self.head_dim)  # [..., L, H, hd]
        k, v = self.key(x), self.value(x)
        w = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), -1)
        return self.out(torch.einsum("...hqk,...khd->...qhd", w, v))


class FeedforwardBlock(nn.Module):
    """Residual pre-LN MLP expert: LN → Dense(4h) → GELU → Dense(h) + x."""

    # inputs of at least this rank are mapped row by row (dim 0) with no
    # row reading another (ExpertBackend.forward evaluates them in tiles)
    rows_independent_ndim = 1

    def __init__(self, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype)
        self.Dense_0 = Dense(hidden_dim, 4 * hidden_dim, dtype=dtype)
        self.Dense_1 = Dense(4 * hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, x):
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_0(x))))
        return x + h


class TransformerEncoderBlock(nn.Module):
    """Pre-LN transformer encoder layer expert over [..., seq, hidden]."""

    # a [rows, hidden] input attends across its rows (as flax's block
    # does); from [rows, seq, hidden] on, each row attends within itself
    rows_independent_ndim = 3

    def __init__(self, hidden_dim: int, num_heads: int = 8,
                 dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            hidden_dim, num_heads, dtype)
        self.LayerNorm_1 = LayerNorm(hidden_dim, dtype)
        self.Dense_0 = Dense(hidden_dim, 4 * hidden_dim, dtype=dtype)
        self.Dense_1 = Dense(4 * hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        h = self.Dense_1(gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + h


class SwiGLUBlock(nn.Module):
    """Residual pre-LN SwiGLU expert: LN → (W1·x) ⊙ silu(Wg·x) → W2 + x,
    branch width ``8*h//3``, no biases."""

    rows_independent_ndim = 1

    def __init__(self, hidden_dim: int, dtype=torch.float32):
        super().__init__()
        width = 8 * hidden_dim // 3
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype)
        self.Dense_0 = Dense(hidden_dim, width, use_bias=False, dtype=dtype)
        self.Dense_1 = Dense(hidden_dim, width, use_bias=False, dtype=dtype)
        self.Dense_2 = Dense(width, hidden_dim, use_bias=False, dtype=dtype)

    def forward(self, x):
        h = self.LayerNorm_0(x)
        h = self.Dense_0(h) * F.silu(self.Dense_1(h))
        return x + self.Dense_2(h)


class DeterministicDropoutBlock(nn.Module):
    """FFN expert with dropout that is a pure function of a per-row seed.

    The server's backward re-runs the forward (``expert_backend.py``), so
    the mask derives only from the wire inputs: row ``i`` keeps feature
    ``j`` where ``jax.random.bernoulli(PRNGKey(seed[i]), 1 - rate,
    (4h,))[j]``, the JAX block's mask bit for bit."""

    rows_independent_ndim = 1

    def __init__(self, hidden_dim: int, rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.hidden_dim, self.rate = hidden_dim, rate
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype)
        self.Dense_0 = Dense(hidden_dim, 4 * hidden_dim, dtype=dtype)
        self.Dense_1 = Dense(4 * hidden_dim, hidden_dim, dtype=dtype)

    @staticmethod
    def wire_inputs(hidden_dim: int, rows: int) -> list:
        """x plus a per-row int32 mask seed (see sample_inputs)."""
        return [
            np.zeros((rows, hidden_dim), np.float32),
            np.arange(rows, dtype=np.int32),
        ]

    def masks(self, seed: torch.Tensor) -> torch.Tensor:
        """The keep masks [*seed.shape, 4h] (bool) of the rows' seeds."""
        keep = 1.0 - self.rate
        return jrandom.bernoulli(jrandom.PRNGKey(seed), keep,
                                 (4 * self.hidden_dim,))

    def forward(self, x, seed):
        h = gelu(self.Dense_0(self.LayerNorm_0(x)))
        keep = 1.0 - self.rate
        h = h * self.masks(seed).to(h.dtype) / keep
        return x + self.Dense_1(h)


class NopBlock(nn.Module):
    """Identity expert with one trainable scalar ``scale`` — isolates the
    batching/transport overhead from compute in benchmarks."""

    rows_independent_ndim = 1

    def __init__(self, hidden_dim: int = 0, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(()))

    def forward(self, x):
        return x * self.scale


name_to_block: dict[str, Callable[..., nn.Module]] = {
    "ffn": FeedforwardBlock,
    "transformer": TransformerEncoderBlock,
    "swiglu": SwiGLUBlock,
    "det_dropout": DeterministicDropoutBlock,
    "nop": NopBlock,
}


def sample_inputs(expert_cls: str, hidden_dim: int, rows: int = 2) -> list:
    """One example row-batch per wire input for a registry expert (numpy,
    as the wire carries them): a block with a ``wire_inputs`` staticmethod
    declares its own; the others take one ``[rows, hidden]`` f32 tensor."""
    wire = getattr(name_to_block[expert_cls], "wire_inputs", None)
    if wire is not None:
        return wire(hidden_dim, rows)
    return [np.zeros((rows, hidden_dim), np.float32)]


def params_tree(module: nn.Module, params: dict | None = None) -> dict:
    """``{"params": nested}`` of ``module``'s parameters by name, flax's
    tree with its keys sorted (jax's flatten order, so every tree of the
    expert — params, gradients, optimizer moments — walks alike);
    ``params`` (a flat ``{dotted name: tensor}``) replaces the module's
    own tensors."""
    flat = params if params is not None else dict(module.named_parameters())
    tree: dict = {}
    for name in sorted(flat):
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = flat[name]

    def ordered(node):
        return {k: ordered(node[k]) if isinstance(node[k], dict) else node[k]
                for k in sorted(node)}

    return {"params": ordered(tree)}


def flat_params(tree: dict) -> dict:
    """:func:`params_tree`'s inverse: ``{dotted name: tensor}``."""
    out: dict = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                walk(value, name + ".")
            else:
                out[name] = value

    walk(tree["params"], "")
    return out


def flax_param_key(key: torch.Tensor, path, counter: int) -> torch.Tensor:
    """The key flax's ``module.init(key, ...)`` hands the ``counter``-th
    parameter (1-based, declaration order) of the module at ``path`` (its
    names from the root, e.g. ``("MultiHeadDotProductAttention_0",
    "query")``): ``flax.core.scope._fold_in_static`` of the path and the
    counter, the first 4 bytes of their SHA-1 (no separators: flax
    0.12.3's default ``flax_fix_rng_separator=False``) folded into ``key``
    as one ``fold_in``."""
    digest = hashlib.sha1()
    for part in (*path, counter):
        if isinstance(part, str):
            digest.update(part.encode("utf-8"))
        else:
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, "big"))
    return jrandom.fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


def lecun_std(fan_in: int) -> float:
    """``lecun_normal``'s std, in f32 as JAX computes it:
    ``sqrt(f32(1 / fan_in)) / 0.87962566103423978`` (0.8796...: the std
    of a unit normal truncated to +-2)."""
    variance = np.float32(1.0 / fan_in)
    return float(np.float32(np.sqrt(variance))
                 / np.float32(0.87962566103423978))


def init_params(module: nn.Module, key: torch.Tensor, device) -> dict:
    """``module.init(key, ...)``'s parameters in the JAX package, on
    ``device`` (drawn there: the draw gives the CPU's values on every
    device): Dense and attention kernels ``lecun_normal`` (a truncated
    normal of std ``1/sqrt(fan_in)``, fan-in the product of the contracted
    dims) from flax's key for the kernel (its module's first parameter),
    zero biases, unit LayerNorm and Nop scales."""
    key = key.to(device)
    params = {}
    for name, meta in module.named_parameters():
        *path, leaf = name.split(".")
        shape = tuple(meta.shape)
        if leaf == "kernel":
            owner = module.get_submodule(".".join(path))
            fan_in = math.prod(shape[:getattr(owner, "n_in", 1)])
            value = jrandom.truncated_normal(
                flax_param_key(key, path, 1), -2.0, 2.0, shape
            ) * lecun_std(fan_in)
        elif leaf == "scale":
            value = torch.ones(shape, device=device)
        else:
            value = torch.zeros(shape, device=device)
        params[name] = value
    return params_tree(module, params)


def make_expert(expert_cls: str, hidden_dim: int, key: torch.Tensor,
                dtype=torch.float32, device=None) -> tuple[Callable, dict]:
    """``(apply_fn, params)`` for an ExpertBackend from a registry name:
    the params the JAX package's ``make_expert(expert_cls, hidden_dim,
    key)`` draws (``key``: a ``random.PRNGKey``), on ``device`` (None: the
    CUDA card), ``apply_fn(params, *inputs)`` the block applied with
    them.  ``apply_fn.rows_independent_ndim`` is the block's: inputs of
    that rank or more may be evaluated in row tiles."""
    dev = resolve_device(device)
    with torch.device("meta"):
        module = name_to_block[expert_cls](hidden_dim=hidden_dim, dtype=dtype)
    params = init_params(module, key, dev)

    def apply_fn(params, *inputs):
        return torch.func.functional_call(module, flat_params(params), inputs)

    apply_fn.rows_independent_ndim = module.rows_independent_ndim
    return apply_fn, params
