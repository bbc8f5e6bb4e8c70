"""The initialisers of ``jax.nn.initializers`` that the model trunks'
``init_params`` use (pod mode, the sharded MoE, the swarm trainer and its
gate), drawn from JAX's key stream: one key gives the JAX package's
values (``random.normal`` and ``random.truncated_normal``,
``tests/test_torch_init_parity.py``).  Each draws on its key's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import random as jrandom

# the std of a unit normal truncated to +-2
_TRUNCATED_STD = 0.87962566103423978


def _scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def lecun_std(fan_in: int, dtype: torch.dtype) -> torch.Tensor:
    """``variance_scaling(1, "fan_in", "truncated_normal")``'s std in
    ``dtype`` as JAX computes it: ``sqrt(dtype(1 / fan_in)) /
    dtype(0.8796...)``, each step rounded to ``dtype``."""
    variance = _scalar(1.0 / fan_in, dtype)
    return torch.sqrt(variance) / _scalar(_TRUNCATED_STD, dtype)


def lecun_normal(key: torch.Tensor, shape: tuple[int, ...],
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal()(key, shape, dtype)``: a
    normal truncated to +-2 stds, fan-in the product of every dim but the
    last (in_axis -2, leading dims a receptive field)."""
    std = lecun_std(math.prod(shape[:-1]), dtype).to(key.device)
    return jrandom.truncated_normal(key, -2.0, 2.0, shape, dtype) * std


def normal(key: torch.Tensor, shape: tuple[int, ...], stddev: float,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.nn.initializers.normal(stddev)(key, shape, dtype)``."""
    std = _scalar(float(np.float64(stddev)), dtype).to(key.device)
    return jrandom.normal(key, shape, dtype) * std
