"""Random initialisers with the distributions of ``jax.nn.initializers``,
for the model trunks' ``init_params`` (pod mode and the swarm trainer).

They draw from an explicit ``torch.Generator`` on its own device, so the
values differ from JAX's (threefry) draws while the distributions match;
the tests convert the JAX package's parameters where they compare models.
The experts draw JAX's own stream instead (``models/layers.py``
``make_expert``, ``random.truncated_normal``): replicas and handoffs
between the two packages need the same weights.
"""

from __future__ import annotations

import math

import torch


def truncated_normal(shape, std: float, generator: torch.Generator,
                     dtype: torch.dtype) -> torch.Tensor:
    """N(0, std²) truncated to ±2 std, by inverting the normal CDF."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=generator, device=generator.device)
    x = torch.erfinv(u * (hi - lo) + lo) * math.sqrt(2)
    return (x.clamp_(-2.0, 2.0) * std).to(dtype)


def lecun_normal(shape, generator: torch.Generator, dtype: torch.dtype,
                 lead: tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal`` for one leaf of ``shape``
    (fan-in = shape[-2] times any leading dims of ``shape``), drawn
    ``lead`` times over: a stacked-layer leaf is initialised per layer."""
    fan_in = math.prod(shape[:-1])
    # 0.8796...: the std of a unit normal truncated to ±2
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return truncated_normal((*lead, *shape), std, generator, dtype)


def normal(shape, std: float, generator: torch.Generator,
           dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=generator.device)
            * std).to(dtype)
