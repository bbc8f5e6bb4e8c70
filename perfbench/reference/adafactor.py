"""Adafactor written plainly, one leaf at a time.

The update rule of ``optax.adafactor`` as the configuration's recipe runs
it: factored second moments over the two largest dims for leaves whose
second-largest dim is at least 128 (ties resolved as numpy's argsort
does), decay ``1 - t ** -0.8``, ``eps`` 1e-30 added to the squared
gradient, the update clipped to an RMS of at most 1, then multiplied by
the learning rate and by the leaf's RMS (at least 1e-3).  The arithmetic
is f32; the parameters and the moments are stored in the parameters'
dtype, which the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

DECAY_RATE = 0.8
EPS = 1e-30
MIN_DIM = 128
CLIP = 1.0


def factored_dims(shape):
    """(d1, d0): the second-largest and the largest dim, or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM:
        return None
    return int(order[-2]), int(order[-1])


def init(p: torch.Tensor) -> dict:
    dims = factored_dims(tuple(p.shape))
    if dims is None:
        return {"v": torch.zeros_like(p)}
    d1, d0 = dims
    shape = list(p.shape)
    row = shape[:d0] + shape[d0 + 1:]
    col = shape[:d1] + shape[d1 + 1:]
    return {"v_row": p.new_zeros(row), "v_col": p.new_zeros(col)}


@torch.no_grad()
def step(p: torch.Tensor, g: torch.Tensor, state: dict, count: int,
         lr: float) -> None:
    """Update ``p`` and ``state`` in place for a gradient ``g``; ``count``
    is the number of steps taken before this one."""
    decay = 1.0 - (count + 1.0) ** -DECAY_RATE
    g2 = g.float() ** 2 + EPS
    dims = factored_dims(tuple(p.shape))
    if dims is None:
        v = decay * state["v"].float() + (1.0 - decay) * g2
        u = g.float() / torch.sqrt(v)
        state["v"].copy_(v)
    else:
        d1, d0 = dims
        vr = decay * state["v_row"].float() + (1.0 - decay) * g2.mean(dim=d0)
        vc = decay * state["v_col"].float() + (1.0 - decay) * g2.mean(dim=d1)
        rd1 = d1 - 1 if d1 > d0 else d1
        row = vr / vr.mean(dim=rd1, keepdim=True)
        u = g.float() / torch.sqrt(row.unsqueeze(d0) * vc.unsqueeze(d1))
        state["v_row"].copy_(vr)
        state["v_col"].copy_(vc)
    u = u / torch.clamp(torch.sqrt((u * u).mean()) / CLIP, min=1.0)
    p32 = p.float()
    u = u * (lr * torch.clamp(torch.sqrt((p32 * p32).mean()), min=1e-3))
    p.copy_(p32 - u)
