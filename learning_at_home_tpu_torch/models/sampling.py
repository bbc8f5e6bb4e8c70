"""Counter-based sampling for the swarm decoder, the JAX package's draws.

The token at absolute sequence index ``i`` of a stream is drawn under the
key ``fold_in(PRNGKey(seed), i)`` (``random.py``, threefry bit for bit),
so no draw depends on when or in which batch a position is decoded:
recompute after preemption, coalesced and solo execution, prefill
chunking and self-speculative verification all visit the same
``(seed, position)`` pairs and sample the same tokens.  ``temperature ==
0`` is argmax (the first maximum), the greedy decoder's bits.

A sampled draw runs on the host in f32 whatever device the logits come
from, so the card and the CPU draw the same token from the same logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from learning_at_home_tpu_torch import random as jrandom

_MAX_SEED = 2 ** 63 - 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-stream sampling configuration, validated at construction so
    the gateway front door can surface hostile values as well-formed
    error frames (ValueError) before the decode thread sees them."""

    seed: int = 0
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if not (0 <= int(self.seed) <= _MAX_SEED):
            raise ValueError(
                f"seed must be in [0, 2**63), got {self.seed!r}"
            )
        t = float(self.temperature)
        if not math.isfinite(t) or t < 0.0:
            raise ValueError(
                f"temperature must be a finite number >= 0, got "
                f"{self.temperature!r}"
            )
        p = float(self.top_p)
        if not math.isfinite(p) or not 0.0 < p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p!r}"
            )
        if int(self.top_k) < 0:
            raise ValueError(
                f"top_k must be >= 0 (0 disables), got {self.top_k!r}"
            )

    @property
    def greedy(self) -> bool:
        return float(self.temperature) == 0.0

    def to_meta(self) -> dict:
        """The wire representation (gen_submit fields)."""
        return {
            "seed": int(self.seed),
            "temperature": float(self.temperature),
            "top_p": float(self.top_p),
            "top_k": int(self.top_k),
        }


def _row(logits) -> torch.Tensor:
    if isinstance(logits, torch.Tensor):
        return logits.detach().reshape(-1)
    return torch.from_numpy(np.asarray(logits)).reshape(-1)


def sample_token(
    logits, params: Optional[SamplingParams], position: int
) -> int:
    """Draw the token at absolute sequence index ``position`` from one
    row of logits (a tensor on any device, or an array).

    ``params is None`` or ``temperature == 0`` is argmax.  Otherwise, in
    f32 on the host: scale by temperature, keep what is >= the k-th
    largest logit (ties kept), keep the nucleus (a stable descending
    sort; a token survives while the mass before it is < top_p), and draw
    with ``random.categorical`` under ``fold_in(PRNGKey(seed),
    position)``."""
    row = _row(logits)
    if params is None or params.greedy:
        return int(torch.argmax(row))
    l = row.to("cpu", torch.float32) / float(params.temperature)
    neg_inf = torch.tensor(-math.inf)
    k = int(params.top_k)
    if 0 < k < l.shape[0]:
        thresh = torch.topk(l, k).values[-1]
        l = torch.where(l >= thresh, l, neg_inf)
    if float(params.top_p) < 1.0:
        order = torch.argsort(-l, stable=True)
        probs = torch.softmax(l[order], dim=0)
        cum = torch.cumsum(probs, dim=0)
        keep_sorted = (cum - probs) < float(params.top_p)
        keep = torch.zeros_like(keep_sorted)
        keep[order] = keep_sorted
        l = torch.where(keep, l, neg_inf)
    key = jrandom.fold_in(jrandom.PRNGKey(int(params.seed)), int(position))
    return int(jrandom.categorical(key, l))
