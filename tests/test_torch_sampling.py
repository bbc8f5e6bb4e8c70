"""The port's sampler (``models/sampling.py``) against the JAX package's:
``SamplingParams`` validation with the same messages, and
``sample_token`` token for token over seeded logits with deliberate ties,
across seeds, positions, temperatures, top-k and top-p.  The tolerance:
none (the token ids must be equal)."""

from __future__ import annotations

import itertools
import math

import numpy as np
import pytest
import torch

from learning_at_home_tpu.models.sampling import (
    SamplingParams as JaxParams,
    sample_token as jax_sample_token,
)
from learning_at_home_tpu_torch.models.sampling import (
    SamplingParams,
    sample_token,
)

VOCAB = 258


def _logits(seed: int) -> np.ndarray:
    """Seeded f32 logits with ties: a quarter of the entries repeat a few
    shared values (top-k and the nucleus edge see equal logits)."""
    rs = np.random.RandomState(seed)
    l = (rs.randn(VOCAB) * 2.0).astype(np.float32)
    shared = (rs.randn(4) * 2.0 + 1.0).astype(np.float32)
    tied = rs.choice(VOCAB, VOCAB // 4, replace=False)
    l[tied] = shared[rs.randint(0, 4, tied.size)]
    l[rs.randint(0, VOCAB)] = l.max()  # a tie at the argmax too
    return l


BAD = [dict(seed=-1), dict(seed=2 ** 63), dict(temperature=-0.5),
       dict(temperature=math.inf), dict(temperature=math.nan),
       dict(top_p=0.0), dict(top_p=1.5), dict(top_p=math.nan),
       dict(top_k=-3)]


@pytest.mark.parametrize("kw", BAD, ids=[str(k) for k in BAD])
def test_validation_messages_equal_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxParams(**kw)
    with pytest.raises(ValueError) as got:
        SamplingParams(**kw)
    assert str(got.value) == str(want.value)


def test_fields_meta_and_greedy_equal_jax():
    for kw in (dict(), dict(seed=7, temperature=0.8, top_p=0.9, top_k=40)):
        j, t = JaxParams(**kw), SamplingParams(**kw)
        assert t.to_meta() == j.to_meta() and t.greedy == j.greedy


CASES = list(itertools.product(
    (0, 1, 12345, 2 ** 40 + 3),           # seeds (above 2^32: low word)
    (1, 17, 255),                          # positions
    (0.0, 0.7, 1.0, 1.6),                  # temperatures (0: argmax)
    (0, 1, 5, 40),                         # top-k (0: off)
    (1.0, 0.9, 0.5),                       # top-p (1: off)
))


@pytest.mark.parametrize("chunk", range(4))
def test_sample_token_equals_jax(chunk):
    """432 (seed, position, temperature, top-k, top-p) cases, each on
    its own logits; numpy and torch inputs give the same token."""
    for n, (seed, pos, temp, top_k, top_p) in enumerate(CASES[chunk::4]):
        logits = _logits(n * 4 + chunk)
        kw = dict(seed=seed, temperature=temp, top_p=top_p, top_k=top_k)
        want = jax_sample_token(logits, JaxParams(**kw), pos)
        params = SamplingParams(**kw)
        got = sample_token(torch.from_numpy(logits), params, pos)
        assert got == want, (kw, pos)
        assert sample_token(logits, params, pos) == want


def test_greedy_is_the_first_maximum():
    l = np.zeros(VOCAB, np.float32)
    l[[9, 3, 200]] = 5.0
    assert sample_token(l, None, 0) == jax_sample_token(l, None, 0) == 3
    assert sample_token(torch.from_numpy(l), SamplingParams(), 4) == 3
