"""Token→expert routing: top-k gating with capacity buckets.

The PyTorch counterpart of ``learning_at_home_tpu/ops/moe_dispatch.py``,
for the parts pod-mode serving and training need: both token-choice
gating forms (the one-hot ``[n, E, C]`` plan and the compact index plan)
with their dispatch and combine, the slot claims, the top-k by argmax
passes, the load-balance loss, router jitter (whose noise is JAX's
threefry stream bit for bit, ``random.py``) and expert-choice gating
with its dispatch and combine.  The same inputs give the same slots,
weights and losses as the JAX functions of the same names, and autograd
through them gives the JAX gradients.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from learning_at_home_tpu_torch import random as prng


class DispatchPlan(NamedTuple):
    """Static-shape routing decision for one token shard."""

    combine: torch.Tensor  # [n, E, C] float — gate weight at the token's slot
    dispatch: torch.Tensor  # [n, E, C] bool — membership mask
    aux_loss: torch.Tensor  # [] load-balance auxiliary (Shazeer-style)
    dropped_fraction: torch.Tensor  # [] fraction of (token, choice) pairs dropped


class IndexDispatchPlan(NamedTuple):
    """Compact index form of the same routing decision."""

    token_for_slot: torch.Tensor  # [E, C] int32 — source token per slot, -1 empty
    slot_for_token: torch.Tensor  # [n, k] int32 — flat slot e*C+c per choice, -1 dropped
    weights: torch.Tensor  # [n, k] float — renormalized gate weight per choice
    aux_loss: torch.Tensor  # []
    dropped_fraction: torch.Tensor  # []


def compute_capacity(
    n_tokens: int, n_experts: int, k: int, capacity_factor: float = 1.25
) -> int:
    """Slots per expert so that on-balance routing fits with headroom."""
    return max(1, math.ceil(n_tokens * k * capacity_factor / n_experts))


def choose_dispatch_impl(n_tokens: int, n_slots: int) -> str:
    """The JAX package's static choice between the two dispatch forms:
    one-hot when the harmonic mean of tokens and slots is below 4000,
    gather above.  Kept identical so prefill and decode pick the same form
    in both packages (the threshold was measured on a TPU v5e)."""
    harmonic = n_tokens * n_slots / (n_tokens + n_slots)
    return "onehot" if harmonic < 4000 else "gather"


def _one_hot(i: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` gives a zero row."""
    return (i[..., None] == torch.arange(n, device=i.device)).to(dtype)


def _expert_positions(
    top_i: torch.Tensor, num_experts: int, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Slot position of each (token, choice) within its chosen expert:
    claims in token order, counts carried across the k choices.  Tokens
    with ``valid`` False claim no slot and report position 0.  [n, k] int32.
    """
    n, k = top_i.shape
    counts = torch.zeros(num_experts, dtype=torch.int32, device=top_i.device)
    experts = torch.arange(num_experts, device=top_i.device)[:, None]
    cols = []
    for j in range(k):
        # the one-hot transposed, [E, n]: the running count per expert is
        # a scan along the inner dim (a scan along the outer dim of the
        # [n, E] form took 16.5 ms a call at 45,056 tokens on an H100)
        onehot = (top_i[:, j][None, :] == experts).to(torch.int32)
        if valid is not None:
            onehot = onehot * valid.to(torch.int32)[None, :]
        pos_in_expert = (
            torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1 + counts[:, None]
        )
        cols.append((pos_in_expert * onehot).sum(dim=0, dtype=torch.int32))
        counts = counts + onehot.sum(dim=1, dtype=torch.int32)
    return torch.stack(cols, dim=1)


def _load_balance_loss(
    gates: torch.Tensor, top_i: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Shazeer/GShard auxiliary: E * <importance> . <top-1 load>, over the
    real (``valid``) tokens only when a mask is given."""
    num_experts = gates.shape[1]
    load_oh = _one_hot(top_i[:, 0], num_experts, gates.dtype)
    if valid is None:
        importance = gates.mean(dim=0)
        load = load_oh.mean(dim=0)
    else:
        v = valid.to(gates.dtype)[:, None]
        denom = torch.clamp(v.sum(), min=1.0)
        importance = (gates * v).sum(dim=0) / denom
        load = (load_oh * v).sum(dim=0) / denom
    return num_experts * torch.sum(importance * load)


def _small_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis by k argmax passes: descending values,
    ties toward the lower index (``torch.argmax`` returns the first
    maximum; ``torch.topk`` promises no tie order).  As in the JAX
    package, a value equal to ``finfo.min`` collides with the mask."""
    if k > x.shape[-1]:
        raise ValueError(
            f"k={k} > last-dim size {x.shape[-1]} (an argmax over a fully "
            "masked row would silently duplicate)"
        )
    g = x
    ws, is_ = [], []
    for _ in range(k):
        i = torch.argmax(g, dim=-1)
        ws.append(torch.gather(x, -1, i[:, None])[:, 0])
        is_.append(i)
        if len(is_) < k:  # mask the winner out for the next pass
            g = g.masked_fill(
                _one_hot(i, x.shape[-1], torch.bool), torch.finfo(g.dtype).min
            )
    return torch.stack(ws, dim=1), torch.stack(is_, dim=1).to(torch.int32)


# beyond this k a real sort wins over sequential argmax passes
_SMALL_TOPK_MAX_K = 4


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of strictly positive gates; ties toward the lower index for
    every k (a stable descending sort above the argmax-pass range, like
    ``lax.top_k``)."""
    if k <= _SMALL_TOPK_MAX_K:
        return _small_top_k(x, k)
    w, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k].to(torch.int32)


def _topk_weights(gates: torch.Tensor, k: int, renormalize: bool,
                  jitter: float = 0.0, jitter_salt=0):
    """Top-k selection; with ``jitter`` the noisy gates choose the experts
    and the clean gates give the weights, so the fixed noise pattern never
    biases the output mixture."""
    if jitter:
        _, top_i = _top_k(router_jitter(gates, jitter, jitter_salt), k)
        top_w = torch.gather(gates, -1, top_i.long())
    else:
        top_w, top_i = _top_k(gates, k)
    if renormalize:
        top_w = top_w / torch.clamp(
            top_w.sum(dim=-1, keepdim=True), min=torch.finfo(top_w.dtype).tiny
        )
    return top_w, top_i


# the key whose fold with the call site's salt draws the jitter noise
_JITTER_SEED = 0x5EED


@functools.lru_cache(maxsize=16)
def _jitter_noise(jitter: float, salt: int, shape: tuple[int, ...],
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """U(1 - jitter, 1 + jitter) of ``shape``: a pure function of its
    arguments, kept for the next call with the same ones (each layer of a
    train step draws the same noise in its forward and its remat
    recompute, and again every step)."""
    key = prng.fold_in(prng.PRNGKey(_JITTER_SEED, device=device), salt)
    return prng.uniform(key, shape, dtype=dtype, minval=1.0 - jitter,
                        maxval=1.0 + jitter)


def router_jitter(gates: torch.Tensor, jitter: float,
                  salt=0) -> torch.Tensor:
    """Switch-Transformer-style multiplicative routing noise,
    U(1-jitter, 1+jitter) per (row, expert), deterministic: the pattern is
    ``jax.random.uniform`` under ``fold_in(PRNGKey(0x5EED), salt)``, bit
    for bit.  It splits the near-ties of near-identical rows, and the
    backward's recompute reproduces the same routing.  ``salt`` (an int or
    an integer 0-d tensor, e.g. the layer index) decorrelates the pattern
    across call sites."""
    if not jitter:
        return gates
    if isinstance(salt, torch.Tensor):
        salt = int(salt) & 0xFFFFFFFF  # JAX's cast of an int32 to uint32
    noise = _jitter_noise(float(jitter), int(salt), tuple(gates.shape),
                          gates.dtype, gates.device)
    return gates * noise


def _mask_fits(
    fits: torch.Tensor, token_mask: torch.Tensor | None, n: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The padding mask applied to the slot-fit matrix, with the
    dropped-fraction denominator (real routable choices)."""
    if token_mask is None:
        return fits, torch.tensor(float(n * k), device=fits.device)
    return (
        fits & token_mask[:, None],
        torch.clamp(token_mask.sum().float() * k, min=1.0),
    )


def top_k_gating(
    logits: torch.Tensor, k: int, capacity: int, renormalize: bool = True,
    jitter: float = 0.0, jitter_salt=0,
    token_mask: torch.Tensor | None = None,
) -> DispatchPlan:
    """Route each token to its top-k experts, bucketed to static capacity.

    logits [n, E] raw gate scores.  Tokens claim expert slots in token
    order; a choice whose expert is full is dropped (weight zero).
    ``jitter`` > 0 chooses the experts from noisy gates
    (:func:`router_jitter` with ``jitter_salt``).  ``token_mask`` [n]
    bool: False marks padding, which is routed nowhere, claims no capacity
    and is left out of the aux loss and the dropped fraction."""
    n, num_experts = logits.shape
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = _topk_weights(gates, k, renormalize, jitter, jitter_salt)
    pos = _expert_positions(top_i, num_experts, token_mask)
    fits, n_routable = _mask_fits(pos < capacity, token_mask, n, k)

    combine = torch.zeros(
        (n, num_experts, capacity), dtype=gates.dtype, device=gates.device
    )
    dispatch = torch.zeros(
        (n, num_experts, capacity), dtype=torch.bool, device=gates.device
    )
    for j in range(k):
        expert_onehot = _one_hot(top_i[:, j], num_experts, gates.dtype)
        slot_onehot = _one_hot(pos[:, j], capacity, gates.dtype)
        mask = expert_onehot[:, :, None] * slot_onehot[:, None, :]
        mask = mask * fits[:, j][:, None, None].to(gates.dtype)
        combine = combine + top_w[:, j][:, None, None] * mask
        dispatch = dispatch | (mask > 0)

    aux_loss = _load_balance_loss(gates, top_i, token_mask)
    dropped = 1.0 - fits.sum().float() / n_routable
    return DispatchPlan(combine, dispatch, aux_loss, dropped)


def dispatch_tokens(x: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """Tokens into per-expert capacity buckets: [n,d] → [E,C,d]."""
    return torch.einsum("nec,nd->ecd", plan.dispatch.to(x.dtype), x)


def combine_outputs(y: torch.Tensor, plan: DispatchPlan) -> torch.Tensor:
    """Expert outputs back per token, gate-weighted: [E,C,d] → [n,d]."""
    return torch.einsum("nec,ecd->nd", plan.combine.to(y.dtype), y)


def top_k_gating_indices(
    logits: torch.Tensor, k: int, capacity: int, renormalize: bool = True,
    jitter: float = 0.0, jitter_salt=0,
    token_mask: torch.Tensor | None = None,
) -> IndexDispatchPlan:
    """Index-form routing with the semantics of :func:`top_k_gating`,
    without materialising [n, E, C] tensors."""
    n, num_experts = logits.shape
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = _topk_weights(gates, k, renormalize, jitter, jitter_salt)
    pos = _expert_positions(top_i, num_experts, token_mask)
    fits, n_routable = _mask_fits(pos < capacity, token_mask, n, k)

    slot_for_token = torch.where(
        fits, top_i * capacity + pos, -1
    ).to(torch.int32)
    weights = torch.where(fits, top_w, torch.zeros_like(top_w))

    n_slots = num_experts * capacity
    token_ids = torch.arange(
        n, dtype=torch.int32, device=logits.device
    )[:, None].expand(n, k)
    # dropped choices write to one spare slot past the end, then cut off
    # (the JAX form's out-of-range index with mode="drop"); every real
    # slot is claimed by at most one (token, choice)
    target = torch.where(fits, slot_for_token, n_slots).reshape(-1).long()
    token_for_slot = torch.full(
        (n_slots + 1,), -1, dtype=torch.int32, device=logits.device
    )
    token_for_slot.scatter_(0, target, token_ids.reshape(-1))
    token_for_slot = token_for_slot[:n_slots].reshape(num_experts, capacity)

    aux_loss = _load_balance_loss(gates, top_i, token_mask)
    dropped = 1.0 - fits.sum().float() / n_routable
    return IndexDispatchPlan(
        token_for_slot, slot_for_token, weights, aux_loss, dropped
    )


def _gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` for a [rows, d] table.  Every empty slot and
    every dropped choice reads row 0, so one row can be read tens of
    thousands of times; ``F.embedding``'s backward sorts the indices and
    sums such duplicates in parallel segments, where plain indexing's
    backward sums them one after another (measured on an H100 at 45,056
    tokens: ~100 ms a call)."""
    return F.embedding(index.long(), table)


def dispatch_tokens_indexed(
    x: torch.Tensor, plan: IndexDispatchPlan
) -> torch.Tensor:
    """Gather-based dispatch: [n,d] → [E,C,d]; empty slots are zeros."""
    num_experts, capacity = plan.token_for_slot.shape
    flat = plan.token_for_slot.reshape(-1)
    rows = _gather_rows(x, flat.clamp(min=0))
    rows = torch.where((flat >= 0)[:, None], rows, torch.zeros_like(rows))
    return rows.reshape(num_experts, capacity, x.shape[-1])


def combine_outputs_indexed(
    y: torch.Tensor, plan: IndexDispatchPlan
) -> torch.Tensor:
    """Gather-based combine: [E,C,d] → [n,d].  ``plan.weights`` is already
    zero wherever a choice was dropped."""
    e, c, d = y.shape
    picked = _gather_rows(y.reshape(e * c, d), plan.slot_for_token.clamp(min=0))
    return torch.einsum("nk,nkd->nd", plan.weights.to(y.dtype), picked)


# ---- expert-choice routing (Zhou et al. 2022) ----


class ExpertChoicePlan(NamedTuple):
    """Expert-choice routing decision: each EXPERT picks its top-C tokens.
    No slot is ever empty and no choice is dropped by capacity; a token
    that no expert picks passes through the residual unchanged."""

    token_for_slot: torch.Tensor  # [E, C] int32, never -1
    weights: torch.Tensor  # [E, C] float: affinity of expert e for its c-th pick
    uncovered_fraction: torch.Tensor  # [] fraction of tokens picked by no expert


def expert_choice_gating(
    logits: torch.Tensor, capacity: int,
    token_mask: torch.Tensor | None = None,
) -> ExpertChoicePlan:
    """Each expert selects its top-``capacity`` tokens by gate affinity
    (the token's softmax-over-experts mass on it); capacity is clamped to
    the token count.  Ties go to the lower token index, as ``lax.top_k``
    breaks them: a stable descending sort over the tokens, cut after C
    (``torch.topk`` promises no tie order, and masked padding ties in
    bulk).  ``token_mask`` [n] bool: padding sorts behind every real token
    (affinity -1) and, if still picked, carries weight 0.  Selection
    depends on the other tokens of the shard (see the JAX docstring)."""
    n, _ = logits.shape
    capacity = min(capacity, n)
    aff = torch.softmax(logits, dim=-1).T  # [E, n]
    if token_mask is not None:
        aff = torch.where(token_mask[None, :], aff, torch.full_like(aff, -1.0))
    top_w, top_i = torch.sort(aff, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :capacity], top_i[:, :capacity]
    if token_mask is not None:
        top_w = torch.clamp(top_w, min=0.0)  # picked padding: zero weight
    covered = torch.bincount(top_i.reshape(-1), minlength=n) > 0
    if token_mask is None:
        uncovered = 1.0 - covered.sum().float() / n
    else:
        real = torch.clamp(token_mask.sum().float(), min=1.0)
        uncovered = 1.0 - (covered & token_mask).sum().float() / real
    return ExpertChoicePlan(top_i.to(torch.int32), top_w, uncovered)


def dispatch_tokens_expert_choice(
    x: torch.Tensor, plan: ExpertChoicePlan
) -> torch.Tensor:
    """[n, d] → [E, C, d]: every slot is a real token."""
    e, c = plan.token_for_slot.shape
    return _gather_rows(x, plan.token_for_slot.reshape(-1)).reshape(
        e, c, x.shape[-1])


def combine_outputs_expert_choice(
    y: torch.Tensor, plan: ExpertChoicePlan, n_tokens: int
) -> torch.Tensor:
    """[E, C, d] → [n, d]: the affinity-weighted scatter-add over picks.
    A token's picks are summed by the backward of the dispatch's row
    gather (``embedding_dense_backward``): it sorts the slots by token and
    sums each token's segment in a fixed order on the CPU and on CUDA, so
    two runs give the same bits (``index_add_`` and ``index_put_`` add with
    atomics on one device or the other); its own gradient is that gather."""
    e, c, d = y.shape
    w = plan.weights.reshape(-1, 1).to(y.dtype)
    return torch.ops.aten.embedding_dense_backward(
        w * y.reshape(e * c, d), plan.token_for_slot.reshape(-1).long(),
        n_tokens, -1, False)
