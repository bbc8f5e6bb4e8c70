"""ShardedMixtureOfExperts on one device: the pod-mode MoE FFN.

The PyTorch counterpart of ``learning_at_home_tpu/parallel/sharded_moe.py``
at an expert axis of size 1.  There the two ``lax.all_to_all`` exchanges
of ``_local_forward`` are identities and the ``pmean``s of the aux
scalars return their input, so this module is that function without them:

    x [n,d] ── gate ──▶ plan ── dispatch ──▶ [E,C,d]
      ── batched expert FFN ──▶ [E,C,d] ── combine ──▶ y [n,d]

Parameters keep the JAX names and layouts: ``gate [d,E]``, ``w1 [E,d,f]``,
``b1 [E,f]``, ``w2 [E,f,d]``, ``b2 [E,d]``.  The expert FFN is a plain
batched product (``torch.bmm``), as the JAX package leaves it to XLA.
Routing is token-choice top-k (optionally with router jitter) or expert
choice, as in the JAX layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from learning_at_home_tpu_torch import random as jrandom
from learning_at_home_tpu_torch.initializers import lecun_normal, normal
from learning_at_home_tpu_torch.ops.moe_dispatch import (
    choose_dispatch_impl,
    combine_outputs,
    combine_outputs_expert_choice,
    combine_outputs_indexed,
    compute_capacity,
    dispatch_tokens,
    dispatch_tokens_expert_choice,
    dispatch_tokens_indexed,
    expert_choice_gating,
    top_k_gating,
    top_k_gating_indices,
)

Params = dict[str, torch.Tensor]


class ShardedMixtureOfExperts:
    """Top-k MoE FFN whose experts all live on one device."""

    def __init__(
        self,
        hidden_dim: int,
        num_experts: int,
        k: int = 2,
        capacity_factor: float = 1.25,
        ffn_mult: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype = torch.float32,
        dispatch_impl: str = "auto",
        router_jitter: float = 0.0,
        gating: str = "topk",
    ):
        if dispatch_impl not in ("auto", "gather", "onehot"):
            raise ValueError(
                "dispatch_impl must be 'auto', 'gather' or 'onehot', "
                f"got {dispatch_impl!r}"
            )
        if gating not in ("topk", "expert_choice"):
            raise ValueError(
                f"gating must be 'topk' or 'expert_choice', got {gating!r}"
            )
        if gating == "expert_choice" and router_jitter:
            raise ValueError(
                "router_jitter applies only to token-choice top-k gating; "
                "pass router_jitter=0 with expert_choice"
            )
        self.hidden_dim = hidden_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.ffn_dim = ffn_mult * hidden_dim
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.dispatch_impl = dispatch_impl
        self.router_jitter = router_jitter
        self.gating = gating

    def init_params(self, rng: torch.Tensor) -> Params:
        """Random parameters from the key ``rng`` on its device: the JAX
        package's values for the same key (``split(rng, 3)``: gate
        N(0, 1e-2²), lecun-normal experts over ``(e, d, f)``, zero
        biases)."""
        d, e, f = self.hidden_dim, self.num_experts, self.ffn_dim
        pdt, dev = self.param_dtype, rng.device
        kg, k1, k2 = jrandom.split(rng, 3)
        return {
            "gate": normal(kg, (d, e), 1e-2, pdt),
            "w1": lecun_normal(k1, (e, d, f), pdt),
            "b1": torch.zeros((e, f), dtype=pdt, device=dev),
            "w2": lecun_normal(k2, (e, f, d), pdt),
            "b2": torch.zeros((e, d), dtype=pdt, device=dev),
        }

    def __call__(
        self, params: Params, x: torch.Tensor, jitter_salt=0,
        token_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """x [n, d] → (y [n, d], aux).  ``jitter_salt`` (an int or an
        integer 0-d tensor, e.g. the layer index) is folded into the
        router-jitter key so that each call site draws its own noise.
        ``token_mask`` [n] bool: False marks padding, which is routed
        nowhere and gets zero output."""
        capacity = compute_capacity(
            x.shape[0], self.num_experts, self.k, self.capacity_factor
        )
        if self.gating == "expert_choice":
            # each expert picks C of the shard's tokens: C <= n
            capacity = min(capacity, x.shape[0])
        return self._local_forward(params, x, jitter_salt, capacity,
                                   token_mask)

    def _local_forward(
        self, params: Params, x: torch.Tensor, jitter_salt, capacity: int,
        token_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        compute = self.dtype
        impl = self.dispatch_impl
        if impl == "auto":
            impl = choose_dispatch_impl(
                x.shape[0], self.num_experts * capacity
            )

        # gate logits from compute-dtype operands, softmax in f32
        logits = (x.to(compute) @ params["gate"].to(compute)).float()
        if self.gating == "expert_choice":
            plan = expert_choice_gating(logits, capacity, token_mask)
            xe = dispatch_tokens_expert_choice(x.to(compute), plan)
        elif impl == "gather":
            plan = top_k_gating_indices(
                logits, self.k, capacity, jitter=self.router_jitter,
                jitter_salt=jitter_salt, token_mask=token_mask,
            )
            xe = dispatch_tokens_indexed(x.to(compute), plan)
        else:
            plan = top_k_gating(
                logits, self.k, capacity, jitter=self.router_jitter,
                jitter_salt=jitter_salt, token_mask=token_mask,
            )
            xe = dispatch_tokens(x.to(compute), plan)  # [E, C, d]

        w1 = params["w1"].to(compute)
        b1 = params["b1"].to(compute)
        w2 = params["w2"].to(compute)
        b2 = params["b2"].to(compute)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.bmm(xe, w1) + b1[:, None, :], approximate="tanh")
        ye = torch.bmm(h, w2) + b2[:, None, :]

        if self.gating == "expert_choice":
            y = combine_outputs_expert_choice(ye, plan, x.shape[0]).to(x.dtype)
        elif impl == "gather":
            y = combine_outputs_indexed(ye, plan).to(x.dtype)
        else:
            y = combine_outputs(ye, plan).to(x.dtype)

        # router z-loss (ST-MoE) over real tokens
        lse2 = torch.logsumexp(logits, dim=-1) ** 2
        if token_mask is None:
            router_z = lse2.mean()
        else:
            v = token_mask.to(lse2.dtype)
            router_z = (lse2 * v).sum() / torch.clamp(v.sum(), min=1.0)
        if self.gating == "expert_choice":
            # balanced by construction: no balance auxiliary; the dropped
            # fraction reports the tokens no expert picked
            aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
            dropped = plan.uncovered_fraction
        else:
            aux_loss, dropped = plan.aux_loss, plan.dropped_fraction
        aux = {
            "aux_loss": aux_loss,
            "router_z_loss": router_z,
            "dropped_fraction": dropped,
        }
        return y, aux
