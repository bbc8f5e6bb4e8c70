"""ShardedMixtureOfExperts: the pod-mode MoE FFN, on one device or a mesh.

The PyTorch counterpart of ``learning_at_home_tpu/parallel/sharded_moe.py``.
Without a mesh (``mesh=None``) every expert lives on the one device and
the layer is ``_local_forward`` without its collectives:

    x [n,d] ── gate ──▶ plan ── dispatch ──▶ [E,C,d]
      ── batched expert FFN ──▶ [E,C,d] ── combine ──▶ y [n,d]

On a mesh (``parallel/mesh.py``) each rank is one ``shard_map`` shard: it
routes ITS tokens (capacity from the local token count), and two
all-to-alls over the ``expert`` axis carry them to the ranks that hold
their experts and back (E global experts, e = E/ep local ones, C the
capacity):

    [E,C,d] ─ reshape [ep,e,C,d] ─ all_to_all ─▶ [ep,e,C,d] ─ regroup
      [e,ep*C,d] ─ expert FFN ─▶ [e,ep*C,d] ─ regroup [ep,e,C,d]
      ─ all_to_all ─▶ [E,C,d] ─ combine ─▶ y [n,d]

A ``model`` axis splits each expert's FFN dim (w1 by columns, w2 by
rows): the second product's partial sums meet in a ``psum`` over
``model`` before ``b2`` is added, Megatron's conjugate pair (``comm.py``)
making the first product's input cotangent whole again.  The aux scalars
are ``pmean``'d over the data axes.  Router jitter draws the LOCAL
``[n_local, E]`` shape, as the JAX layer's does inside ``shard_map``.

Parameters keep the JAX names and layouts: ``gate [d,E]``, ``w1 [E,d,f]``,
``b1 [E,f]``, ``w2 [E,f,d]``, ``b2 [E,d]``; on a mesh a rank holds its
slices under :meth:`ShardedMixtureOfExperts.param_specs`.  The expert FFN
is a plain batched product (``torch.bmm``), as the JAX package leaves it
to XLA.
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
from learning_at_home_tpu_torch.parallel import comm
from learning_at_home_tpu_torch.parallel.mesh import P, data_axes, local_shard

Params = dict[str, torch.Tensor]


def expert_param_specs(tp: int = 1) -> dict[str, P]:
    """Each MoE param's spec: the expert stacks split over ``expert``;
    with a ``model`` axis of ``tp`` > 1 ranks, w1 by columns and w2 by
    rows (b1 with w1); the gate whole."""
    if tp > 1:
        specs = {"w1": P("expert", None, "model"),  # column split
                 "b1": P("expert", "model"),
                 "w2": P("expert", "model", None),  # row split
                 "b2": P("expert")}
    else:
        specs = {name: P("expert") for name in ("w1", "b1", "w2", "b2")}
    specs["gate"] = P()
    return specs


class ShardedMixtureOfExperts:
    """Top-k MoE FFN; experts on one device, or sharded over a mesh's
    ``expert`` axis (and their FFN dim over ``model``)."""

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
        mesh=None,
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
        self.mesh = mesh
        self.ep = 1 if mesh is None else mesh.size("expert")
        self.tp = 1 if mesh is None else mesh.size("model")
        if mesh is not None and "expert" not in mesh.axis_names:
            raise ValueError("mesh must have an 'expert' axis")
        if num_experts % self.ep:
            raise ValueError(
                f"num_experts={num_experts} must divide over expert axis "
                f"size {self.ep}"
            )
        if (ffn_mult * hidden_dim) % self.tp:
            raise ValueError(
                f"ffn_dim={ffn_mult * hidden_dim} must divide over model "
                f"axis size {self.tp}"
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

    def init_params(self, rng: torch.Tensor, shard: bool = True) -> Params:
        """Random parameters from the key ``rng`` on its device: the JAX
        package's values for the same key (``split(rng, 3)``: gate
        N(0, 1e-2²), lecun-normal experts over ``(e, d, f)``, zero
        biases).  On a mesh the global leaves are drawn and each rank keeps
        its slices (``shard=False`` keeps the global tree, for callers that
        stack layers and slice the stack), so a slice equals the
        single-device draw's bit for bit."""
        d, e, f = self.hidden_dim, self.num_experts, self.ffn_dim
        pdt, dev = self.param_dtype, rng.device
        kg, k1, k2 = jrandom.split(rng, 3)
        params = {
            "gate": normal(kg, (d, e), 1e-2, pdt),
            "w1": lecun_normal(k1, (e, d, f), pdt),
            "b1": torch.zeros((e, f), dtype=pdt, device=dev),
            "w2": lecun_normal(k2, (e, f, d), pdt),
            "b2": torch.zeros((e, d), dtype=pdt, device=dev),
        }
        if self.mesh is None or not shard:
            return params
        specs = self.param_specs()
        return {name: local_shard(p, specs[name], self.mesh).clone()
                for name, p in params.items()}

    def param_specs(self, stacked: bool = False) -> dict[str, P]:
        """The spec of each param (:func:`expert_param_specs`);
        ``stacked=True`` prepends a ``None`` dim for a stack of layers."""
        specs = expert_param_specs(self.tp)
        if stacked:
            specs = {name: P(None, *spec) for name, spec in specs.items()}
        return specs

    def __call__(
        self, params: Params, x: torch.Tensor, jitter_salt=0,
        token_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """x [n, d] → (y [n, d], aux).  ``jitter_salt`` (an int or an
        integer 0-d tensor, e.g. the layer index) is folded into the
        router-jitter key so that each call site draws its own noise.
        ``token_mask`` [n] bool: False marks padding, which is routed
        nowhere and gets zero output.  On a mesh ``x`` is this rank's
        tokens, and the capacity follows their count."""
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

        mesh, ep, d = self.mesh, self.ep, self.hidden_dim
        e_local = self.num_experts // ep
        if ep > 1:
            # slice j of the exchange = the tokens of expert-axis peer j
            x_recv = comm.all_to_all(
                xe.reshape(ep, e_local, capacity, d), mesh, "expert")
            xe = x_recv.transpose(0, 1).reshape(e_local, ep * capacity, d)
        if self.tp > 1:
            # the column split's input: its cotangent sums over 'model'
            xe = comm.psum_grad(xe, mesh, "model")
        w1 = params["w1"].to(compute)
        b1 = params["b1"].to(compute)
        w2 = params["w2"].to(compute)
        b2 = params["b2"].to(compute)
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.bmm(xe, w1) + b1[:, None, :], approximate="tanh")
        ye = torch.bmm(h, w2)
        if self.tp > 1:
            ye = comm.psum(ye, mesh, "model")
        ye = ye + b2[:, None, :]
        if ep > 1:
            y_send = ye.reshape(e_local, ep, capacity, d).transpose(0, 1)
            ye = comm.all_to_all(y_send.contiguous(), mesh, "expert").reshape(
                self.num_experts, capacity, d)

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
        if mesh is not None:
            axes = data_axes(mesh)
            aux = {key: comm.pmean(val, mesh, axes)
                   for key, val in aux.items()}
        return y, aux
