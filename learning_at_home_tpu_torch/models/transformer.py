"""DMoE-Transformer language model in pod mode: forward, serving, training.

The PyTorch counterpart of ``learning_at_home_tpu/models/transformer.py``:
a causal Transformer LM whose FFNs are mixtures of experts
(``parallel/sharded_moe.py``), with the full re-forward decoder and the
KV-cache decoder of ``generate``, the loss (the chunked cross-entropy, or
the fused one of ``ops/fused_ce.py`` with its Hopper kernels), per-layer
remat and the train step with gradient accumulation.  It runs on one
device (``mesh=None``) or as one rank of a mesh (``parallel/mesh.py``).

On a mesh each rank computes what its JAX ``shard_map`` shard computes.
Experts are split over ``expert`` (their FFN dim over ``model``); a rank
holds its rows of the batch (:meth:`DMoETransformerLM.local_batch`: rows
split over the data axes ``data`` and ``expert``, and with
``seq_parallel`` its chunk of the sequence, in the zigzag order by
default, attention running as a ring over ``seq``; the MoE gathers the
row's chunks over ``seq`` as XLA's reshard does).  ``loss_fn`` returns the
global loss; its gradient on a rank is that rank's share, and
``value_and_grad`` sums the shares of each leaf over the token axes that
do not split it: replicated leaves over ``data``, ``expert`` and ``seq``,
expert leaves over ``data`` and ``seq`` (the all-to-all's backward brings
each expert its peers' cotangents), never over ``model``.  ``generate``
takes the whole prompt on every rank and returns the whole output there:
the trunk runs on every row alike and the MoE on the rank's share of the
tokens (``replicated=True`` of ``apply``).

Parameters are an explicit tree of tensors with the JAX package's names,
shapes and layouts (stacked layers with a leading ``n_layers`` dim, or a
tuple of per-layer trees), so converted checkpoints (``convert.py``)
compare leaf by leaf.  Each layer passes its index to the MoE as the
router-jitter salt.  Remat ``"full"`` keeps only each layer's input;
``"dots"`` also keeps the outputs of the layer's products without batch
dims (the projections and the gate), as JAX's
``dots_with_no_batch_dims_saveable``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from learning_at_home_tpu_torch import random as prng
from learning_at_home_tpu_torch.device import resolve_device
from learning_at_home_tpu_torch.initializers import lecun_normal, normal
from learning_at_home_tpu_torch.models.trunk import (
    attention_core,
    causal_attention,
    layer_norm,
    one_query_attention,
    output_projection,
    qkv_projections,
)
from learning_at_home_tpu_torch.ops.flash_attention import HEAD_DIM
from learning_at_home_tpu_torch.ops.fused_ce import _check, fused_softmax_ce
from learning_at_home_tpu_torch.optim import apply_updates
from learning_at_home_tpu_torch.parallel import comm
from learning_at_home_tpu_torch.parallel.mesh import (
    P,
    data_axes,
    local_shard,
    spec_axes,
    token_axes,
)
from learning_at_home_tpu_torch.parallel.ring_attention import (
    local_ring_fn,
    make_ring_attention,
    zigzag_indices,
)
from learning_at_home_tpu_torch.parallel.sharded_moe import (
    ShardedMixtureOfExperts,
)
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten
from learning_at_home_tpu_torch.utils.profiling import UNMARKED, BackwardRanges

Params = Any

# the prefix of the profiler ranges the model opens: the embedding, each
# layer's attention and MoE, the loss, the backward and the optimizer
# update; under a profiler each block's backward has its own range too
# (``<block>/backward``, utils/profiling.py ``BackwardRanges``)
PROFILE_RANGE = "dmoe/"
# the products without batch dims: under remat "dots" their outputs are
# saved and everything else in the layer is recomputed (batched products,
# elementwise ops, routing, the custom kernels)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@dataclasses.dataclass(frozen=True)
class DMoETransformerConfig:
    """The JAX config's fields and defaults.  ``scan_layers`` only selects
    the stacked layout's validation here: the port always loops over
    layers."""

    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    seq_len: int = 256
    num_experts: int = 256
    k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2
    router_z_weight: float = 1e-3
    router_jitter: float = 0.0
    gating: str = "topk"
    # 'xla' = plain attention (scores materialised); 'flash' = the Hopper
    # kernels; 'auto' = flash on a CUDA device wherever they take the
    # inputs (bf16 compute, head dim 64), at any seq_len, else xla (the
    # JAX rule's seq_len >= 8192 was the TPU's crossover, not the card's)
    attn_impl: str = "auto"
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    remat_policy: str = "full"
    scan_layers: bool = True
    stack_layers: bool = True
    tie_embeddings: bool = True
    seq_parallel: bool = False
    seq_layout: str = "zigzag"
    ce_chunk: int = 1024
    ce_impl: str = "chunked"
    ce_block_n: int = 128
    ce_block_v: int = 1024


def _layer_slice(tree, i: int):
    """Layer ``i`` of a stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {key: _layer_slice(val, i) for key, val in tree.items()}
    return tree[i]


class DMoETransformerLM:
    """Functional model: explicit param tree, ``apply`` and ``generate``.

    ``device`` is where parameters are made and the model runs; None means
    the CUDA card (see :func:`~learning_at_home_tpu_torch.device.resolve_device`),
    on a mesh the rank's device (``mesh.device``).  ``mesh`` (a
    ``parallel.mesh.Mesh`` with an ``expert`` axis) runs the model as one
    rank of it; None keeps the single-device model.
    """

    def __init__(self, config: DMoETransformerConfig, device=None,
                 mesh=None):
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        if config.attn_impl == "auto":
            # the Hopper kernels wherever they take the inputs, with no
            # length threshold: on an H100 their forward and backward beat
            # the plain path's at every length the port runs (10.9 against
            # 78.0 ms at [2832, 256, 8, 64], 4.1 against 67.8 at [177,
            # 1024, 8, 64], 3.2 against 100.5 at [4, 8192, 8, 64])
            flash = (self.device.type == "cuda"
                     and config.dtype == torch.bfloat16
                     and config.d_model // config.n_heads == HEAD_DIM)
            config = dataclasses.replace(
                config, attn_impl="flash" if flash else "xla")
        if config.scan_layers and not config.stack_layers:
            raise ValueError(
                "scan_layers=True requires stack_layers=True (the JAX scan "
                "consumes the stacked param tree)"
            )
        if config.remat and config.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got "
                f"{config.remat_policy!r}"
            )
        self.cfg = config
        self._decode_model: "DMoETransformerLM | None" = None
        self._backward_ranges = BackwardRanges()
        self.moe = ShardedMixtureOfExperts(
            hidden_dim=config.d_model,
            num_experts=config.num_experts,
            k=config.k,
            capacity_factor=config.capacity_factor,
            dtype=config.dtype,
            param_dtype=config.param_dtype,
            router_jitter=config.router_jitter,
            gating=config.gating,
            mesh=mesh,
        )
        self._ring_local = self._ring_global = None
        self._zig = self._zig_inv = None
        self._layout = None  # global positions in the sequence's layout order
        n_seq = 1 if mesh is None else mesh.size("seq")
        if config.seq_parallel:
            if mesh is None or "seq" not in mesh.axis_names:
                raise ValueError("seq_parallel=True requires a 'seq' mesh axis")
            layout = config.seq_layout
            if layout == "zigzag" and config.seq_len % (2 * n_seq):
                logging.getLogger(__name__).warning(
                    "seq_len %d not divisible by 2*%d -- falling back to the "
                    "contiguous ring layout (zigzag needs paired chunks)",
                    config.seq_len, n_seq,
                )
                layout = "contiguous"
            if layout == "zigzag":
                # the residual stream is permuted once at the model
                # boundary; the ring consumes the zigzag order directly
                self._zig = zigzag_indices(config.seq_len, n_seq)
                self._zig_inv = np.argsort(self._zig)
                self._layout = self._zig
            else:
                self._layout = np.arange(config.seq_len)
            self._ring_local = local_ring_fn(mesh, causal=True, layout=layout)
            self._ring_global = make_ring_attention(
                mesh, causal=True, layout=layout,
                pre_permuted=self._zig is not None)
        elif n_seq > 1:
            raise ValueError("a 'seq' mesh axis needs seq_parallel=True")

    # ---- the mesh layout ----

    def local_positions(self) -> np.ndarray | None:
        """The global positions of this rank's sequence columns, in its
        layout order; None when each rank holds whole rows."""
        if self._layout is None:
            return None
        n, i = self.mesh.size("seq"), self.mesh.index("seq")
        c = self.cfg.seq_len // n
        return self._layout[i * c: (i + 1) * c]

    def local_batch(self, batch):
        """This rank's part of a global [B, S] batch (ids, targets, a
        mask; a tensor or an array): its rows over the data axes and, with
        ``seq_parallel``, its columns in the layout order.  The identity
        without a mesh."""
        if self.mesh is None:
            return batch
        axes = data_axes(self.mesh)
        n, i = self.mesh.size(axes), self.mesh.index(axes)
        if batch.shape[0] % n:
            raise ValueError(f"batch of {batch.shape[0]} rows must divide "
                             f"across the mesh's {n} batch shards")
        rows = batch.shape[0] // n
        out = batch[i * rows: (i + 1) * rows]
        cols = self.local_positions()
        if cols is not None:
            if batch.shape[1] != self.cfg.seq_len:
                raise ValueError(f"the sequence layout was built for seq_len "
                                 f"{self.cfg.seq_len}, got {batch.shape[1]}")
            out = out[:, torch.as_tensor(cols) if torch.is_tensor(out)
                      else cols]
        return out

    def param_specs(self, params: Params) -> Params:
        """A tree like ``params`` of each leaf's spec: the expert stacks'
        (a leading None for the stacked layer dim), every other leaf
        replicated."""
        moe = self.moe.param_specs(stacked=self.cfg.stack_layers)

        def assign(tree, in_moe=False):
            if isinstance(tree, dict):
                return {key: moe[key] if in_moe else assign(val, key == "moe")
                        for key, val in tree.items()}
            if isinstance(tree, (tuple, list)):  # the tuple layout
                return type(tree)(assign(val) for val in tree)
            return P()

        return assign(params)

    # ---- parameters ----

    def init_params(self, rng: torch.Tensor) -> Params:
        """Random parameters from the key ``rng`` (``random.PRNGKey``),
        drawn on the model's device: the JAX package's values for the same
        key (lecun-normal dense weights, N(0, 1/d) embeddings; the keys
        split in its order, five a layer).  The stacked layout draws each
        layer from its key and stacks, as ``jax.vmap`` over the layer keys
        does."""
        cfg = self.cfg
        d, v, s, n_layers = cfg.d_model, cfg.vocab_size, cfg.seq_len, cfg.n_layers
        pdt, dev = cfg.param_dtype, self.device
        rng = rng.to(dev)
        k_embed, k_pos, k_head, k_layers = prng.split(rng, 4)

        def ln():
            return {"scale": torch.ones(d, dtype=pdt, device=dev),
                    "bias": torch.zeros(d, dtype=pdt, device=dev)}

        def init_layer(key):
            ks = prng.split(key, 5)
            return {
                "ln1": ln(),
                "wq": lecun_normal(ks[0], (d, d), pdt),
                "wk": lecun_normal(ks[1], (d, d), pdt),
                "wv": lecun_normal(ks[2], (d, d), pdt),
                "wo": lecun_normal(ks[3], (d, d), pdt),
                "ln2": ln(),
                "moe": self.moe.init_params(ks[4], shard=False),
            }

        layers = tuple(init_layer(k) for k in prng.split(k_layers, n_layers))
        params: dict = {
            "embed": normal(k_embed, (v, d), d ** -0.5, pdt),
            "pos": normal(k_pos, (s, d), d ** -0.5, pdt),
            "ln_f": ln(),
            "layers": (
                tree_map(lambda *leaves: torch.stack(leaves), *layers)
                if cfg.stack_layers else layers
            ),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = lecun_normal(k_head, (d, v), pdt)
        if self.mesh is not None:
            # each rank keeps its slices of the global draw
            params = tree_map(
                lambda p, spec: local_shard(p, spec, self.mesh).clone()
                if spec_axes(spec) else p,
                params, self.param_specs(params))
        return params

    # ---- forward ----

    def _layer_params(self, params: Params, i: int):
        """Layer i's param tree under either layout (stacked / tuple)."""
        if self.cfg.stack_layers:
            return _layer_slice(params["layers"], i)
        return params["layers"][i]

    def _attention(self, lp, h, replicated: bool = False) -> torch.Tensor:
        """Causal self-attention of the normed [B,S,d] ``h``: the dense
        core, or on a ``seq`` axis the ring between the same projections
        (the JAX ``_ring_attention``)."""
        if self._ring_local is None:
            return causal_attention(lp, h, self.cfg.n_heads,
                                    impl=self.cfg.attn_impl)
        q, k, v = qkv_projections(lp, h, self.cfg.n_heads)
        ring = self._ring_global if replicated else self._ring_local
        return output_projection(lp, ring(q, k, v))

    def _moe(self, p, h, layer_idx, token_mask=None,
             replicated: bool = False):
        """The MoE FFN of the normed [B,S,d] ``h``: (output, aux).  On a
        mesh the layer routes the tokens this rank's shard holds: its own
        rows (the rows of its whole sequence with ``seq_parallel``), or
        with ``replicated`` its share of the flattened tokens every rank
        holds."""
        b, s, d = h.shape
        mask = None if token_mask is None else token_mask.reshape(b * s)
        mesh = self.mesh
        if mesh is not None and replicated:
            axes = data_axes(mesh)
            n = mesh.size(axes)
            if (b * s) % n:
                raise ValueError(f"token count {b * s} must divide across "
                                 f"{n} shards")
            flat = comm.shard_replicated(h.reshape(b * s, d), mesh, axes, 0)
            if mask is not None:
                mask = mask.reshape(n, -1)[mesh.index(axes)]
            y, aux = self.moe(p, flat, jitter_salt=layer_idx, token_mask=mask)
            return comm.gather_replicated(y, mesh, axes, 0).reshape(
                b, s, d), aux
        if self._ring_local is not None:
            # the MoE routes whole rows: gather the row's chunks over seq
            whole = comm.all_gather(h, mesh, "seq", dim=1)
            if token_mask is not None:
                mask = comm.all_gather(token_mask.to(torch.uint8), mesh,
                                       "seq", dim=1).reshape(-1).bool()
            y, aux = self.moe(p, whole.reshape(-1, d), jitter_salt=layer_idx,
                              token_mask=mask)
            i = mesh.index("seq")
            return y.reshape(b, -1, d)[:, i * s: (i + 1) * s], aux
        # the layer index salts the router jitter: each layer draws its
        # own noise, and remat's recompute draws the forward's
        y, aux = self.moe(p, h.reshape(b * s, d), jitter_salt=layer_idx,
                          token_mask=mask)
        return y.reshape(b, s, d), aux

    def _layer(self, lp, x, layer_idx, token_mask=None, replicated=False,
               marks=UNMARKED):
        # profiler ranges (PROFILE_RANGE): profile_training.py and the
        # benchmark attribute device time to them; ``marks`` brackets each
        # block for its backward's range, outside the forward's range
        attention = f"{PROFILE_RANGE}layer{layer_idx}/attention"
        moe = f"{PROFILE_RANGE}layer{layer_idx}/moe"
        x = marks.block_input(x, attention)
        with record_function(attention):
            x = x + self._attention(lp, layer_norm(lp["ln1"], x), replicated)
        x = marks.block_input(marks.block_output(x, attention), moe)
        with record_function(moe):
            moe_out, aux = self._moe(lp["moe"], layer_norm(lp["ln2"], x),
                                     layer_idx, token_mask, replicated)
        return marks.block_output(x + moe_out, moe), aux

    def _embed(self, params: Params, token_ids: torch.Tensor,
               start: int = 0, positions=None) -> torch.Tensor:
        """Token plus position embeddings of [B, S] ids at positions
        ``start ..`` (or at the global ``positions`` of a rank's sequence
        chunk), in the compute dtype."""
        dt = self.cfg.dtype
        s = token_ids.shape[1]
        # F.embedding: its backward sums repeated tokens in parallel
        x = F.embedding(token_ids.long(), params["embed"]).to(dt)
        if positions is not None:
            return x + params["pos"][torch.as_tensor(
                positions, device=token_ids.device)][None].to(dt)
        return x + params["pos"][None, start: start + s].to(dt)

    def _hidden(
        self, params: Params, token_ids: torch.Tensor,
        token_mask: torch.Tensor | None = None, replicated: bool = False,
        marks=UNMARKED,
    ) -> tuple[torch.Tensor, dict]:
        """token_ids [B, S] → final-LN hidden states [B, S, d]; aux scalars
        averaged over layers.  ``token_mask`` [B, S] bool: False marks
        padding that must not take part in MoE routing.  On a mesh see
        :meth:`apply` for what ``token_ids`` holds.  ``marks`` brackets
        the embedding and each layer's blocks for the backward's ranges."""
        zig = self._zig is not None and replicated
        embed = f"{PROFILE_RANGE}embed"
        # both tables marked before either is used: the closing node runs
        # after every node the embedding made
        tables = {**params, **{key: marks.block_input(params[key], embed)
                               for key in ("embed", "pos")}}
        with record_function(embed):
            if self._layout is not None and not replicated:
                want = len(self.local_positions())
                if token_ids.shape[1] != want:
                    raise ValueError(
                        f"the sequence layout was built for seq_len "
                        f"{self.cfg.seq_len} ({want} columns a rank), got "
                        f"{token_ids.shape[1]} columns")
                x = self._embed(tables, token_ids,
                                positions=self.local_positions())
            else:
                x = self._embed(tables, token_ids)
        x = marks.block_output(x, embed)
        if zig:
            if token_ids.shape[1] != len(self._zig):
                raise ValueError(
                    f"zigzag layout was built for seq_len {len(self._zig)}, "
                    f"got {token_ids.shape[1]} -- the pre-permuted ring would "
                    "silently misattend on other lengths")
            # the zigzag layout for the whole layer stack: attention takes
            # it as it is, the MoE and norms are per token
            x = x[:, self._zig]
            if token_mask is not None:
                token_mask = token_mask[:, self._zig]
        aux_total = None
        for i in range(self.cfg.n_layers):
            lp = self._layer_params(params, i)
            if self.cfg.remat:
                # "full": keep only the layer's input; the backward
                # recomputes everything inside it.  "dots": keep the
                # outputs of the products without batch dims too
                extra = {} if self.cfg.remat_policy == "full" else dict(
                    context_fn=functools.partial(
                        create_selective_checkpoint_contexts, _save_dots))
                x, aux = checkpoint(self._layer, lp, x, i, token_mask,
                                    replicated, marks, use_reentrant=False,
                                    **extra)
            else:
                x, aux = self._layer(lp, x, i, token_mask, replicated, marks)
            aux_total = aux if aux_total is None else {
                key: aux_total[key] + aux[key] for key in aux_total
            }
        if zig:
            x = x[:, self._zig_inv]
        x = layer_norm(params["ln_f"], x)
        return x, {key: val / self.cfg.n_layers for key, val in aux_total.items()}

    def _head(self, params: Params) -> torch.Tensor:
        return (
            params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        ).to(self.cfg.dtype)

    @staticmethod
    def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """f32 logits of compute-dtype operands: the operands are multiplied
        in f32 (products of bf16 values are exact there), so the result is
        a bf16 product with f32 accumulation and f32 output, as in the JAX
        package.  A bf16 matmul would round the logits to bf16."""
        return x.float() @ head.float()

    def apply(
        self, params: Params, token_ids: torch.Tensor,
        token_mask: torch.Tensor | None = None, replicated: bool = False,
    ) -> tuple[torch.Tensor, dict]:
        """token_ids [B, S] → logits [B, S, V] (f32); aux dict of scalars.

        On a mesh ``token_ids`` is this rank's part of the batch
        (:meth:`local_batch`) and so are the logits; with ``replicated``
        every rank passes the whole batch and gets the whole logits (the
        trunk runs on every row alike, the MoE on the rank's share of the
        flattened tokens, any row count whose tokens divide over the data
        shards), as ``generate`` uses it."""
        x, aux_mean = self._hidden(params, token_ids, token_mask, replicated)
        return self._logits(x, self._head(params)), aux_mean

    # ---- loss / train step ----

    def _fused_ce_or_none(self, head, flat_x, flat_t, n):
        """This rank's share of the mean CE through the fused kernels
        (``ops/fused_ce.py``) when ``ce_impl="fused"`` and their
        preconditions hold on the local shapes, else None and the caller
        runs the chunked CE (never a full [n, V] logits buffer).  ``n`` is
        the global token count.  On a mesh each rank runs the kernels on
        its own rows, as the JAX ``shard_map`` branch does; under a
        ``seq`` axis the chunked CE runs (the JAX fallback)."""
        if self.cfg.ce_impl != "fused":
            return None
        if self._layout is not None:
            return None
        bn, bv = self.cfg.ce_block_n, self.cfg.ce_block_v
        if _check(flat_x, head, flat_t, bn, bv) is not None:
            return None
        return fused_softmax_ce(flat_x, head, flat_t, bn, bv).sum() / n

    def _chunk_ce_sum(self, xc, head, tc):
        """Summed softmax CE of one token chunk against its targets."""
        logits = self._logits(xc, head)
        picked = torch.gather(logits, 1, tc.long()[:, None])[:, 0]
        return (torch.logsumexp(logits, dim=-1) - picked).sum()

    def loss_fn(self, params: Params, token_ids: torch.Tensor,
                targets: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Mean next-token CE plus the weighted router losses; metrics
        ``ce``, ``aux_loss``, ``router_z_loss``, ``dropped_fraction``.

        The chunked CE runs the head and softmax-CE over ``ce_chunk``
        tokens at a time, each under ``torch.utils.checkpoint``, so at most
        one [chunk, V] f32 logits buffer is live and the backward
        recomputes each chunk's logits; a sub-chunk remainder is one more
        checkpointed chunk.  ``ce_impl="fused"`` keeps logits out of
        memory altogether when the kernels' preconditions hold."""
        marks = self._backward_ranges.marks()
        x, aux = self._hidden(params, token_ids, marks=marks)
        n_ranks = 1 if self.mesh is None else self.mesh.size(
            token_axes(self.mesh))
        loss_range = f"{PROFILE_RANGE}loss"
        x = marks.block_input(x, loss_range)
        with record_function(loss_range):
            head = self._head(params)
            n_local = x.shape[0] * x.shape[1]
            n = n_local * n_ranks  # the global token count
            flat_x = x.reshape(n_local, x.shape[-1])
            flat_t = targets.reshape(n_local)

            ce = self._fused_ce_or_none(head, flat_x, flat_t, n)
            if ce is None:
                chunk = min(self.cfg.ce_chunk, n_local)
                ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
                for start in range(0, n_local, chunk):
                    ce_sum = ce_sum + checkpoint(
                        self._chunk_ce_sum, flat_x[start: start + chunk],
                        head, flat_t[start: start + chunk],
                        use_reentrant=False,
                    )
                ce = ce_sum / n
        ce = marks.block_output(ce, loss_range)
        if n_ranks == 1:
            loss = (
                ce
                + self.cfg.aux_loss_weight * aux["aux_loss"]
                + self.cfg.router_z_weight * aux["router_z_loss"]
            )
            return loss, {"ce": ce, **aux}
        # each token rank adds its CE share and 1/n_ranks of the (global)
        # router losses; the psum's value is the global loss and its
        # backward leaves each rank its own share's gradient
        axes = token_axes(self.mesh)
        share = (
            ce
            + self.cfg.aux_loss_weight * aux["aux_loss"] / n_ranks
            + self.cfg.router_z_weight * aux["router_z_loss"] / n_ranks
        )
        loss = comm.psum(share, self.mesh, axes)
        return loss, {"ce": comm.psum(ce.detach(), self.mesh, axes), **aux}

    def reduce_grads(self, grads: Params, params: Params) -> Params:
        """Each rank's gradient shares summed in place over the token axes
        that do not split the leaf (module docstring); returns ``grads``.
        One collective per set of axes and dtype."""
        if self.mesh is None or self.mesh.world_size == 1:
            return grads
        by_axes: dict = {}
        for g, spec in zip(tree_leaves(grads),
                           tree_leaves(self.param_specs(params))):
            axes = tuple(a for a in token_axes(self.mesh)
                         if a not in spec_axes(spec))
            by_axes.setdefault(axes, []).append(g)
        for axes, leaves in by_axes.items():
            comm.all_reduce_tensors_(leaves, self.mesh, axes)
        return grads

    def value_and_grad(self, params: Params, token_ids: torch.Tensor,
                       targets: torch.Tensor, reduce: bool = True):
        """``((loss, metrics), grads)`` of :meth:`loss_fn`, with ``grads`` a
        tree shaped like ``params`` (zeros for an unused leaf), as
        ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them.  The
        parameters themselves are not marked as requiring gradients.  On a
        mesh the rank's gradient shares are summed over the mesh
        (:meth:`reduce_grads`) unless ``reduce=False``."""
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, metrics = self.loss_fn(live, token_ids, targets)
            with record_function(f"{PROFILE_RANGE}backward"):
                # what an aborted backward left open ends here
                self._backward_ranges.close_all()
                grads = torch.autograd.grad(
                    loss, tree_leaves(live), allow_unused=True,
                    materialize_grads=True,
                )
        metrics = {key: val.detach() for key, val in metrics.items()}
        grads = tree_unflatten(params, grads)
        if reduce:
            self.reduce_grads(grads, params)
        return (loss.detach(), metrics), grads

    def init_opt_state(self, optimizer, params: Params):
        """The optimizer's initial state for ``params`` (on their device)."""
        return optimizer.init(params)

    def make_train_step(self, optimizer, accum_steps: int = 1) -> Callable:
        """``step(params, opt_state, token_ids, targets) -> (params,
        opt_state, loss, metrics)``.

        ``optimizer`` follows the optax contract (``optim.adamw``,
        ``ops.fused_adafactor.fused_adafactor``); one with ``apply_fused``
        folds the parameter add into its own pass.  Parameters are updated
        in place (the counterpart of the JAX step's buffer donation), so
        the returned tree is the one passed in.

        ``accum_steps > 1`` takes token_ids/targets of shape [accum, batch,
        seq], runs the microbatches one after another, sums their
        gradients in f32, applies ONE update with the mean, and averages
        loss and metrics.

        On a mesh token_ids/targets are this rank's part of the batch
        (:meth:`local_batch`; with accumulation, of each microbatch), and
        ``optimizer`` is built over the mesh (its ``mesh`` and ``specs``)."""
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        apply_fn = getattr(optimizer, "apply_fused", None)
        if apply_fn is None:
            def apply_fn(params, grads, opt_state):
                # optax transforms expect grads in the param dtype
                grads = tree_map(lambda g, p: g.to(p.dtype), grads, params)
                updates, opt_state = optimizer.update(grads, opt_state, params)
                return apply_updates(params, updates), opt_state

        def train_step(params, opt_state, token_ids, targets):
            token_ids, targets = token_ids.to(self.device), targets.to(self.device)
            (loss, metrics), grads = self.value_and_grad(params, token_ids,
                                                         targets)
            with record_function(f"{PROFILE_RANGE}optimizer"):
                params, opt_state = apply_fn(params, grads, opt_state)
            return params, opt_state, loss, metrics

        def accum_step(params, opt_state, token_ids, targets):
            if token_ids.shape[0] != accum_steps:
                raise ValueError(
                    f"token_ids must lead with the {accum_steps} microbatches, "
                    f"got shape {tuple(token_ids.shape)}"
                )
            token_ids, targets = token_ids.to(self.device), targets.to(self.device)
            # accumulate in f32: bf16 microbatch grads summed in bf16 lose
            # precision to swamping as accum_steps grows
            gsum = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            lsum, msum = torch.zeros((), device=self.device), None
            for i in range(accum_steps):
                (loss, metrics), grads = self.value_and_grad(
                    params, token_ids[i], targets[i], reduce=False)
                tree_map(lambda a, g: a.add_(g), gsum, grads)
                del grads
                lsum = lsum + loss
                msum = metrics if msum is None else {
                    key: msum[key] + val for key, val in metrics.items()}
            # the shares of every microbatch, summed over the mesh at once
            self.reduce_grads(gsum, params)
            inv = 1.0 / accum_steps
            # stay f32: the fused optimizer consumes f32 grads directly; the
            # optax-contract path casts to the param dtype itself
            grads = tree_map(lambda g: g.mul_(inv), gsum)
            with record_function(f"{PROFILE_RANGE}optimizer"):
                params, opt_state = apply_fn(params, grads, opt_state)
            metrics = {key: val * inv for key, val in msum.items()}
            return params, opt_state, lsum * inv, metrics

        return accum_step if accum_steps > 1 else train_step

    # ---- autoregressive decoding ----

    def decode_model(self) -> "DMoETransformerLM":
        """The model to decode with: the same weights with eval-safe
        routing.  Expert-choice gating falls back to token-choice top-k
        over the same gate affinities, and router jitter is switched off,
        as in the JAX package.  Memoized."""
        cfg = self.cfg
        changed = {}
        if cfg.gating == "expert_choice":
            logging.getLogger(__name__).warning(
                "expert_choice routing is batch-dependent and cannot be "
                "reproduced at autoregressive decode; falling back to "
                "token-choice top-%d routing over the same gate affinities",
                cfg.k,
            )
            changed["gating"] = "topk"
        if cfg.router_jitter:
            changed["router_jitter"] = 0.0
        if not changed:
            return self
        if self._decode_model is None:
            self._decode_model = DMoETransformerLM(
                dataclasses.replace(cfg, **changed), self.device, self.mesh
            )
        return self._decode_model

    @torch.no_grad()
    def generate(
        self,
        params: Params,
        prompt_ids: torch.Tensor,
        max_new_tokens: int,
        temperature: float = 0.0,
        rng: torch.Tensor | None = None,
        use_cache: bool = False,
    ) -> torch.Tensor:
        """Greedy (or temperature-sampled) autoregressive decoding.

        prompt_ids: [B, P] integer ids with P + max_new_tokens <= seq_len.
        Returns [B, P + max_new_tokens] in the prompt's dtype.  Routing
        follows :meth:`decode_model`.  ``use_cache=False`` re-runs the full
        forward over the fixed-length buffer each step, with right padding
        masked out of MoE routing; ``use_cache=True`` prefills a KV cache
        on the prompt and then decodes one position per step, routing only
        the B live tokens (see the JAX docstring for when the two agree).
        On a mesh every rank passes the whole prompt and gets the whole
        output; the cached decoder needs B and B * P to divide over the
        mesh's token shards, and no ``seq`` axis.

        Greedy decoding matches the JAX package token for token.
        ``temperature > 0`` samples under ``rng`` (required; a key of
        :func:`learning_at_home_tpu_torch.random.PRNGKey`) as the JAX
        package does: the key is split before every new token and the
        token drawn with ``categorical(sub, logits / temperature)``, so the
        same seed and params give the JAX package's tokens.
        """
        b, p = prompt_ids.shape
        s = self.cfg.seq_len
        if p == 0:
            raise ValueError("prompt must have at least one token")
        if p + max_new_tokens > s:
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"seq_len {s}"
            )
        if max_new_tokens < 0:
            raise ValueError(
                f"max_new_tokens must be >= 0, got {max_new_tokens}"
            )
        if temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if temperature > 0 and rng is None:
            raise ValueError("temperature > 0 requires an rng key")
        if max_new_tokens == 0:
            return prompt_ids
        if use_cache and self.mesh is not None:
            if self.cfg.seq_parallel:
                raise NotImplementedError(
                    "use_cache=True does not compose with seq_parallel (the "
                    "cache is not ring-sharded); decode on a mesh without a "
                    "'seq' axis")
            n_shards = self.mesh.size(data_axes(self.mesh))
            if b % n_shards or (b * p) % n_shards:
                raise ValueError(
                    f"use_cache=True routes B={b} rows per decode step and "
                    f"B*P={b * p} in prefill, which must divide the mesh's "
                    f"{n_shards} token shards -- grow the batch or decode "
                    "without the cache (the re-forward path routes the "
                    "whole buffer and is immune)")
        model = self.decode_model()
        decode = model._generate_cached if use_cache else model._generate_full
        return decode(
            params, prompt_ids.to(model.device), max_new_tokens,
            float(temperature), rng,
        )

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                rng: torch.Tensor | None):
        """[B, V] f32 logits → ([B] ids, the key of the next draw): argmax
        (ties to the lower index), or at ``temperature > 0``
        ``categorical(sub, logits / temperature)`` with ``rng, sub =
        split(rng)``, the JAX package's draw."""
        if temperature > 0:
            rng, sub = prng.split(rng)
            return prng.categorical(sub, logits / temperature), rng
        return torch.argmax(logits, dim=-1), rng

    def _generate_full(self, params, prompt_ids, max_new_tokens,
                       temperature, rng) -> torch.Tensor:
        """Re-forward decoding: every step runs the full masked forward
        over the fixed-length buffer."""
        b, p = prompt_ids.shape
        s = self.cfg.seq_len
        buf = torch.zeros((b, s), dtype=prompt_ids.dtype, device=self.device)
        buf[:, :p] = prompt_ids
        positions = torch.arange(s, device=self.device)
        for t in range(p - 1, p - 1 + max_new_tokens):
            # positions <= t hold real tokens; the rest must not compete
            # for expert capacity
            valid = (positions[None, :] <= t).expand(b, s)
            logits, _ = self.apply(params, buf, token_mask=valid,
                                   replicated=True)
            nxt, rng = self._sample(logits[:, t], temperature, rng)
            buf[:, t + 1] = nxt.to(buf.dtype)
        return buf[:, : p + max_new_tokens]

    def _generate_cached(self, params, prompt_ids, max_new_tokens,
                         temperature, rng) -> torch.Tensor:
        """KV-cache decoding: prefill the caches on the prompt, then one
        position per step.  The caches are updated in place (the JAX
        version rebuilds them functionally; the values are the same)."""
        cfg = self.cfg
        b, p = prompt_ids.shape
        s_cache = p + max_new_tokens
        hd = cfg.d_model // cfg.n_heads
        head = self._head(params)

        # ---- prefill: full forward over the prompt, caches filled ----
        x = self._embed(params, prompt_ids)
        k_caches, v_caches = [], []
        for i in range(cfg.n_layers):
            lp = self._layer_params(params, i)
            h = layer_norm(lp["ln1"], x)
            q, k, v = qkv_projections(lp, h, cfg.n_heads)
            x = x + output_projection(
                lp, attention_core(q, k, v, cfg.attn_impl)
            )
            moe_out, _ = self._moe(lp["moe"], layer_norm(lp["ln2"], x), i,
                                   replicated=True)
            x = x + moe_out
            kc = torch.zeros(
                (b, s_cache, cfg.n_heads, hd), dtype=k.dtype, device=self.device
            )
            vc = torch.zeros_like(kc)
            kc[:, :p] = k
            vc[:, :p] = v
            k_caches.append(kc)
            v_caches.append(vc)
        x_last = layer_norm(params["ln_f"], x[:, -1:])
        tok, rng = self._sample(
            self._logits(x_last, head)[:, 0], temperature, rng
        )
        out = [tok]

        # ---- decode: one position per step ----
        for t in range(p, p + max_new_tokens - 1):
            x = self._embed(params, tok[:, None], start=t)  # [B, 1, d]
            for i in range(cfg.n_layers):
                lp = self._layer_params(params, i)
                h = layer_norm(lp["ln1"], x)
                q, k, v = qkv_projections(lp, h, cfg.n_heads)
                k_caches[i][:, t] = k[:, 0]
                v_caches[i][:, t] = v[:, 0]
                x = x + one_query_attention(
                    lp, q, k_caches[i], v_caches[i], t
                )
                moe_out, _ = self._moe(lp["moe"], layer_norm(lp["ln2"], x),
                                       i, replicated=True)
                x = x + moe_out
            x = layer_norm(params["ln_f"], x)
            tok, rng = self._sample(
                self._logits(x, head)[:, 0], temperature, rng
            )
            out.append(tok)
        new = torch.stack(out, dim=1).to(prompt_ids.dtype)
        return torch.cat([prompt_ids, new], dim=1)
