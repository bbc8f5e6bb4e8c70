"""DMoE-Transformer language model in pod mode: forward, serving, training.

The PyTorch counterpart of ``learning_at_home_tpu/models/transformer.py``
for one device: a causal Transformer LM whose FFNs are mixtures of
experts (``parallel/sharded_moe.py``), with the full re-forward decoder
and the KV-cache decoder of ``generate``, the loss (the chunked
cross-entropy, or the fused one of ``ops/fused_ce.py`` with its Hopper
kernels), per-layer remat and the train step with gradient accumulation.

Parameters are an explicit tree of tensors with the JAX package's names,
shapes and layouts (stacked layers with a leading ``n_layers`` dim, or a
tuple of per-layer trees), so converted checkpoints (``convert.py``)
compare leaf by leaf.  Each layer passes its index to the MoE as the
router-jitter salt.  Remat ``"full"`` keeps only each layer's input;
``"dots"`` also keeps the outputs of the layer's products without batch
dims (the projections and the gate), as JAX's
``dots_with_no_batch_dims_saveable``.  Sequence parallelism is not ported
yet; it raises ``NotImplementedError`` naming the ROADMAP.md item that
ports it.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Any, Callable

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
from learning_at_home_tpu_torch.ops.fused_ce import _check, fused_softmax_ce
from learning_at_home_tpu_torch.optim import apply_updates
from learning_at_home_tpu_torch.parallel.sharded_moe import (
    ShardedMixtureOfExperts,
)
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any

# the prefix of the profiler ranges the model opens: each layer's
# attention and MoE, the loss, the backward and the optimizer update
PROFILE_RANGE = "dmoe/"
TRAINING_ITEM = ("ROADMAP.md, port queue item 2 (what remains of the pod-mode "
                 "train step)")
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
    # kernel; 'auto' = flash on a CUDA device at seq_len >= 8192 with
    # seq_len % min(512, seq_len) == 0, else xla (the JAX rule, with the
    # CUDA card in the place of the TPU)
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
    the CUDA card (see :func:`~learning_at_home_tpu_torch.device.resolve_device`).
    """

    def __init__(self, config: DMoETransformerConfig, device=None):
        self.device = resolve_device(device)
        if config.attn_impl == "auto":
            impl = (
                "flash"
                if self.device.type == "cuda"
                and config.seq_len >= 8192
                and config.seq_len % min(512, config.seq_len) == 0
                else "xla"
            )
            config = dataclasses.replace(config, attn_impl=impl)
        if config.scan_layers and not config.stack_layers:
            raise ValueError(
                "scan_layers=True requires stack_layers=True (the JAX scan "
                "consumes the stacked param tree)"
            )
        if config.seq_parallel:
            raise NotImplementedError(
                f"seq_parallel (ring attention) is not ported yet: "
                f"{TRAINING_ITEM}"
            )
        if config.remat and config.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"remat_policy must be 'full' or 'dots', got "
                f"{config.remat_policy!r}"
            )
        self.cfg = config
        self._decode_model: "DMoETransformerLM | None" = None
        self.moe = ShardedMixtureOfExperts(
            hidden_dim=config.d_model,
            num_experts=config.num_experts,
            k=config.k,
            capacity_factor=config.capacity_factor,
            dtype=config.dtype,
            param_dtype=config.param_dtype,
            router_jitter=config.router_jitter,
            gating=config.gating,
        )

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
                "moe": self.moe.init_params(ks[4]),
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
        return params

    # ---- forward ----

    def _layer_params(self, params: Params, i: int):
        """Layer i's param tree under either layout (stacked / tuple)."""
        if self.cfg.stack_layers:
            return _layer_slice(params["layers"], i)
        return params["layers"][i]

    def _layer(self, lp, x, layer_idx, token_mask=None):
        # profiler ranges (PROFILE_RANGE): profile_training.py attributes
        # device time to them
        with record_function(f"{PROFILE_RANGE}layer{layer_idx}/attention"):
            x = x + causal_attention(
                lp, layer_norm(lp["ln1"], x), self.cfg.n_heads,
                impl=self.cfg.attn_impl,
            )
        b, s, d = x.shape
        with record_function(f"{PROFILE_RANGE}layer{layer_idx}/moe"):
            moe_in = layer_norm(lp["ln2"], x).reshape(b * s, d)
            # the layer index salts the router jitter: each layer draws its
            # own noise, and remat's recompute draws the forward's
            moe_out, aux = self.moe(
                lp["moe"], moe_in, jitter_salt=layer_idx,
                token_mask=(None if token_mask is None
                            else token_mask.reshape(b * s)),
            )
        return x + moe_out.reshape(b, s, d), aux

    def _embed(self, params: Params, token_ids: torch.Tensor,
               start: int = 0) -> torch.Tensor:
        """Token plus position embeddings of [B, S] ids at positions
        ``start ..``, in the compute dtype."""
        dt = self.cfg.dtype
        s = token_ids.shape[1]
        # F.embedding: its backward sums repeated tokens in parallel
        x = F.embedding(token_ids.long(), params["embed"]).to(dt)
        return x + params["pos"][None, start: start + s].to(dt)

    def _hidden(
        self, params: Params, token_ids: torch.Tensor,
        token_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """token_ids [B, S] → final-LN hidden states [B, S, d]; aux scalars
        averaged over layers.  ``token_mask`` [B, S] bool: False marks
        padding that must not take part in MoE routing."""
        x = self._embed(params, token_ids)
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
                                    use_reentrant=False, **extra)
            else:
                x, aux = self._layer(lp, x, i, token_mask)
            aux_total = aux if aux_total is None else {
                key: aux_total[key] + aux[key] for key in aux_total
            }
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
        token_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """token_ids [B, S] → logits [B, S, V] (f32); aux dict of scalars."""
        x, aux_mean = self._hidden(params, token_ids, token_mask)
        return self._logits(x, self._head(params)), aux_mean

    # ---- loss / train step ----

    def _fused_ce_or_none(self, head, flat_x, flat_t, n):
        """Mean CE through the fused kernels (``ops/fused_ce.py``) when
        ``ce_impl="fused"`` and their preconditions hold, else None and the
        caller runs the chunked CE (never a full [n, V] logits buffer).
        One device: the JAX package's single-device branch."""
        if self.cfg.ce_impl != "fused":
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
        x, aux = self._hidden(params, token_ids)
        with record_function(f"{PROFILE_RANGE}loss"):
            head = self._head(params)
            n = x.shape[0] * x.shape[1]
            flat_x = x.reshape(n, x.shape[-1])
            flat_t = targets.reshape(n)

            ce = self._fused_ce_or_none(head, flat_x, flat_t, n)
            if ce is None:
                chunk = min(self.cfg.ce_chunk, n)
                ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
                for start in range(0, n, chunk):
                    ce_sum = ce_sum + checkpoint(
                        self._chunk_ce_sum, flat_x[start: start + chunk],
                        head, flat_t[start: start + chunk],
                        use_reentrant=False,
                    )
                ce = ce_sum / n
        loss = (
            ce
            + self.cfg.aux_loss_weight * aux["aux_loss"]
            + self.cfg.router_z_weight * aux["router_z_loss"]
        )
        return loss, {"ce": ce, **aux}

    def value_and_grad(self, params: Params, token_ids: torch.Tensor,
                       targets: torch.Tensor):
        """``((loss, metrics), grads)`` of :meth:`loss_fn`, with ``grads`` a
        tree shaped like ``params`` (zeros for an unused leaf), as
        ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them.  The
        parameters themselves are not marked as requiring gradients."""
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, metrics = self.loss_fn(live, token_ids, targets)
            with record_function(f"{PROFILE_RANGE}backward"):
                grads = torch.autograd.grad(
                    loss, tree_leaves(live), allow_unused=True,
                    materialize_grads=True,
                )
        metrics = {key: val.detach() for key, val in metrics.items()}
        return (loss.detach(), metrics), tree_unflatten(params, grads)

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
        loss and metrics."""
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
                    params, token_ids[i], targets[i])
                tree_map(lambda a, g: a.add_(g), gsum, grads)
                del grads
                lsum = lsum + loss
                msum = metrics if msum is None else {
                    key: msum[key] + val for key, val in metrics.items()}
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
                dataclasses.replace(cfg, **changed), self.device
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
            logits, _ = self.apply(params, buf, token_mask=valid)
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
            moe_in = layer_norm(lp["ln2"], x).reshape(b * p, cfg.d_model)
            moe_out, _ = self.moe(lp["moe"], moe_in, jitter_salt=i)
            x = x + moe_out.reshape(b, p, cfg.d_model)
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
                moe_in = layer_norm(lp["ln2"], x).reshape(b, cfg.d_model)
                moe_out, _ = self.moe(lp["moe"], moe_in, jitter_salt=i)
                x = x + moe_out.reshape(b, 1, cfg.d_model)
            x = layer_norm(params["ln_f"], x)
            tok, rng = self._sample(
                self._logits(x, head)[:, 0], temperature, rng
            )
            out.append(tok)
        new = torch.stack(out, dim=1).to(prompt_ids.dtype)
        return torch.cat([prompt_ids, new], dim=1)
