"""The DMoE-Transformer written plainly in PyTorch, in float32 with TF32 off.

This is the yardstick the benchmark holds the port against.  It follows
the model's published description (Learning@home's DMoE-Transformer,
arXiv:2002.04013) with the semantics the configuration states: pre-LN
blocks (f32 statistics, eps 1e-5), causal softmax attention with scale
``1/sqrt(head_dim)``, a top-k mixture of GELU (tanh) experts with capacity
``ceil(n k cf / E)`` per expert claimed in token order (every token's
first choice before any second choice; a choice past capacity is dropped),
renormalised top-k weights, the load-balance loss ``E <importance . top-1
load>`` and the router z-loss, the tied output head and the mean
next-token cross-entropy.  It imports nothing of the program and takes
only the weights and inputs the benchmark made.

``precision="fp8"`` is the control: every matrix product's operands are
rounded to float8 e4m3 with a per-tensor scale (their gradients to e5m2),
the product then taken in f32 (a block of rows, or of experts, that one
product takes has its own scale).  It stands for the step below the
configuration's bf16 compute.

Memory: the routing of a batch is decided once, over all its tokens, in
a forward without gradients; the loss is then a sum over tokens, so its
backward runs a block of rows at a time and the gradients add up.  In a
block, attention runs a block of rows and the expert FFN a block of
experts at a time, under ``torch.utils.checkpoint``, as do each layer
and each chunk of the loss's logits, so the reference fits beside
nothing else on the card at the timed sizes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SCORES_PER_BLOCK = 1 << 27  # f32 scores a block of attention rows holds
HIDDEN_PER_BLOCK = 1 << 28  # f32 expert activations a block of experts holds
LOGITS_PER_CHUNK = 1 << 28  # f32 logits a chunk of the loss holds
TOKENS_PER_BLOCK = 1 << 17  # tokens a block of rows takes through a backward
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX[dtype] / amax
    return ((x * scale).to(dtype).to(x.dtype) / scale)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


class Model:
    """The reference of one configuration (a dict of the config file)."""

    def __init__(self, cfg: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.cfg = cfg
        self.fp8 = precision == "fp8"
        self.n_heads = cfg["n_heads"]
        self.k = cfg["k"]
        self.cf = cfg["capacity_factor"]

    # ---- pieces ----

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def mm(self, a, b):
        return self.q(a) @ self.q(b)

    @staticmethod
    def layer_norm(p, x, eps: float = 1e-5):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + eps) * p["scale"] + p["bias"]

    def _attend(self, q, k, v):
        """Causal attention of [b,S,H,hd] blocks."""
        s, hd = q.shape[1], q.shape[-1]
        scores = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k))
        scores = scores / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, float("-inf"))
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", self.q(w), self.q(v))

    def attention(self, lp, h):
        b, s, d = h.shape
        hd = d // self.n_heads
        q, k, v = (self.mm(h, lp[w]).reshape(b, s, self.n_heads, hd)
                   for w in ("wq", "wk", "wv"))
        rows = max(1, SCORES_PER_BLOCK // (self.n_heads * s * s))
        outs = []
        for i in range(0, b, rows):
            blk = (q[i:i + rows], k[i:i + rows], v[i:i + rows])
            outs.append(checkpoint(self._attend, *blk, use_reentrant=False)
                        if torch.is_grad_enabled() else self._attend(*blk))
        return self.mm(torch.cat(outs).reshape(b, s, d), lp["wo"])

    def route(self, logits):
        """(top_i [n,k], pos [n,k]) of a whole batch's gate logits: top-k
        of the gates by argmax passes (ties to the lower index), slots
        claimed in token order, every first choice before any second."""
        n, e = logits.shape
        g = torch.softmax(logits.detach(), dim=-1)
        idx = []
        for _ in range(self.k):
            i = torch.argmax(g, dim=-1)
            idx.append(i)
            g[torch.arange(n, device=g.device), i] = -1.0
        top_i = torch.stack(idx, dim=1)
        counts = torch.zeros(e, dtype=torch.long, device=logits.device)
        pos = []
        for j in range(self.k):
            onehot = F.one_hot(top_i[:, j], e)
            before = torch.cumsum(onehot, dim=0) - onehot + counts
            pos.append(before.gather(1, top_i[:, j:j + 1])[:, 0])
            counts = counts + onehot.sum(dim=0)
        return top_i, torch.stack(pos, dim=1)

    def plan(self, p, x) -> tuple:
        """The routing of a whole batch's ``x`` [n,d] at one layer,
        decided once: ``(top_i, pos, cap, load)``, ``load`` the share of
        first choices per expert."""
        n, e = x.shape[0], p["gate"].shape[1]
        cap = max(1, math.ceil(n * self.k * self.cf / e))
        top_i, pos = self.route(self.mm(x, p["gate"]))
        load = F.one_hot(top_i[:, 0], e).to(x.dtype).mean(dim=0)
        return top_i, pos, cap, load

    def _experts(self, xe, w1, b1, w2, b2):
        """The GELU FFN of a block of experts: [e,c,d] → [e,c,d]."""
        hid = F.gelu(self.mm(xe, w1) + b1[:, None, :], approximate="tanh")
        return self.mm(hid, w2) + b2[:, None, :]

    def moe(self, p, x, top_i, pos, cap):
        """Tokens ``x`` [n,d] of a batch whose routing :meth:`plan`
        decided → (y [n,d], the sum of their gates [E], the sum of their
        squared gate log-sum-exps).  A choice past ``cap`` is dropped; the
        kept ones take the renormalised top-k weights."""
        n, d = x.shape
        e = p["gate"].shape[1]
        logits = self.mm(x, p["gate"])
        gates = torch.softmax(logits, dim=-1)
        top_w = torch.gather(gates, 1, top_i)
        top_w = top_w / top_w.sum(dim=1, keepdim=True).clamp(
            min=torch.finfo(top_w.dtype).tiny)
        fits = pos < cap
        ex = top_i[fits]  # each kept choice, its expert and token
        tok = torch.arange(n, device=x.device)[:, None].expand(n, self.k)[fits]
        onehot = F.one_hot(ex, e)  # a slot of these tokens' own per choice
        local = (torch.cumsum(onehot, dim=0) - onehot).gather(1, ex[:, None])[:, 0]
        width = max(1, int(onehot.sum(dim=0).max()) if ex.numel() else 1)
        slot = ex * width + local
        xe = x.new_zeros(e * width, d).index_copy(0, slot, x[tok])
        xe = xe.reshape(e, width, d)
        per = max(1, HIDDEN_PER_BLOCK // (width * p["w1"].shape[-1]))
        blocks = []
        for i in range(0, e, per):
            blk = (xe[i:i + per],) + tuple(p[w][i:i + per]
                                            for w in ("w1", "b1", "w2", "b2"))
            blocks.append(checkpoint(self._experts, *blk, use_reentrant=False)
                          if torch.is_grad_enabled() else self._experts(*blk))
        ye = torch.cat(blocks).reshape(e * width, d)
        y = x.new_zeros(n, d).index_add(0, tok, top_w[fits][:, None] * ye[slot])
        z = (torch.logsumexp(logits, dim=-1) ** 2).sum()
        return y, gates.sum(dim=0), z

    def _mixed(self, lp, x):
        """Attention's residual and the MoE's input of [B,S,d] ``x``."""
        h = x + self.attention(lp, self.layer_norm(lp["ln1"], x))
        return h, self.layer_norm(lp["ln2"], h).reshape(-1, h.shape[-1])

    def block(self, lp, x, top_i, pos, cap):
        """One layer of [B,S,d] ``x`` with its tokens' routing → (x, the
        sum of gates, the sum of squared log-sum-exps)."""
        h, flat = self._mixed(lp, x)
        y, gates, z = self.moe(lp["moe"], flat, top_i, pos, cap)
        return h + y.reshape(h.shape), gates, z

    def embed(self, params, ids, start: int = 0):
        s = ids.shape[1]
        return params["embed"][ids.long()] + params["pos"][start:start + s][None]

    # ---- training ----

    @torch.no_grad()
    def plans(self, params, layers, ids) -> list:
        """Each layer's routing of the whole batch ``ids`` (:meth:`plan`)."""
        x = self.embed(params, ids)
        out = []
        for lp in layers:
            h, flat = self._mixed(lp, x)
            out.append(self.plan(lp["moe"], flat))
            y, _, _ = self.moe(lp["moe"], flat, *out[-1][:3])
            x = h + y.reshape(h.shape)
            del h, flat, y
        return out

    def _ce_chunk(self, x, head_t, t):
        logits = self.mm(x, head_t)
        picked = logits.gather(1, t[:, None].long())[:, 0]
        return (torch.logsumexp(logits, dim=-1) - picked).sum()

    def loss_and_grads(self, params, leaves, ids, tgt):
        """The mean loss of one batch (a float) and its gradient by each
        of ``leaves`` (the tensors ``params`` is built of).  The routing
        is decided once over the whole batch (:meth:`plans`); the loss is
        a sum over tokens given it, so its backward runs a block of rows
        at a time and the gradients add up:
        the cross-entropy, the load-balance loss ``E <importance . top-1
        load>`` and the router z-loss, each a mean over all tokens, the
        latter two averaged over layers."""
        layers = params["layers"]
        plans = self.plans(params, layers, ids)
        b, s = ids.shape
        n, n_layers = b * s, len(layers)
        e = plans[0][3].shape[0]
        head_t = params["embed"].t()
        chunk = max(1, LOGITS_PER_CHUNK // head_t.shape[1])
        rows = max(1, TOKENS_PER_BLOCK // s)
        total, grads = 0.0, None
        for r in range(0, b, rows):
            tokens = slice(r * s, min(r + rows, b) * s)
            x = self.embed(params, ids[r:r + rows])
            aux = z = 0.0
            for lp, (top_i, pos, cap, load) in zip(layers, plans):
                x, gates, zs = checkpoint(self.block, lp, x, top_i[tokens],
                                          pos[tokens], cap, use_reentrant=False)
                aux = aux + e * torch.sum(gates * load) / n
                z = z + zs / n
            flat = self.layer_norm(params["ln_f"], x).reshape(-1, x.shape[-1])
            t = tgt[r:r + rows].reshape(-1)
            ce = sum(checkpoint(self._ce_chunk, flat[i:i + chunk], head_t,
                                t[i:i + chunk], use_reentrant=False)
                     for i in range(0, flat.shape[0], chunk)) / n
            part = (ce + self.cfg["aux_loss_weight"] * aux / n_layers
                    + self.cfg["router_z_weight"] * z / n_layers)
            got = torch.autograd.grad(part, leaves, allow_unused=True,
                                      materialize_grads=True)
            grads = list(got) if grads is None else [
                a.add_(g) for a, g in zip(grads, got)]
            total += float(part.detach())
            del x, flat, part, got
        return total, grads
