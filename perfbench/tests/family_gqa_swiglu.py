"""A tiny model family whose tree shares nothing with the DMoE's but the
``layers`` list: RMSNorm without bias, rotary positions (no position
table), grouped-query attention (``q_proj [d, h*hd]`` beside ``k_proj``
and ``v_proj [d, h_kv*hd]``, ``h_kv < h``), a SwiGLU FFN and an untied
head.  ``test_perfbench_family.py`` copies it into a families directory of
its own.

The program side is plain torch over the port's fused Adafactor (the
optimizer the training traffic names); the reference is the same
mathematics written out in f32, as ``reference/`` writes a family's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from perfbench.lib import weights
from perfbench.reference.precision import DTYPES

RANGE_PREFIX = "tiny/"
ROPE_BASE = 10000.0


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple, str, float]]:
    d, v, f = cfg["d_model"], cfg["vocab_size"], cfg["ffn_dim"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]

    def lecun(shape):
        return 1.0 / math.sqrt(math.prod(shape[:-1]))

    out = [(("tok_embed",), (v, d), "normal", d ** -0.5),
           (("norm_f", "weight"), (d,), "ones", 0.0),
           (("lm_head",), (d, v), "normal", lecun((d, v)))]
    for i in range(cfg["n_layers"]):
        lay = ("layers", i)
        out += [(lay + ("attn_norm", "weight"), (d,), "ones", 0.0),
                (lay + ("q_proj",), (d, q), "normal", lecun((d, q))),
                (lay + ("k_proj",), (d, kv), "normal", lecun((d, kv))),
                (lay + ("v_proj",), (d, kv), "normal", lecun((d, kv))),
                (lay + ("o_proj",), (q, d), "normal", lecun((q, d))),
                (lay + ("mlp_norm", "weight"), (d,), "ones", 0.0),
                (lay + ("gate_proj",), (d, f), "normal", lecun((d, f))),
                (lay + ("up_proj",), (d, f), "normal", lecun((d, f))),
                (lay + ("down_proj",), (f, d), "normal", lecun((f, d)))]
    return out


def train_flops_per_token(cfg: dict) -> float:
    d, v, f, s = cfg["d_model"], cfg["vocab_size"], cfg["ffn_dim"], cfg["seq_len"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    layer = 2 * d * (2 * q + 2 * kv) + 4 * s * q + 6 * d * f
    return 3.0 * (2 * d * v + cfg["n_layers"] * layer)


def _rope(x: torch.Tensor) -> torch.Tensor:
    """Rotary positions of [b, heads, s, hd] ``x``, rotating halves."""
    s, hd = x.shape[-2], x.shape[-1]
    inv = ROPE_BASE ** (-torch.arange(0, hd, 2, device=x.device).float() / hd)
    ang = torch.arange(s, device=x.device).float()[:, None] * inv[None]
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    a, b = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class TinyLM:
    """The program side: ``init_opt_state`` and ``make_train_step`` as the
    port's models give them."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.dtype = DTYPES[cfg["compute_dtype"]]
        self.specs = leaf_specs(cfg)

    def attention(self, lp, x):
        c = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
        q = (x @ lp["q_proj"]).view(b, s, h, hd).transpose(1, 2)
        k = (x @ lp["k_proj"]).view(b, s, hkv, hd).transpose(1, 2)
        v = (x @ lp["v_proj"]).view(b, s, hkv, hd).transpose(1, 2)
        k = _rope(k).repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
        o = F.scaled_dot_product_attention(_rope(q), k, v, is_causal=True)
        return o.transpose(1, 2).reshape(b, s, h * hd) @ lp["o_proj"]

    def ffn(self, lp, x):
        return (F.silu(x @ lp["gate_proj"]) * (x @ lp["up_proj"])) @ lp["down_proj"]

    def loss(self, tree, ids, tgt):
        d, eps = self.cfg["d_model"], self.cfg["rms_eps"]
        x = tree["tok_embed"][ids.long()]
        for i, lp in enumerate(tree["layers"]):
            with record_function(f"{RANGE_PREFIX}layer{i}/attention"):
                x = x + self.attention(
                    lp, F.rms_norm(x, (d,), lp["attn_norm"]["weight"], eps))
            with record_function(f"{RANGE_PREFIX}layer{i}/ffn"):
                x = x + self.ffn(
                    lp, F.rms_norm(x, (d,), lp["mlp_norm"]["weight"], eps))
        logits = F.rms_norm(x, (d,), tree["norm_f"]["weight"], eps) @ tree["lm_head"]
        return F.cross_entropy(logits.float().flatten(0, 1), tgt.long().flatten())

    def init_opt_state(self, opt, params):
        return opt.init(params)

    def make_train_step(self, opt):
        def step(params, state, ids, tgt):
            live = [weights.get_leaf(params, p).to(self.dtype, copy=True)
                    .requires_grad_(True) for p, *_ in self.specs]
            loss = self.loss(weights.tree_of(self.specs, live), ids, tgt)
            got = torch.autograd.grad(loss, live, allow_unused=True,
                                      materialize_grads=True)
            grads = weights.tree_of(self.specs, got)
            with record_function(f"{RANGE_PREFIX}optimizer"):
                params, state = opt.apply_fused(params, grads, state)
            return params, state, loss.detach(), {}

        return step


def build(cfg: dict, traffic: dict, device) -> TinyLM:
    if cfg["n_heads"] % cfg["n_kv_heads"]:
        raise ValueError("n_heads must be a multiple of n_kv_heads")
    return TinyLM(cfg, device)


class Reference:
    """The same model written out in f32: RMS statistics, scores, softmax
    and the cross-entropy each by hand."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def rms(self, w, x):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.cfg["rms_eps"]) * w

    @staticmethod
    def rotate(x):
        """Rotary positions of [b, s, heads, hd] ``x``: pair ``j`` with
        ``j + hd/2``, turned by ``pos * base ** (-2j / hd)``."""
        s, hd = x.shape[1], x.shape[-1]
        j = torch.arange(hd // 2, dtype=torch.float32, device=x.device)
        pos = torch.arange(s, dtype=torch.float32, device=x.device)
        ang = torch.outer(pos, torch.exp(-2 * j / hd * math.log(ROPE_BASE)))
        cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
        a, b = x[..., : hd // 2], x[..., hd // 2:]
        return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)

    def attention(self, lp, x):
        c = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
        q = self.rotate((x @ lp["q_proj"]).reshape(b, s, h, hd))
        k = self.rotate((x @ lp["k_proj"]).reshape(b, s, hkv, hd))
        v = (x @ lp["v_proj"]).reshape(b, s, hkv, hd)
        group = torch.arange(h, device=x.device) // (h // hkv)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k[:, :, group]) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v[:, :, group])
        return o.reshape(b, s, h * hd) @ lp["o_proj"]

    def loss_and_grads(self, tree, leaves, ids, tgt):
        x = tree["tok_embed"][ids.long()]
        for lp in tree["layers"]:
            x = x + self.attention(lp, self.rms(lp["attn_norm"]["weight"], x))
            y = self.rms(lp["mlp_norm"]["weight"], x)
            gate = y @ lp["gate_proj"]
            x = x + (gate * torch.sigmoid(gate) * (y @ lp["up_proj"])) @ lp["down_proj"]
        logits = (self.rms(tree["norm_f"]["weight"], x) @ tree["lm_head"]).flatten(0, 1)
        picked = logits.gather(1, tgt.long().reshape(-1, 1))[:, 0]
        loss = (torch.logsumexp(logits, dim=-1) - picked).mean()
        return float(loss.detach()), list(torch.autograd.grad(loss, leaves))


def reference(cfg: dict, precision: str = "f32") -> Reference:
    if precision != "f32":
        raise ValueError(f"this family's reference is f32 only, not {precision!r}")
    return Reference(cfg)
