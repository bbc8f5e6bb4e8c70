"""The yardstick's arithmetic: the card's peaks, a step's FLOPs, and
each kernel's operations and bytes for its roofline.

Frozen here so that no change to the program moves the yardstick.  The
training FLOPs a token are the model family's own count
(``families/<name>.py`` ``train_flops_per_token``).  A kernel launch's
bound is the larger of its operations at the bf16 peak and its bytes at
the memory bandwidth, the bytes counting each input read once and each
output written once.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at its full 700 W limit: dense bf16
# FLOP/s and HBM3 bytes a second
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16, F32, I32 = 2, 4, 4


def train_flops_per_step(family, cfg: dict, batch: int) -> float:
    return family.train_flops_per_token(cfg) * batch * cfg["seq_len"]


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


# ---- kernels: (operations, bytes) of one launch ----


def fused_ce(mode: str, n: int, d: int, v: int) -> tuple[float, float]:
    """K1 (``fwd``: logits, lse and ce), K2 (``dx``: logits again, then
    dl @ head^T) and K3 (``dhead``: logits again, then x^T @ dl).  Inputs
    x [n,d] and head [d,v] bf16, targets [n] int32; the backward also
    reads lse and dce [n] f32."""
    ins = n * d * BF16 + d * v * BF16 + n * I32
    if mode == "fwd":
        return 2.0 * n * d * v, ins + 2 * n * F32
    ins += 2 * n * F32
    out = n * d * BF16 if mode == "dx" else v * d * BF16
    return 4.0 * n * d * v, ins + out


def causal_pairs(s: int) -> float:
    return s * (s + 1) / 2


def flash_attn(mode: str, b: int, s: int, h: int, hd: int,
               with_lse: bool = True) -> tuple[float, float]:
    """K5: ``fwd`` (q k^T and p v over the causal pairs; reads q, k, v,
    writes o and, when training, lse), ``dkv`` (q k^T, do v^T, p^T do and
    ds^T q; reads q, k, v, do, lse and di, writes dk and dv) and ``dq``
    (q k^T, do v^T and ds k; writes dq)."""
    pairs = b * h * causal_pairs(s)
    tensor = b * s * h * hd * BF16
    row = b * h * s * F32
    if mode == "fwd":
        return 4.0 * hd * pairs, 4 * tensor + (row if with_lse else 0)
    if mode == "dkv":
        return 8.0 * hd * pairs, 4 * tensor + 2 * row + 2 * tensor
    return 6.0 * hd * pairs, 4 * tensor + 2 * row + tensor
