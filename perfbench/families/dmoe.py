"""The DMoE-Transformer family: the port's ``DMoETransformerLM``
(``models/transformer.py``) and its plain reference (``reference/dmoe.py``).

The tree has the port's keys and layouts (``embed [V,d]``, ``pos [S,d]``,
``ln_f``, and per layer ``ln1``, ``wq``..``wo`` ``[d,d]``, ``ln2`` and
``moe``: ``gate [d,E]``, ``w1 [E,d,f]``, ``b1 [E,f]``, ``w2 [E,f,d]``,
``b2 [E,d]``).  Scales: lecun-normal variance (1 / the product of every
dim but the last, as the port's initialiser counts fan-in), the
embeddings and positions N(0, 1/d), the gate N(0, 1e-2 ** 2); norms 1 and
0, biases 0.  The functions a family gives are listed in ``lib/spec.py``.
"""

from __future__ import annotations

import math

from perfbench.reference.dmoe import Model
from perfbench.reference.precision import DTYPES

RANGE_PREFIX = "dmoe/"  # the prefix of the port's profiler ranges


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple, str, float]]:
    """``(path, shape, init, std)`` of every leaf of one layer-less tree:
    paths into the tuple layout (``("layers", i, "moe", "w1")``)."""
    d, v, s = cfg["d_model"], cfg["vocab_size"], cfg["seq_len"]
    e, f = cfg["num_experts"], cfg["expert_ffn_dim"]

    def lecun(shape):
        return 1.0 / math.sqrt(math.prod(shape[:-1]))

    out = [(("embed",), (v, d), "normal", d ** -0.5),
           (("pos",), (s, d), "normal", d ** -0.5),
           (("ln_f", "scale"), (d,), "ones", 0.0),
           (("ln_f", "bias"), (d,), "zeros", 0.0)]
    for i in range(cfg["n_layers"]):
        lay = ("layers", i)
        for ln in ("ln1", "ln2"):
            out += [(lay + (ln, "scale"), (d,), "ones", 0.0),
                    (lay + (ln, "bias"), (d,), "zeros", 0.0)]
        for w in ("wq", "wk", "wv", "wo"):
            out.append((lay + (w,), (d, d), "normal", lecun((d, d))))
        moe = lay + ("moe",)
        out += [(moe + ("gate",), (d, e), "normal", 1e-2),
                (moe + ("w1",), (e, d, f), "normal", lecun((e, d, f))),
                (moe + ("b1",), (e, f), "zeros", 0.0),
                (moe + ("w2",), (e, f, d), "normal", lecun((e, f, d))),
                (moe + ("b2",), (e, d), "zeros", 0.0)]
    return out


def program_config(cfg: dict, traffic: dict):
    """The port's ``DMoETransformerConfig`` of ``cfg`` under ``traffic``;
    ValueError for a configuration the port cannot run as written."""
    from learning_at_home_tpu_torch.models.transformer import (
        DMoETransformerConfig,
    )
    if cfg["expert_ffn_dim"] != 4 * cfg["d_model"]:
        raise ValueError("the port's experts are 4 * d_model wide")
    if cfg["head_dim"] * cfg["n_heads"] != cfg["d_model"]:
        raise ValueError("head_dim * n_heads must be d_model")
    remat = traffic.get("remat", "none")
    return DMoETransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        seq_len=cfg["seq_len"], num_experts=cfg["num_experts"], k=cfg["k"],
        capacity_factor=cfg["capacity_factor"],
        aux_loss_weight=cfg["aux_loss_weight"],
        router_z_weight=cfg["router_z_weight"],
        attn_impl=cfg["attn_impl"], dtype=DTYPES[cfg["compute_dtype"]],
        param_dtype=DTYPES[traffic["param_dtype"]],
        remat=remat != "none", remat_policy="full" if remat == "none" else remat,
        scan_layers=bool(traffic["stack_layers"]),
        stack_layers=bool(traffic["stack_layers"]),
        tie_embeddings=cfg["tie_embeddings"],
        ce_impl=traffic.get("ce_impl", "chunked"),
    )


def build(cfg: dict, traffic: dict, device):
    from learning_at_home_tpu_torch.models.transformer import (
        DMoETransformerLM,
    )
    return DMoETransformerLM(program_config(cfg, traffic), device=device)


def reference(cfg: dict, precision: str = "f32") -> Model:
    return Model(cfg, precision)


def train_flops_per_token(cfg: dict) -> float:
    """Training FLOPs a token (forward and backward): the algorithmic count
    of the port's ``utils/sizing.py`` ``_model_flops_per_step``
    (bench.py's: three times the forward's matrix products, attention
    counted over all ``S`` keys, no remat recompute)."""
    d, s, v, n = cfg["d_model"], cfg["seq_len"], cfg["vocab_size"], cfg["n_layers"]
    f = cfg["expert_ffn_dim"]
    fwd = 2 * d * v + n * (8 * d * d + 4 * s * d + cfg["k"] * 4 * d * f)
    return 3.0 * fwd
