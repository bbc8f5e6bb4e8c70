#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each of which asserts (none catches its own failure):

1. device   -- a CUDA card; prints its name and power limit (nvidia-smi).
2. build    -- compiles every kernel library of
               ``learning_at_home_tpu_torch/csrc`` for sm_90a into
               ``build/kernels/`` (one nvcc each, all at once) and prints
               ptxas's registers and spills.
3. kernels  -- each kernel against its plain PyTorch version on the card,
               at the main paths' shapes and at smaller ones, within the
               stated tolerances.
4. small    -- a tiny f32 model on the card against the same model on the
               CPU (the CPU path is the one the tests hold against the JAX
               package): logits and greedy tokens; then one train step of
               a tiny bf16 fused-CE model, the card running K1-K3 and the
               CPU their plain versions: loss and gradients.
5. serving  -- ``flagship-8k`` (the 256-expert DMoE-Transformer at
               seq_len 8192, random weights from a seed) serves 2 prompts
               of 4096 tokens with 32 greedy new tokens through
               ``generate(use_cache=True)``; the kernel counts must show
               the path went through the flash kernel; the prefill logits
               must match the same model with plain attention.
6. training -- ``flagship-train`` (the same model at seq_len 256 with the
               single-chip training recipe: bf16 params, remat "full",
               per-layer tuple layout, fused CE, fused Adafactor 1e-3,
               batch 176) takes one warm-up step and TRAIN_STEPS timed
               steps on one fixed batch through ``make_train_step``; the
               loss must be finite and fall, each CE kernel must launch
               once per step; the fused loss and embedding gradient must
               match the chunked CE's on one batch.
7. timings  -- CUDA-event medians of each kernel, its plain version and
               the PyTorch call computing the same function (SDPA for
               attention; for K1-K3, which no single call computes, the
               cuBLAS product ``x @ head`` of K1's shape as a yardstick).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card or
without the repository's package beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.ops import build
from learning_at_home_tpu_torch.ops import flash_attention as fa
from learning_at_home_tpu_torch.ops import fused_ce as fce
from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map

SEED = 0
# the 256-expert flagship of __graft_entry__.py at the sequence length
# where the attention rule picks the flash kernel
FLAGSHIP_8K = dict(
    vocab_size=32768, d_model=512, n_layers=4, n_heads=8, seq_len=8192,
    num_experts=256, k=2, capacity_factor=1.25, dtype=torch.bfloat16,
    param_dtype=torch.float32, attn_impl="auto",
)
# the same flagship with the single-chip training recipe of bench.py
# (bf16 params, remat "full", the unrolled per-layer tuple layout, the
# fused CE), trained with fused_adafactor(1e-3) at batch 176: 45,056
# tokens a step
FLAGSHIP_TRAIN = dict(
    vocab_size=32768, d_model=512, n_layers=4, n_heads=8, seq_len=256,
    num_experts=256, k=2, capacity_factor=1.25, dtype=torch.bfloat16,
    param_dtype=torch.bfloat16, attn_impl="auto", remat=True,
    remat_policy="full", scan_layers=False, stack_layers=False,
    ce_impl="fused",
)
TRAIN_BATCH = 176
TRAIN_STEPS = 5
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 kernel against the plain version computed in f32 from the same bf16
# inputs: the kernel rounds P and O to bf16 (2^-8 relative each), so
# |err| <= ATOL + RTOL * |ref| with ATOL = 4 * 2^-8 for |v| up to ~4
FLASH_ATOL, FLASH_RTOL = 1.6e-2, 8e-3
# flagship prefill logits, flash against plain attention, both bf16:
# logits have std ~1 and the two paths round attention differently in
# the last bf16 bit, which the residual stream carries through 4 layers
LOGITS_MAX_ABS, LOGITS_MEAN_ABS = 0.25, 5e-3
# K1-K3 against their plain versions computed in f32 from the same bf16
# inputs.  ce / lse: only the f32 summation order of the logits differs;
# the worst-case f32 bound d * 2^-24 * sum|x_k h_k| is ~4e-4 per logit at
# d = 512 with unit-scale x and N(0, 1/d) heads, so 1e-3.  dx / dhead: the
# kernels round dl to bf16 (2^-9 relative per term, summed over terms
# whose absolute sum is about twice the largest output) and round the
# output to bf16 (2^-9): |err| <= 2^-8 |ref| + 2^-7 max|ref|.
CE_ATOL = 1e-3
GRAD_RTOL, GRAD_ATOL_SCALE = 2.0 ** -8, 2.0 ** -7
# tiny bf16 model, card (kernels) against cpu (plain versions): the two
# devices round the bf16 trunk differently, and a near-tie in the gate can
# route a token elsewhere, so the check is normwise: loss within 1e-2
# relative, every gradient leaf at cosine >= 0.99 with the cpu's
SMALL_LOSS_RTOL, SMALL_GRAD_COSINE = 1e-2, 0.99
# flagship-train, fused against chunked CE on one batch: the kernels round
# dl to bf16 where the chunked CE keeps f32 logits end to end
FUSED_LOSS_ATOL, EMBED_GRAD_COSINE = 1e-3, 0.999


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int = 25, warmup: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def randn_bf16(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def check_flash(shape, gen) -> float:
    q, k, v = (randn_bf16(shape, gen) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref32 = fa.attention_reference(q.float(), k.float(), v.float())
    ref16 = fa.attention_reference(q, k, v).float()
    err = (out.float() - ref32).abs()
    bad = int((err > FLASH_ATOL + FLASH_RTOL * ref32.abs()).sum())
    max_err = float(err.max())
    print(f"flash_attn_fwd {list(shape)}: max|kernel - plain_f32| = {max_err:.3e}, "
          f"max|kernel - plain_bf16| = {float((out.float() - ref16).abs().max()):.3e}, "
          f"outside tolerance: {bad}")
    assert torch.isfinite(out).all(), "kernel output is not finite"
    assert bad == 0, f"flash_attn_fwd disagrees with its plain version at {shape}"
    return max_err


def ce_inputs(n, d, v, gen):
    """bf16 x [n, d] (unit scale, like the final layer norm's output), the
    tied head embed.T [d, v] with N(0, 1/d) entries, int32 targets (a few
    outside [0, V)), and dce = 1/n, the cotangent of the mean CE."""
    x = randn_bf16((n, d), gen)
    head = (torch.randn((v, d), generator=gen, device="cuda")
            * d ** -0.5).to(torch.bfloat16).t()
    tgt = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tgt[::997] = -1
    dce = torch.full((n,), 1.0 / n, device="cuda")
    return x, head, tgt, dce


def _grad_err(name, got, want) -> float:
    want = want.float()
    err = (got.float() - want).abs()
    limit = GRAD_RTOL * want.abs() + GRAD_ATOL_SCALE * float(want.abs().max())
    bad = int((err > limit).sum())
    assert torch.isfinite(got).all(), f"{name} output is not finite"
    assert bad == 0, f"{name}: {bad} elements outside tolerance"
    return float(err.max())


def check_fused_ce(shape, gen) -> dict:
    """K1-K3 on one shape against their plain versions; max |err| each."""
    n, d, v = shape
    x, head, tgt, dce = ce_inputs(n, d, v, gen)
    ce, lse = fce.ce_forward(x, head, tgt)
    dx = fce.ce_dx(x, head, tgt, lse, dce)
    dhead = fce.ce_dhead(x, head, tgt, lse, dce)
    torch.cuda.synchronize()
    want_ce, want_lse = fce.ce_fwd_reference(x, head, tgt)
    assert torch.isfinite(ce).all() and torch.isfinite(lse).all()
    err_fwd = max(float((ce - want_ce).abs().max()),
                  float((lse - want_lse).abs().max()))
    del want_ce, want_lse
    assert err_fwd <= CE_ATOL, f"fused_ce_fwd disagrees at {shape}: {err_fwd}"
    # the backward plain versions start from the kernel's lse, as K2/K3 do
    err_dx = _grad_err("fused_ce_dx", dx,
                       fce.ce_dx_reference(x, head, tgt, lse, dce))
    err_dhead = _grad_err("fused_ce_dhead", dhead,
                          fce.ce_dhead_reference(x, head, tgt, lse, dce))
    print(f"fused CE {list(shape)}: max|err| ce/lse {err_fwd:.3e}, "
          f"dx {err_dx:.3e} (max|dx| {float(dx.float().abs().max()):.3e}), "
          f"dhead {err_dhead:.3e} (max|dhead| "
          f"{float(dhead.float().abs().max()):.3e})")
    return {"fused_ce_fwd": err_fwd, "fused_ce_dx": err_dx,
            "fused_ce_dhead": err_dhead}


def small_reference() -> None:
    cfg = DMoETransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                                n_heads=4, seq_len=32, num_experts=4, k=2,
                                dtype=torch.float32)
    cpu = DMoETransformerLM(cfg, device="cpu")
    gpu = DMoETransformerLM(cfg, device="cuda")
    params = cpu.init_params(torch.Generator().manual_seed(SEED))
    params_gpu = tree_to(params, "cuda")
    ids = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(1))
    want = cpu.apply(params, ids)[0]
    got = gpu.apply(params_gpu, ids.cuda())[0].cpu()
    err = float((got - want).abs().max())
    print(f"tiny f32 model, card vs cpu: max|logits diff| = {err:.3e}")
    assert err < 1e-4, "the card's logits disagree with the CPU's"
    prompt = ids[:, :6].to(torch.int32)
    want_tok = cpu.generate(params, prompt, 8, use_cache=True)
    got_tok = gpu.generate(params_gpu, prompt.cuda(), 8, use_cache=True).cpu()
    assert torch.equal(want_tok, got_tok), "greedy tokens differ card vs cpu"


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    denom = float(a.norm() * b.norm())
    return 1.0 if denom == 0 else float(a @ b) / denom


def small_train_reference(counters) -> None:
    """One train step of a tiny bf16 fused-CE model: the card runs K1-K3,
    the CPU their plain versions."""
    cfg = DMoETransformerConfig(
        vocab_size=2048, d_model=128, n_layers=1, n_heads=4, seq_len=16,
        num_experts=4, k=2, dtype=torch.bfloat16, ce_impl="fused",
        remat=True, stack_layers=False, scan_layers=False)
    models = {dev: DMoETransformerLM(cfg, device=dev) for dev in ("cpu", "cuda")}
    params = models["cpu"].init_params(torch.Generator().manual_seed(SEED))
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 2048, (8, 16), generator=gen)
    tgt = torch.randint(0, 2048, (8, 16), generator=gen)
    out = {}
    for dev, model in models.items():
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        reset_counts(counters)
        (loss, _), grads = model.value_and_grad(p, ids.to(dev), tgt.to(dev))
        grads = tree_leaves(grads)
        step = model.make_train_step(fused_adafactor(1e-3))
        _, _, step_loss, _ = step(p, model.init_opt_state(fused_adafactor(1e-3), p),
                                  ids, tgt)
        out[dev] = (float(loss), [g.cpu() for g in grads], float(step_loss),
                    read_counts(counters))
    per_step = {"fused_ce_fwd": 2, "fused_ce_dx": 2, "fused_ce_dhead": 2}
    assert out["cpu"][3] == dict.fromkeys(counters, 0), out["cpu"][3]
    assert out["cuda"][3] == {**dict.fromkeys(counters, 0), **per_step}, \
        out["cuda"][3]
    l_cpu, l_gpu = out["cpu"][0], out["cuda"][0]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    step_rel = abs(out["cuda"][2] - out["cpu"][2]) / abs(out["cpu"][2])
    cosines = [cosine(a, b) for a, b in zip(out["cuda"][1], out["cpu"][1])]
    print(f"tiny bf16 fused-CE model, card vs cpu: loss {l_gpu:.5f} vs "
          f"{l_cpu:.5f} (rel {rel:.2e}); train-step loss rel {step_rel:.2e}; "
          f"min gradient cosine {min(cosines):.5f} over {len(cosines)} leaves")
    assert rel <= SMALL_LOSS_RTOL and step_rel <= SMALL_LOSS_RTOL, \
        "the card's loss disagrees with the CPU's"
    assert min(cosines) >= SMALL_GRAD_COSINE, "gradients differ card vs cpu"


def tree_to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def reset_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def timed(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_flagship(counters) -> dict:
    """Phase 5; returns the kernel counts of one generate."""
    cfg = DMoETransformerConfig(**FLAGSHIP_8K)
    model = DMoETransformerLM(cfg, device="cuda")
    assert model.cfg.attn_impl == "flash", model.cfg.attn_impl
    params = model.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch, prompt_len, new = 2, 4096, 32
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), dtype=torch.int32,
        device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
    )
    model.generate(params, prompts, 2, use_cache=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(counters)
    out, t_total = timed(
        lambda: model.generate(params, prompts, new, use_cache=True))
    launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"kernel launches in one generate: {launches}")
    assert launches["flash_attn_fwd"] == cfg.n_layers, launches
    assert out.shape == (batch, prompt_len + new) and out.dtype == torch.int32
    assert torch.equal(out[:, :prompt_len], prompts)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size

    prefill_s = statistics.median(
        timed(lambda: model.generate(params, prompts, 1, use_cache=True))[1]
        for _ in range(3))
    decode_ms = (t_total - prefill_s) / (new - 1) * 1e3
    print(f"params {n_params / 1e9:.3f} B; generate 2x{prompt_len} + {new}: "
          f"{t_total * 1e3:.1f} ms; prefill (+1 token) {prefill_s * 1e3:.1f} ms; "
          f"decode {decode_ms:.2f} ms/token; "
          f"{batch * new / t_total:.1f} new tokens/s; peak {peak_gb:.2f} GB")

    plain = DMoETransformerLM(dataclasses.replace(cfg, attn_impl="xla"),
                              device="cuda")
    logits_flash = model.apply(params, prompts)[0]
    logits_plain = plain.apply(params, prompts)[0]
    assert logits_flash.shape == (batch, prompt_len, cfg.vocab_size)
    assert torch.isfinite(logits_flash).all() and torch.isfinite(logits_plain).all()
    diff = (logits_flash - logits_plain).abs()
    lmax, lmean = float(diff.max()), float(diff.mean())
    argmax_same = float(
        (logits_flash.argmax(-1) == logits_plain.argmax(-1)).float().mean())
    del logits_flash, logits_plain, diff
    print(f"prefill logits flash vs plain attention: max|diff| {lmax:.4f}, "
          f"mean|diff| {lmean:.2e}, argmax agreement {argmax_same:.5f}")
    assert lmax <= LOGITS_MAX_ABS and lmean <= LOGITS_MEAN_ABS, (lmax, lmean)
    out_plain = plain.generate(params, prompts, new, use_cache=True)
    match = float((out_plain[:, prompt_len:] == out[:, prompt_len:]).float().mean())
    print(f"greedy token match, flash vs plain attention: {match:.4f}")
    return launches


def train_batch(cfg, batch: int, seed: int):
    """One fixed batch of random token ids and their next-token targets."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    seq = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len + 1),
                        dtype=torch.int32, device="cuda", generator=gen)
    return seq[:, :-1].contiguous(), seq[:, 1:].contiguous()


def build_flagship_train():
    """(model, params, optimizer, opt_state, step, ids, tgt) of
    ``flagship-train`` with random weights from SEED."""
    cfg = DMoETransformerConfig(**FLAGSHIP_TRAIN)
    model = DMoETransformerLM(cfg, device="cuda")
    assert model.cfg.attn_impl == "xla", model.cfg.attn_impl
    params = model.init_params(torch.Generator(device="cuda").manual_seed(SEED))
    optimizer = fused_adafactor(1e-3)
    opt_state = model.init_opt_state(optimizer, params)
    step = model.make_train_step(optimizer)
    ids, tgt = train_batch(cfg, TRAIN_BATCH, SEED + 2)
    return model, params, optimizer, opt_state, step, ids, tgt


def train_flagship(counters) -> dict:
    """Phase 6; returns the kernel counts of the TRAIN_STEPS timed steps."""
    model, params, _, opt_state, step, ids, tgt = build_flagship_train()
    cfg = model.cfg
    n_params = sum(t.numel() for t in tree_leaves(params))
    tokens = TRAIN_BATCH * cfg.seq_len
    (params, opt_state, loss0, metrics0), warm_s = timed(
        lambda: step(params, opt_state, ids, tgt))
    print(f"params {n_params / 1e9:.3f} B ({tree_leaves(params)[0].dtype}); "
          f"warm-up step {warm_s * 1e3:.1f} ms, loss {float(loss0):.5f}, "
          f"metrics {({k: round(float(v), 5) for k, v in metrics0.items()})}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        (params, opt_state, loss, metrics), dt = timed(
            lambda: step(params, opt_state, ids, tgt))
        step_ms.append(dt * 1e3)
        losses.append(float(loss))
    launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"kernel launches in {TRAIN_STEPS} train steps: {launches}")
    print(f"losses {[round(float(loss0), 5)] + [round(x, 5) for x in losses]}; "
          f"last metrics {({k: round(float(v), 5) for k, v in metrics.items()})}")
    med = statistics.median(step_ms)
    print(f"flagship-train step: median {med:.1f} ms (all {[round(t, 1) for t in step_ms]}), "
          f"{tokens / med * 1e3:.0f} tokens/s, peak {peak_gb:.2f} GB")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < float(loss0), "the loss did not fall on a fixed batch"
    for name in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dhead"):
        assert launches[name] == TRAIN_STEPS, launches
    assert launches["flash_attn_fwd"] == 0, launches

    # the fused CE against the chunked CE on the same batch and weights
    chunked = DMoETransformerLM(dataclasses.replace(cfg, ce_impl="chunked"),
                                device="cuda")
    (l_fused, _), grads = model.value_and_grad(params, ids, tgt)
    e_fused = grads["embed"].float()
    del grads
    (l_chunk, _), grads = chunked.value_and_grad(params, ids, tgt)
    e_chunk = grads["embed"].float()
    del grads
    cos = cosine(e_fused, e_chunk)
    dloss = abs(float(l_fused) - float(l_chunk))
    print(f"fused vs chunked CE: loss {float(l_fused):.6f} vs "
          f"{float(l_chunk):.6f} (|diff| {dloss:.2e}); embedding-gradient "
          f"cosine {cos:.6f}")
    assert dloss <= FUSED_LOSS_ATOL and cos >= EMBED_GRAD_COSINE
    return {"launches": launches, "step_ms": med, "tokens_per_s": tokens / med * 1e3,
            "peak_gb": peak_gb}


def time_fused_ce(shape, gen, launches, errs) -> list[dict]:
    """Phase 7 for K1-K3: kernel, plain version, cuBLAS yardstick, bound."""
    n, d, v = shape
    x, head, tgt, dce = ce_inputs(n, d, v, gen)
    _, lse = fce.ce_forward(x, head, tgt)
    yard_ms = median_ms(lambda: torch.matmul(x, head))
    rows = 4 * n  # targets read, ce / lse written or lse / dce read (4 bytes)
    fwd_bytes = 2 * n * d + 2 * d * v + rows + 2 * 4 * n
    cases = [
        ("fused_ce_fwd", "learning_at_home_tpu/ops/fused_ce.py:58",
         lambda: fce.ce_forward(x, head, tgt),
         lambda: fce.ce_fwd_reference(x, head, tgt),
         2 * n * d * v, fwd_bytes),
        ("fused_ce_dx", "learning_at_home_tpu/ops/fused_ce.py:96",
         lambda: fce.ce_dx(x, head, tgt, lse, dce),
         lambda: fce.ce_dx_reference(x, head, tgt, lse, dce),
         4 * n * d * v, 2 * n * d + 2 * d * v + 3 * rows + 2 * n * d),
        ("fused_ce_dhead", "learning_at_home_tpu/ops/fused_ce.py:124",
         lambda: fce.ce_dhead(x, head, tgt, lse, dce),
         lambda: fce.ce_dhead_reference(x, head, tgt, lse, dce),
         4 * n * d * v, 2 * n * d + 2 * d * v + 3 * rows + 2 * d * v),
    ]
    out = []
    for name, replaces, kernel, plain, flops, nbytes in cases:
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, reps=5, warmup=1)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"{name} {list(shape)}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms, cuBLAS x@head "
              f"{yard_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        out.append({
            "name": name,
            "route": "cuda",
            "source": "learning_at_home_tpu_torch/csrc/fused_ce.cu",
            "replaces": replaces,
            "launches": launches[name],
            "launches_per_step": launches[name] / TRAIN_STEPS,
            "shape": [n, d, v],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "yardstick": "torch.matmul(x, head) bf16 (cuBLAS), K1's product",
            "yardstick_ms": yard_ms,
        })
    return out


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {"flash_attn_fwd": fa.flash_attention,
                "fused_ce_fwd": fce.ce_forward, "fused_ce_dx": fce.ce_dx,
                "fused_ce_dhead": fce.ce_dhead}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    phase("build")
    t0 = time.perf_counter()
    build.build_all()
    print(f"built {sorted(build.LIBRARIES)} in {time.perf_counter() - t0:.1f} s")
    for name, report in build.build_reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase("kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    main_shape = (2, 4096, 8, 64)  # [B,S,H,hd] of one prefill layer
    flash_err = check_flash(main_shape, gen)
    for shape in [(1, 1000, 8, 64), (3, 70, 2, 64), (1, 1, 1, 64)]:
        check_flash(shape, gen)
    # [n, d, V] of flagship-train's CE: 176 x 256 tokens
    ce_shape = (TRAIN_BATCH * FLAGSHIP_TRAIN["seq_len"],
                FLAGSHIP_TRAIN["d_model"], FLAGSHIP_TRAIN["vocab_size"])
    ce_errs = check_fused_ce(ce_shape, gen)
    for shape in [(1024, 128, 2048), (384, 384, 4096)]:
        check_fused_ce(shape, gen)
    torch.cuda.empty_cache()

    phase("small models: card against cpu")
    small_reference()
    small_train_reference(counters)

    phase("serving flagship-8k")
    serve_launches = serve_flagship(counters)
    torch.cuda.empty_cache()

    phase("training flagship-train")
    train = train_flagship(counters)
    torch.cuda.empty_cache()

    phase("timings")
    b, s, h, hd = main_shape
    q, k, v = (randn_bf16(main_shape, gen) for _ in range(3))
    ms = median_ms(lambda: fa.flash_attention(q, k, v))
    plain_ms = median_ms(lambda: fa.attention_reference(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4 * b * h * hd * s * (s + 1) / 2  # causal pairs only
    nbytes = 4 * b * s * h * hd * 2  # q, k, v read once, o written once
    bound_ms, bound_by = bound(flops, nbytes)
    del q, k, v, qt, kt, vt
    kernels = [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "learning_at_home_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "learning_at_home_tpu/models/trunk.py:73",
        "launches": serve_launches["flash_attn_fwd"],
        "launches_per_generate": serve_launches["flash_attn_fwd"],
        "shape": list(main_shape),
        "max_abs_err": flash_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    print(f"flash_attn_fwd {list(main_shape)}: {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms")
    kernels += time_fused_ce(ce_shape, gen, train["launches"], ce_errs)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
