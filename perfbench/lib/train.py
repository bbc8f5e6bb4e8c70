"""The training traffic: the port's pod-mode train step, closed loop.

Set-up builds one train step (the model family's port model, its
``make_train_step`` with the fused Adafactor) over weights drawn from the
seed, and a pool of seeded batches on the device.  The first
``checked_steps`` steps go through the same step and feed as the window,
on batches that all differ; their losses, the first gradient's norms
(from the optimizer's state) and the parameters' change after them are
kept for the check.  Then ``warmup_steps`` more, and the window: step
after step, each ending in a synchronise, until ``seconds`` have passed.
A traced run then profiles ``traced_steps`` more steps with autograd's
device threads off, so that the backward's kernels fall in the program's
``backward`` range (under the family's ``RANGE_PREFIX``).  Once the
program is freed, the reference takes the checked steps on the same
weights and batches.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from perfbench.lib import adafactor_state, check, weights
from perfbench.lib.flops import train_flops_per_step
from perfbench.lib.trace import WINDOW, summarize
from perfbench.reference.precision import DTYPES
from perfbench.reference.run import train_readings

def token_pool(cfg: dict, n: int, rows: int, length: int, seed: int, device):
    """[n, rows, length] int32 token ids drawn from the seed on ``device``."""
    gen = torch.Generator(device=device).manual_seed(weights.input_seed(seed))
    return torch.randint(0, cfg["vocab_size"], (n, rows, length),
                         dtype=torch.int32, device=device, generator=gen)


class Program:
    """The system under test of a cell: model, parameters, optimizer
    state, step."""

    def __init__(self, cell, seed: int, device):
        from learning_at_home_tpu_torch.ops.fused_adafactor import (
            fused_adafactor,
        )
        cfg, traffic = cell.config, cell.traffic
        if traffic["optimizer"] != "fused_adafactor":
            raise ValueError(f"unknown optimizer {traffic['optimizer']!r}")
        self.family, self.cfg, self.traffic = cell.family, cfg, traffic
        self.seed, self.device = seed, device
        self.specs = self.family.leaf_specs(cfg)
        self.model = self.family.build(cfg, traffic, device)
        self.dtype = DTYPES[traffic["param_dtype"]]
        self.params = weights.make_params(self.family, cfg, seed, self.dtype,
                                          device, stacked=traffic["stack_layers"])
        opt = fused_adafactor(traffic["learning_rate"])
        self.state = self.model.init_opt_state(opt, self.params)
        self.step_fn = self.model.make_train_step(opt)
        pool = token_pool(cfg, traffic["pool_batches"], traffic["batch"],
                          cfg["seq_len"] + 1, seed, device)
        self.ids = pool[..., :-1].contiguous()
        self.tgt = pool[..., 1:].contiguous()
        self.steps = 0

    def step(self) -> torch.Tensor:
        """One step on the pool's next batch; its loss."""
        i = self.steps % self.ids.shape[0]
        self.params, self.state, loss, _ = self.step_fn(
            self.params, self.state, self.ids[i], self.tgt[i])
        self.steps += 1
        return loss

    def checked_steps(self) -> dict:
        """Take the checked steps; their readings."""
        losses, grad_norms = [], None
        for _ in range(self.traffic["checked_steps"]):
            losses.append(self.step())
            if grad_norms is None:
                grad_norms = adafactor_state.first_grad_norms(
                    self.state, self.specs, self.dtype)
        changes = []
        for index, (path, *_) in enumerate(self.specs):
            start = weights.draw_leaf(self.specs, index, self.seed, self.dtype,
                                      self.device)
            changes.append(check.change_norm(
                weights.get_leaf(self.params, path), start))
            del start
        return {"losses": [float(x) for x in losses],
                "grad_norms": grad_norms, "changes": changes}

    def checked_batches(self):
        n = self.traffic["checked_steps"]
        return self.ids[:n].clone(), self.tgt[:n].clone()


def p90(values: list) -> float:
    """The 90th percentile (``statistics.quantiles``' exclusive method);
    of a single value, that value."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10)[-1]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        program_cls=Program) -> dict:
    """One run of a training cell: the result's fields and the numbers
    the metrics read."""
    cfg, traffic = cell.config, cell.traffic
    parts = {"imports": time.perf_counter() - t0}
    prog = program_cls(cell, seed, device)
    sync(device)
    parts["build"] = time.perf_counter() - t0 - sum(parts.values())
    readings = prog.checked_steps()
    batches = prog.checked_batches()
    parts["checked_steps"] = time.perf_counter() - t0 - sum(parts.values())
    for _ in range(traffic["warmup_steps"]):
        prog.step()
    sync(device)
    setup_s = time.perf_counter() - t0
    parts["warmup"] = setup_s - sum(parts.values())
    cuda = torch.device(device).type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    step_s, losses = [], []
    start = time.perf_counter()
    deadline = start + seconds
    end = start
    while end < deadline:
        a = time.perf_counter()
        losses.append(prog.step())
        sync(device)
        end = time.perf_counter()
        step_s.append(end - a)
    window_s = end - start
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    tokens = len(step_s) * traffic["batch"] * cfg["seq_len"]
    finite = torch.isfinite(torch.stack(losses).float())
    failed = int((~finite).sum())
    out = {
        "attempted": len(step_s), "failed": failed, "setup_s": setup_s,
        "setup_parts": parts,
        "train_tokens_per_s": tokens / window_s,
        "train_step_ms_p90": p90([s * 1e3 for s in step_s]),
        "window_s": window_s, "steps": len(step_s), "tokens": tokens,
        "peak_window_bytes": peak_window,
        "memory_peak_bytes": max(peak_setup, peak_window),
        "train_flops": train_flops_per_step(cell.family, cfg, traffic["batch"])
        * len(step_s),
    }
    if trace:
        out["trace"] = traced(prog, traffic["traced_steps"], device)
    del prog, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = train_readings(cell.family, cfg, traffic, seed, *batches, device)
    out["numbers"] = check.train_gaps(readings, ref)
    return out


def traced(prog, n: int, device):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with torch.autograd.set_multithreading_enabled(False):
        with profile(activities=acts) as p:
            with record_function(WINDOW):
                for _ in range(n):
                    prog.step()
                sync(device)
    return summarize(p, n, prog.family.RANGE_PREFIX)
