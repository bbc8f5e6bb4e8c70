"""The flash-attention kernels' share of their roofline in the traced
steps: the sum of each K5 fwd, dkv and dq launch's bound (``lib/flops.py``,
causal pairs) over the sum of their device time.  Under remat a step
launches the forward twice a layer, dkv and dq once."""

from perfbench.lib import flops


def read(run: dict):
    trace = run.get("trace")
    if trace is None:
        return None
    cfg, traffic = run["cell"].config, run["cell"].traffic
    shape = (traffic["batch"], cfg["seq_len"], cfg["n_heads"], cfg["head_dim"])
    total_s, bound = 0.0, 0.0
    for mode, pattern in (("fwd", r"flash_attn_fwd_kernel"),
                          ("dkv", r"flash_attn_bwd_dkv_kernel"),
                          ("dq", r"flash_attn_bwd_dq_kernel")):
        s, n = trace.kernel_s(pattern)
        if n == 0:
            return None
        total_s += s
        bound += n * flops.bound_s(*flops.flash_attn(mode, *shape))
    return 100.0 * bound / total_s
