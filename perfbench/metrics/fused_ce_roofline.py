"""The fused CE kernels' share of their roofline in the traced steps:
the sum of each K1, K2 and K3 launch's bound (``lib/flops.py``) over the
sum of their device time.  A step launches K1 once and the backward
kernel twice (K2 then K3)."""

from perfbench.lib import flops


def read(run: dict):
    trace = run.get("trace")
    if trace is None:
        return None
    cfg, traffic = run["cell"].config, run["cell"].traffic
    n, d, v = traffic["batch"] * cfg["seq_len"], cfg["d_model"], cfg["vocab_size"]
    fwd_s, fwd_n = trace.kernel_s(r"fused_ce_fwd_kernel")
    bwd_s, bwd_n = trace.kernel_s(r"fused_ce_bwd_kernel")
    steps = trace.per
    if fwd_n != steps or bwd_n != 2 * steps:
        return None
    bound = steps * sum(flops.bound_s(*flops.fused_ce(m, n, d, v))
                        for m in ("fwd", "dx", "dhead"))
    return 100.0 * bound / (fwd_s + bwd_s)
