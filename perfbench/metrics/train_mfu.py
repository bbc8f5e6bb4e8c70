"""The training window's model FLOPs a second as a share of the card's
bf16 peak: every step's FLOPs (the frozen count of ``lib/flops.py``) over
the window's host-clock seconds."""

from perfbench.lib.flops import PEAK_FLOPS


def read(run: dict):
    if not run.get("train_flops"):
        return None
    return 100.0 * run["train_flops"] / run["window_s"] / PEAK_FLOPS
