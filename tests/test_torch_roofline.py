"""The port's roofline (``tools/roofline.py``) against the JAX tool's.

- With the port's card constants set to the JAX tool's (819 GB/s, 197
  bf16 TFLOP/s) and ``--step-ms`` set to the JAX tool's anchor (batch
  176 x seq 256 at 165040 tokens/s), its stdout equals the JAX tool's,
  line for line (tolerance: none, the same text).
- On the card's own constants, each verdict follows its own numbers:
  the step is called param-bandwidth-bound exactly when the printed
  param-traffic share is at least one half, and accum>1 net negative
  exactly when the printed accum RMW ms exceeds the printed optimizer
  saving (the measured step flips the first; an optimizer with a larger
  state, patched in, flips the second).
- With a card present, its ``torch.cuda.get_device_name()`` picks the
  constants; without one they are the H100's.
- No port module carries a TPU constant or a TPU-measured number.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from learning_at_home_tpu_torch.tools import roofline
from learning_at_home_tpu_torch.tree import tree_leaves
from learning_at_home_tpu_torch.utils import sizing

REPO = Path(__file__).resolve().parents[1]
V5E_HBM_BPS = 819e9
V5E_PEAK_BF16 = 197e12
TPU_ANCHOR_MS = 176 * 256 / 165040.0 * 1e3
TPU_NUMBERS = re.compile(r"819e9|819 GB/s|197e12|165040|165,040|16e9|"
                         r"\b273(\.0)? ?ms\b|TPU_PEAK|TPU_HBM|BASELINE_TPS")


def jax_roofline_lines(capsys) -> list:
    spec = importlib.util.spec_from_file_location(
        "jax_tools_roofline", REPO / "tools" / "roofline.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.splitlines()


def port_lines(capsys, argv) -> list:
    capsys.readouterr()
    roofline.main(argv)
    return capsys.readouterr().out.splitlines()


def test_v5e_constants_print_the_jax_tools_lines(monkeypatch, capsys):
    want = jax_roofline_lines(capsys)
    monkeypatch.setitem(sizing.CARD_HBM_BPS, sizing.H100, V5E_HBM_BPS)
    monkeypatch.setitem(sizing.CARD_PEAK_BF16, sizing.H100, V5E_PEAK_BF16)
    got = port_lines(capsys, ["--step-ms", repr(TPU_ANCHOR_MS)])
    assert len(want) == 12
    assert got == want


def numbers(lines) -> dict:
    text = "\n".join(lines)
    share = float(re.search(r"share of the step: ([0-9.]+)%", text)[1])
    rmw, saving = map(float, re.search(
        r"RMW \(([0-9.]+) ms/micro\) .* saving \(([0-9.]+) ms/step\)",
        text).groups())
    return {"share": share / 100, "rmw": rmw, "saving": saving,
            "bound": "the step is param-bandwidth-bound" in text,
            "not_bound": "the step is NOT param-bandwidth-bound" in text,
            "negative": "predicted NET NEGATIVE" in text,
            "positive": "predicted NET POSITIVE" in text}


class TwoMoments:
    """An optimizer whose state is two f32 moments a param, as Adam's: it
    outweighs the f32 accum buffer, so the accum RMW costs less than the
    optimizer pass it amortizes."""

    def init(self, params):
        return [torch.empty(p.shape, dtype=torch.float32, device="meta")
                for p in tree_leaves(params) for _ in range(2)]


@pytest.mark.parametrize("step_ms,bound,negative", [
    (445.2, False, True),  # the share is small: NOT
    (275.0, False, True),
    (15.0, True, True),  # a step near the traffic floor
    (275.0, False, False),  # a larger optimizer state: NET POSITIVE
    (12.0, True, False),
])
def test_verdicts_follow_their_own_numbers(monkeypatch, capsys, step_ms,
                                           bound, negative):
    if not negative:
        monkeypatch.setattr(roofline, "fused_adafactor",
                            lambda lr: TwoMoments())
    lines = port_lines(capsys, ["--step-ms", str(step_ms)])
    n = numbers(lines)
    assert f"measured {step_ms:g} ms" in lines[-3]
    assert "@ 3350 GB/s" in lines[4]
    assert n["bound"] == (n["share"] >= 0.5) == bound
    assert n["not_bound"] == (not bound)
    assert n["negative"] == (n["rmw"] > n["saving"]) == negative
    assert n["positive"] == (not negative)


def test_the_batch_is_a_flag_and_the_card_is_read(monkeypatch, capsys):
    lines = port_lines(capsys, ["--step-ms", "100", "--batch", "88"])
    assert "(batch 88)" in lines[1] and lines[-2].endswith("at batch 88")
    with pytest.raises(SystemExit):  # the anchor is a card measurement
        roofline.main([])
    # with a card present its own name picks the constants
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda: "NVIDIA A100")
    with pytest.raises(SystemExit, match="no constants for 'NVIDIA A100'"):
        roofline.main(["--step-ms", "100"])
    monkeypatch.setitem(sizing.CARD_PEAK_BF16, "NVIDIA A100", 312e12)
    monkeypatch.setitem(sizing.CARD_HBM_BPS, "NVIDIA A100", 2.0e12)
    lines = port_lines(capsys, ["--step-ms", "100"])
    assert "@ 2000 GB/s" in lines[4]


def test_no_port_module_carries_a_tpu_number():
    paths = [*(REPO / "learning_at_home_tpu_torch").rglob("*.py"),
             REPO / "chip_smoke.py", REPO / "profile_training.py",
             REPO / "profile_serving.py"]
    found = {str(path.relative_to(REPO)): TPU_NUMBERS.findall(path.read_text())
             for path in paths}
    assert len(found) > 100
    assert not {path: hits for path, hits in found.items() if hits}
