"""The harness's generic files name no model family: whatever is the
DMoE's lives in ``families/dmoe.py`` and ``reference/dmoe.py``, so a new
family comes as new files alone."""

import pytest

from perfbench.lib import spec

GENERIC = ["lib/train.py", "lib/weights.py", "lib/flops.py",
           "lib/adafactor_state.py", "lib/trace.py", "reference/run.py",
           "control.py", "run.py"]
DMOE_NAMES = ["DMoETransformer", "reference.dmoe", "expert_ffn_dim", '"moe"',
              '"wq"', '"pos"', '"dmoe/"']


@pytest.mark.parametrize("name", GENERIC)
def test_generic_file_names_no_family(name):
    text = (spec.ROOT / name).read_text()
    found = [n for n in DMOE_NAMES if n in text]
    assert not found, found
    assert "dmoe" not in text.lower()
