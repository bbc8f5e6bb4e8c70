"""Nothing under perfbench/ imports JAX, the JAX package or the repo's
scripts; the reference imports nothing of the port.  Top-level names (the
part before the first dot) are compared whole: the port's name begins with
the JAX package's."""

import ast

import pytest

from perfbench.lib import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "learning_at_home_tpu", "bench",
             "chip_smoke", "profile_training", "profile_serving",
             "__graft_entry__"}
SOURCES = sorted(spec.ROOT.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_forbidden_import(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(spec.ROOT).parts:
        assert "learning_at_home_tpu_torch" not in names
        assert not any(n.startswith("perfbench") for n in names) or all(
            n == "perfbench" for n in names if n.startswith("perfbench"))


def test_the_scan_sees_whole_names():
    assert "learning_at_home_tpu_torch" not in FORBIDDEN
    assert len(SOURCES) > 10
