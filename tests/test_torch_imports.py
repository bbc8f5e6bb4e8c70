"""The port and its chip smoke script import neither JAX nor the JAX
package, nor the JAX repo's ``bench.py`` or ``__graft_entry__.py``
(the port keeps its own copies of their sizing).  Checked on the source (an AST scan): the interpreter that runs
the tests has JAX loaded already, so ``sys.modules`` would prove nothing.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "learning_at_home_tpu", "bench",
             "__graft_entry__")
PORT_FILES = sorted((REPO / "learning_at_home_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "profile_serving.py",
    REPO / "profile_training.py",
]


def forbidden(module: str) -> bool:
    """``module`` is one of FORBIDDEN or inside one; the port's own name
    only shares a prefix with the JAX package's."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_the_scan_tells_the_port_from_the_jax_package():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("learning_at_home_tpu.models.trunk")
    assert not forbidden("learning_at_home_tpu_torch.models.trunk")
    assert not forbidden("jaxtyping")
    src = ("import importlib, os.path\nimportlib.import_module('optax')\n"
           "from flax import linen\nimport learning_at_home_tpu_torch.ops\n")
    found = sorted(m for m in imported_modules(src) if forbidden(m))
    assert found == ["flax", "optax"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    assert path.exists()
    bad = [m for m in imported_modules(path.read_text()) if forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
