"""The port's wire-schema extractor (``learning_at_home_tpu_torch/
analysis/schema.py``, the JAX module's text with the package renamed)
over the port tree against the JAX extractor over the JAX package, on
the CPU.

The port's operator tools live inside its package (``tools/``), so the
JAX side is the package plus the JAX repo's twins of those tools.  The
two IRs are equal modulo the root: every handler (family, module, op)
with its accepted fields, kinds and types, every sender site with its
fields, every gate candidate, nothing unresolved.  The differences are
named: the port's experiment drivers sit inside its package, so
``experiments/train_lm.py``'s ``stats`` RPC is a sender site there and
not in the JAX package; and the port's pre-test gate reads its smokes'
server processes' card peak bytes through one ``stats`` RPC, which the
JAX gate (on the CPU only) does not send.
"""

import collections
import os

import pytest

from learning_at_home_tpu.analysis import lint as jax_lint
from learning_at_home_tpu.analysis import schema as jax_schema
from learning_at_home_tpu_torch.analysis import lint as port_lint
from learning_at_home_tpu_torch.analysis import schema as port_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "learning_at_home_tpu")
PORT = os.path.join(REPO, "learning_at_home_tpu_torch")
TOOLS = ["lah_lint", "lah_verify", "lah_fuzz", "lah_rebalance", "lah_top",
         "collect_gate"]
PORT_ONLY_SENDERS = {("experiments/train_lm.py", "stats", ()): 1,
                     ("tools/collect_gate.py", "stats", ()): 1}


def _rel(path: str) -> str:
    for root in (PORT, JAX_PKG, REPO):
        if path.startswith(root + os.sep):
            return os.path.relpath(path, root)
    raise AssertionError(path)


def _norm(ir) -> dict:
    handlers = {}
    for h in ir.handlers:
        for op in h.ops:
            handlers[(h.family, _rel(h.path), op)] = sorted(
                (n, f.kind, f.types) for n, f in h.accepted(op).items())
    senders = collections.Counter(
        (_rel(s.path), s.op,
         tuple(sorted((n, f.kind, f.gate) for n, f in s.fields.items())))
        for s in ir.senders)
    gates = collections.Counter((_rel(c.path), c.what, c.detail)
                                for c in ir.gate_candidates)
    return {"handlers": handlers, "senders": senders, "gates": gates,
            "unresolved": ir.unresolved}


@pytest.fixture(scope="module")
def irs():
    jax_paths = [JAX_PKG] + [os.path.join(REPO, "tools", f"{t}.py")
                             for t in TOOLS]
    return _norm(jax_schema.extract(jax_paths)), _norm(
        port_schema.extract([PORT]))


def test_schema_module_is_the_jax_modules_text():
    original = open(os.path.join(JAX_PKG, "analysis", "schema.py")).read()
    copy = open(os.path.join(PORT, "analysis", "schema.py")).read()
    assert copy == original.replace("learning_at_home_tpu.",
                                    "learning_at_home_tpu_torch.")


def test_handlers_are_the_jax_packages(irs):
    jax, port = irs
    assert len(port["handlers"]) == 20
    assert port["handlers"] == jax["handlers"]
    families = {family for family, _, _ in port["handlers"]}
    assert families == {"expert", "gateway", "averaging", "dht"}


def test_senders_differ_only_by_the_named_site(irs):
    jax, port = irs
    assert port["senders"] - jax["senders"] == collections.Counter(
        PORT_ONLY_SENDERS)
    assert jax["senders"] - port["senders"] == collections.Counter()
    tools = {path for path, _, _ in port["senders"]
             if path.startswith("tools/")}
    assert tools == {"tools/lah_rebalance.py", "tools/collect_gate.py"}


def test_gate_candidates_and_unresolved_are_the_jax_packages(irs):
    jax, port = irs
    assert port["gates"] == jax["gates"]
    assert port["unresolved"] == jax["unresolved"] == []


def test_coverage_report_is_the_jax_packages():
    """Per documented op: the families that handle it, whether a handler
    exists and its sender sites, against each package's own PROTOCOL.md
    op table (the port's copy has the repo's rows)."""
    jax_ops = jax_lint._doc_corpus(os.path.join(REPO, "docs"))["ops"]
    port_ops = port_lint._doc_corpus(os.path.join(PORT, "docs"))["ops"]
    assert port_ops == jax_ops
    jax = jax_schema.coverage_report(
        [JAX_PKG] + [os.path.join(REPO, "tools", f"{t}.py") for t in TOOLS],
        jax_ops)
    port = port_schema.coverage_report([PORT], port_ops)
    assert port["missing_handler"] == jax["missing_handler"] == []
    assert port["senderless"] == jax["senderless"]
    assert port["unresolved"] == jax["unresolved"]
    assert port["ops"].keys() == jax["ops"].keys()
    for op, row in port["ops"].items():
        extra = sum(n for (_, o, _), n in PORT_ONLY_SENDERS.items()
                    if o == op)
        assert row == {**jax["ops"][op],
                       "sender_sites": jax["ops"][op]["sender_sites"]
                       + extra}, op
