"""The port's lah-lint (``learning_at_home_tpu_torch/analysis/lint.py``,
``tools/lah_lint.py``) against the JAX package's, on the CPU.

- ``analysis/lint.py`` is the JAX module's text with the package renamed
  in imports and the docstring's "lints clean" line naming the port.
- Every snippet of ``tests/lint_corpus/`` (each rule's bad and good one,
  and the suppressed one) gives the JAX lint's findings: rule, line,
  column, message and suppression; through the CLIs too.
- The R12-R15 written-reason contract, mirrored from the JAX tests.
- The port package lints clean through its CLI, and every finding it
  baselines carries a written reason.
- The port's spec docs (``learning_at_home_tpu_torch/docs/``) are the
  repo's ``docs/`` with lines added, never changed or dropped; the added
  lines are listed here.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from learning_at_home_tpu.analysis import lint as jax_lint
from learning_at_home_tpu_torch.analysis import lint as port_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "lint_corpus")
PORT = os.path.join(REPO, "learning_at_home_tpu_torch")
SNIPPETS = sorted(f for f in os.listdir(CORPUS) if f.endswith(".py"))


def _findings(lint, paths) -> list:
    return [(f.path, f.line, f.col, f.rule, f.message, f.suppressed)
            for f in lint.lint_paths(paths)]


def test_lint_module_is_the_jax_modules_text():
    original = open(os.path.join(REPO, "learning_at_home_tpu", "analysis",
                                 "lint.py")).read()
    copy = open(os.path.join(PORT, "analysis", "lint.py")).read()
    want = original.replace("learning_at_home_tpu.",
                            "learning_at_home_tpu_torch.").replace(
        "clean: ``python tools/lah_lint.py learning_at_home_tpu/`` exits 0.",
        "clean: ``python -m learning_at_home_tpu_torch.tools.lah_lint`` "
        "exits 0.")
    assert copy == want
    assert port_lint.RULES == jax_lint.RULES


@pytest.mark.parametrize("snippet", SNIPPETS)
def test_corpus_findings_are_the_jax_lints(snippet):
    path = os.path.join(CORPUS, snippet)
    want = _findings(jax_lint, [path])
    assert _findings(port_lint, [path]) == want
    rule = snippet.split("_", 1)[0].upper()
    if snippet.endswith("_bad.py"):
        assert rule in {f[3] for f in want if not f[5]}
    elif snippet.endswith("_good.py"):
        assert rule not in {f[3] for f in want if not f[5]}


def _cli(args, module=None):
    cmd = ([sys.executable, "-m", module] if module else
           [sys.executable, os.path.join(REPO, "tools", "lah_lint.py")])
    return subprocess.run(cmd + args, capture_output=True, text=True,
                          timeout=120, cwd=REPO)


def test_cli_over_the_corpus_reports_the_jax_clis_findings():
    port = _cli(["--json", CORPUS],
                module="learning_at_home_tpu_torch.tools.lah_lint")
    jax = _cli(["--json", CORPUS])
    assert port.returncode == jax.returncode == 1, port.stderr + jax.stderr
    got, want = json.loads(port.stdout), json.loads(jax.stdout)
    assert got == want and any(not f["suppressed"] for f in got)


def test_port_package_lints_clean_through_the_cli():
    r = _cli([], module="learning_at_home_tpu_torch.tools.lah_lint")
    assert r.returncode == 0, r.stdout + r.stderr
    assert re.search(r"lah-lint: 0 finding\(s\), \d+ suppressed", r.stdout)


def _reason(lines: list, line: int) -> str:
    """The written reason of the suppression that baselines the finding
    on 1-based ``line``: the text after the marker's bracket, else the
    comment block the marker sits in or, for a bare marker trailing a
    line of a statement, the comment block just above the statement."""
    marker = re.compile(r".*lah-lint: ignore\[[^]]*\]")
    i = line - 1
    while "lah-lint: ignore[" not in lines[i]:
        i -= 1
        assert i >= 0 and lines[i].strip().startswith("#"), line
    after = marker.sub("", lines[i]).strip()
    if after:
        return after
    if not lines[i].strip().startswith("#"):  # bare, trailing a code line
        while i > 0 and not lines[i].strip().startswith("#") \
                and line - i < 8:
            i -= 1
    lo = hi = i
    while lo > 0 and lines[lo - 1].strip().startswith("#"):
        lo -= 1
    while hi + 1 < len(lines) and lines[hi + 1].strip().startswith("#"):
        hi += 1
    return " ".join(marker.sub("", lines[j]).strip().lstrip("#")
                    for j in range(lo, hi + 1)).strip()


@pytest.fixture(scope="module")
def port_findings():
    return port_lint.lint_paths([PORT])


def test_every_port_suppression_carries_a_written_reason(port_findings):
    suppressed = [f for f in port_findings if f.suppressed]
    assert suppressed
    assert not [f for f in port_findings if not f.suppressed]
    for f in suppressed:
        with open(f.path) as fh:
            lines = fh.read().splitlines()
        reason = _reason(lines, f.line)
        assert len(reason.split()) >= 3, (f.path, f.line, f.rule, reason)


def test_the_repaired_findings_stay_repaired(port_findings):
    """The port's findings that its docs and repairs removed: three R6,
    six R9 and one R10.  The two R6 kept as baselines carry the JAX
    package's reasons; the churn script's handler now logs."""
    by_site = {(os.path.relpath(f.path, PORT), f.rule): f
               for f in port_findings}
    for site in (("server/server.py", "R6"), ("native/__init__.py", "R6")):
        assert by_site[site].suppressed
    assert ("experiments/churn_experiment.py", "R6") not in by_site
    assert not any(rule in ("R9", "R10") and not f.suppressed
                   for (_, rule), f in by_site.items())


# ---- the R12-R15 written-reason contract (mirrored) ----

SENDER = (
    "class _Handler:\n"
    "    def _dispatch(self, payload, rid=None):\n"
    "        msg_type, tensors, meta = unpack_message(payload)\n"
    "        if msg_type == 'forward':\n"
    "            return meta.get('uid')\n"
    "        return None\n"
    "\n"
    "\n"
    "async def send(pool, tensors):\n"
    "    return await pool.rpc(\n"
    "        'forward', tensors,\n"
    "        {'uid': 'e',\n"
    "         'bogus': 1}}  # MARKER\n"
)


def _r12(lint, path) -> list:
    return [f for f in lint.lint_paths([str(path)]) if f.rule == "R12"]


def test_wire_rules_require_written_reason(tmp_path):
    bare = tmp_path / "bare.py"
    bare.write_text(
        SENDER.replace("}}  # MARKER", "},  # lah-lint: ignore[R12]\n    )"))
    reasoned = tmp_path / "reasoned.py"
    reasoned.write_text(SENDER.replace(
        "}}  # MARKER",
        "},  # lah-lint: ignore[R12] diagnostic tag, receiver ignores it\n"
        "    )"))
    for lint in (port_lint, jax_lint):
        (f,) = _r12(lint, bare)
        assert not f.suppressed and "no written reason" in f.message
        (f,) = _r12(lint, reasoned)
        assert f.suppressed
    assert _findings(port_lint, [str(bare), str(reasoned)]) == _findings(
        jax_lint, [str(bare), str(reasoned)])


def test_wire_rules_block_comment_reason_counts(tmp_path):
    path = tmp_path / "block.py"
    path.write_text(SENDER.replace(
        "         'bogus': 1}}  # MARKER\n",
        "         # diagnostic tag: the receiver deliberately ignores\n"
        "         # this field, it only feeds sender-side logs\n"
        "         # lah-lint: ignore[R12]\n"
        "         'bogus': 1},\n"
        "    )\n"))
    for lint in (port_lint, jax_lint):
        (f,) = _r12(lint, path)
        assert f.suppressed
    assert _findings(port_lint, [str(path)]) == _findings(jax_lint,
                                                          [str(path)])


def test_parse_error_is_reported_not_crashed(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def broken(:\n")
    got = _findings(port_lint, [str(bad)])
    assert any(f[3] == "PARSE" for f in got)
    assert got == _findings(jax_lint, [str(bad)])


# ---- the port's spec docs ----

ADDED = {
    "PROTOCOL.md": [],
    "OBSERVABILITY.md": [
        "Port only (`learning_at_home_tpu_torch`, PyTorch on CUDA), in the",
        "server's headline gauges: `native_frames_in_total` and",
        "`native_frames_out_total` (frames the native frame pump handed to "
        "the",
        "serving loop and replies it queued; present only on the `native`",
        "transport) and `device_peak_bytes` (the CUDA caching allocator's "
        "peak",
        "bytes in the server's process; present only when an expert lives "
        "on a",
        "card).",
        "",
    ],
    "CONCURRENCY.md": [
        "| `server.replica_sync`      | 52 | a `ReplicaSync` round's "
        "write-back vs `stop()` and an `exclusive()` window (port only: a "
        "handoff's install, verify and rollback) | replica-sync thread + "
        "drain/handoff threads; holds `server.expert_state` inside |",
        "| `profiling.backward_ranges` | 96 | the model step's open "
        "backward profiler ranges, by thread | the calling thread + "
        "autograd's device threads, briefly |",
    ],
}


@pytest.mark.parametrize("doc", sorted(ADDED))
def test_port_docs_are_the_repos_docs_plus_listed_lines(doc):
    original = open(os.path.join(REPO, "docs", doc)).read().splitlines()
    copy = open(os.path.join(PORT, "docs", doc)).read().splitlines()
    added, i = [], 0
    for line in copy:  # the original's lines in order, the rest added
        if i < len(original) and line == original[i]:
            i += 1
        else:
            added.append(line)
    assert i == len(original), f"{doc}: line {i + 1} of docs/{doc} missing"
    assert added == ADDED[doc]


def test_lint_finds_the_port_docs_for_port_files():
    server = os.path.join(PORT, "server", "server.py")
    assert port_lint._find_docs_dir(server) == os.path.join(PORT, "docs")
    corpus = port_lint._doc_corpus(os.path.join(PORT, "docs"))
    assert corpus["lock_ranks"]["server.replica_sync"] < \
        corpus["lock_ranks"]["server.expert_state"]
    assert jax_lint._find_docs_dir(
        os.path.join(CORPUS, "r9_bad.py")) == os.path.join(REPO, "docs")
