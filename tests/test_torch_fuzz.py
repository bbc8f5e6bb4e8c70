"""The port's lah-fuzz (``learning_at_home_tpu_torch/analysis/fuzz.py``,
the JAX module's text with the package renamed, and
``tools/lah_fuzz.py`` over the port's classes) against the JAX
package's, on the CPU.

- Case generation over the port tree is the JAX generator's over the JAX
  package, case for case and byte for byte (seeds 0, 1 and 3), and
  ``--emit-corpus`` from the port tree writes ``tests/fuzz_corpus/``'s
  pinned files byte for byte.
- The pinned corpus replays clean against the port's four live hosts on
  the CPU (``--replay ... --device cpu``).
- Family by family, every case of the seed-0 battery gets the outcome
  class (error reply, result, close) the JAX family's live host gives the
  same frame.  No case is excluded: three runs of each package's hosts
  gave every case the same class.
- The seeded-bug self-check finds the lenient ``gen_submit``.
"""

import functools
import importlib
import os
import subprocess
import sys

import pytest

from learning_at_home_tpu.analysis import fuzz as jax_fuzz
from learning_at_home_tpu_torch.analysis import fuzz as port_fuzz
from learning_at_home_tpu_torch.tools import lah_fuzz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "learning_at_home_tpu")
PORT = os.path.join(REPO, "learning_at_home_tpu_torch")
CORPUS = os.path.join(REPO, "tests", "fuzz_corpus")


@pytest.fixture(scope="module", autouse=True)
def _extract_once():
    """Each package's wire IR is extracted once for the module (it is a
    pure function of the tree; the generator extracts it per call)."""
    saved = [(m, m._schema.extract) for m in (jax_fuzz, port_fuzz)]
    for m, extract in saved:
        cached = functools.lru_cache(maxsize=None)(
            lambda paths, extract=extract: extract(list(paths)))
        m._schema.extract = lambda paths, cached=cached: cached(tuple(paths))
    yield
    for m, extract in saved:
        m._schema.extract = extract


def _cases(fuzz, root, seed):
    return fuzz.generate_cases(seed, [root])


def test_fuzz_module_is_the_jax_modules_text():
    original = open(os.path.join(JAX_PKG, "analysis", "fuzz.py")).read()
    copy = open(os.path.join(PORT, "analysis", "fuzz.py")).read()
    assert copy == original.replace("learning_at_home_tpu.",
                                    "learning_at_home_tpu_torch.")


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_case_generation_is_the_jax_generators(seed):
    got = _cases(port_fuzz, PORT, seed)
    want = _cases(jax_fuzz, JAX_PKG, seed)
    assert len(got) == 944
    assert [c.to_json() for c in got] == [c.to_json() for c in want]
    assert [c.frame() for c in got] == [c.frame() for c in want]


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "learning_at_home_tpu_torch.tools.lah_fuzz",
         *args], capture_output=True, text=True, timeout=240, cwd=REPO)


def test_emit_corpus_writes_the_pinned_corpus(tmp_path):
    r = _cli("--emit-corpus", str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    for fam in lah_fuzz.HOSTS:
        got = (tmp_path / f"{fam}.json").read_bytes()
        with open(os.path.join(CORPUS, f"{fam}.json"), "rb") as fh:
            assert got == fh.read(), fam


def test_pinned_corpus_replays_clean_against_the_ports_hosts():
    r = _cli("--device", "cpu", *(
        arg for fam in lah_fuzz.HOSTS
        for arg in ("--replay", os.path.join(CORPUS, f"{fam}.json"))))
    assert r.returncode == 0, r.stdout + r.stderr
    for fam in lah_fuzz.HOSTS:
        assert f"lah-fuzz: {fam}: OK" in r.stdout
    assert "0 crashes, 0 hangs, 0 sanitizer violations" in r.stdout


@pytest.mark.parametrize("family", list(lah_fuzz.HOSTS))
def test_outcome_classes_are_the_jax_hosts(family):
    jax_tool = importlib.import_module("tools.lah_fuzz")
    cases = [c for c in _cases(port_fuzz, PORT, 0) if c.family == family]
    report = lah_fuzz.run_family(family, cases, device="cpu")
    assert report["failures"] == [], report["failures"]
    assert report["frames"] == len(cases) >= lah_fuzz.MIN_PER_FAMILY
    assert report["device"] == ("cpu" if family in lah_fuzz.DEVICE_FAMILIES
                                else "host")
    with jax_tool.HOSTS[family]() as (endpoint, _probe):
        want = [(c.name, jax_tool.drive_case(endpoint, c)) for c in cases]
    assert report["case_outcomes"] == want
    assert {o for _, o in want} <= {"reject", "result", "close"}


def test_selfcheck_finds_the_seeded_bug(capsys):
    assert lah_fuzz.selfcheck(0, device="cpu") == 0
    assert "selfcheck OK" in capsys.readouterr().out


def test_counters_are_published():
    """Each frame and each outcome lands on its ``lah_fuzz_*`` counter,
    labeled by family."""
    from learning_at_home_tpu_torch.utils.metrics import registry

    cases = [c for c in _cases(port_fuzz, PORT, 0) if c.family == "dht"]
    names = ("lah_fuzz_frames_total", "lah_fuzz_rejects_total",
             "lah_fuzz_results_total", "lah_fuzz_closes_total")

    def read():
        return [registry.counter(n, "").value(family="dht") for n in names]

    before = read()
    report = lah_fuzz.run_family("dht", cases[:20], device="cpu")
    assert report["frames"] == 20 and not report["failures"]
    frames, rejects, results, closes = (
        a - b for a, b in zip(read(), before))
    assert frames == 20 == rejects + results + closes
    assert (rejects, results, closes) == tuple(
        report["outcomes"][k] for k in ("reject", "result", "close"))
