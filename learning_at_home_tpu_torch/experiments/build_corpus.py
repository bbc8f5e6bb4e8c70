#!/usr/bin/env python
"""Assemble a real-English text corpus from locally installed packages.

The reference's headline LM experiment runs on WikiText-103 (SURVEY.md
§3.5); this sandbox has zero network egress, so no public corpus can be
fetched.  The nearest real natural-language source available offline is
the documentation already on disk: docstrings of the big scientific
packages (NumPy-doc style English prose) plus .md/.rst docs.  This script
harvests, filters, dedupes, and concatenates them into one text file for
``train_lm.py --data`` — real text with real Zipfian statistics, unlike
the synthetic fallback.

    python -m learning_at_home_tpu_torch.experiments.build_corpus \
        --out corpus.txt

The packages are read from the running interpreter's ``purelib``
directory and the standard library from its ``stdlib`` directory
(``sysconfig``), so the script works under any installation; the
default output lies in the temporary directory.
"""

import argparse
import ast
import hashlib
import pathlib
import re
import sys
import sysconfig
import tempfile

PACKAGES = [
    "numpy", "scipy", "jax", "jaxlib", "torch", "transformers", "flax",
    "optax", "pandas", "sklearn", "chex", "orbax", "einops", "accelerate",
]
SITE = pathlib.Path(sysconfig.get_paths()["purelib"])
STDLIB = pathlib.Path(sysconfig.get_paths()["stdlib"])


def natural_language_score(text: str) -> float:
    """Fraction of characters that look like English prose."""
    if not text:
        return 0.0
    letters = sum(c.isalpha() or c in " .,;:'\"!?-" for c in text)
    return letters / len(text)


def clean(text: str) -> str:
    # drop doctest/code lines and rst markup noise; keep prose lines
    lines = []
    for line in text.splitlines():
        s = line.strip()
        if not s:
            lines.append("")
            continue
        if s.startswith((">>>", "...", ".. ", ":param", ":return", "--", "==",
                         "+-", "|", "#")):
            continue
        if natural_language_score(s) < 0.55:
            continue
        lines.append(s)
    out = "\n".join(lines)
    return re.sub(r"\n{3,}", "\n\n", out).strip()


def harvest_docstrings(py_file: pathlib.Path) -> list[str]:
    try:
        tree = ast.parse(py_file.read_text(errors="replace"))
    except (SyntaxError, ValueError, OSError):
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            ds = ast.get_docstring(node)
            if ds and len(ds) > 200:
                out.append(ds)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=str(
        pathlib.Path(tempfile.gettempdir()) / "pydoc_corpus.txt"))
    p.add_argument("--min-score", type=float, default=0.6,
                   help="min prose-likeness of a cleaned docstring")
    args = p.parse_args(argv)

    seen: set[bytes] = set()
    chunks: list[str] = []
    n_files = 0
    roots = [SITE / pkg for pkg in PACKAGES if (SITE / pkg).exists()]
    roots.append(STDLIB)
    for root in roots:
        for f in sorted(root.rglob("*.py")):
            if "test" in f.name or "/tests/" in str(f):
                continue
            n_files += 1
            for ds in harvest_docstrings(f):
                text = clean(ds)
                if len(text) < 200 or natural_language_score(text) < args.min_score:
                    continue
                h = hashlib.sha1(text.encode()).digest()
                if h in seen:
                    continue
                seen.add(h)
                chunks.append(text)
    # .md / .rst prose too
    for root in roots:
        for f in sorted(list(root.rglob("*.md")) + list(root.rglob("*.rst"))):
            try:
                text = clean(f.read_text(errors="replace"))
            except OSError:
                continue
            if len(text) < 500 or natural_language_score(text) < args.min_score:
                continue
            h = hashlib.sha1(text.encode()).digest()
            if h not in seen:
                seen.add(h)
                chunks.append(text)

    corpus = "\n\n".join(chunks)
    pathlib.Path(args.out).write_text(corpus)
    n_words = len(corpus.split())
    print(
        f"scanned {n_files} files -> {len(chunks)} unique prose chunks, "
        f"{len(corpus):,} chars / {n_words:,} words -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
