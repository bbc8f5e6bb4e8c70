"""Static analysis for the swarm's concurrency invariants.

``lah_lint`` (``tools/lah_lint.py`` fronts :mod:`.lint`) encodes the
threading rules the runtime sanitizer (utils/sanitizer.py) checks
dynamically — the static layer catches the violation at review time, the
runtime layer catches whatever slips through.  docs/CONCURRENCY.md is
the prose contract both layers enforce.

The port's copy of the JAX package's ``analysis/``: ``lint``, ``schema``
and ``fuzz`` are framework-free and verbatim, ``verify`` explores the
port's scheduler, KV pages and lifecycle, and ``placement`` is the
co-activation-aware expert placement solver the macro-sim runs.  The
port's spec docs are ``learning_at_home_tpu_torch/docs/``.
"""

from learning_at_home_tpu_torch.analysis.lint import (  # noqa: F401
    Finding,
    RULES,
    format_findings,
    lint_paths,
)

__all__ = ["Finding", "RULES", "format_findings", "lint_paths"]
