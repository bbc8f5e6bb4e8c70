#!/usr/bin/env python
"""lah-lint CLI: check the package against the concurrency/wire rules.

    python -m learning_at_home_tpu_torch.tools.lah_lint [paths...] \
        [--list-suppressed] [--json]

Default path is ``learning_at_home_tpu_torch/``.  Exit codes: 0 = clean (all
findings baselined with ``# lah-lint: ignore[Rn]`` annotations or none
at all), 1 = unsuppressed findings, 2 = parse failure in a linted file.

Rules (R1-R11) and the suppression contract are documented in
``learning_at_home_tpu_torch/analysis/lint.py`` and docs/CONCURRENCY.md;
R8-R11 cross-check the code against the spec docs themselves
(PROTOCOL.md op tables, OBSERVABILITY.md metric catalog, the
CONCURRENCY.md lock-rank table).  Runs pure-AST — no jax import,
sub-second — so it sits in front of the collect gate
(tools/collect_gate.py --lint).  The port package carries its own
copies of the three spec docs (``learning_at_home_tpu_torch/docs/``),
which the rules find first for every port file.
"""

import argparse
import json
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "paths", nargs="*", default=[PKG],
        help="files or directories to lint (default: the package)",
    )
    parser.add_argument(
        "--list-suppressed", action="store_true",
        help="also print baselined (suppressed) findings",
    )
    parser.add_argument("--json", action="store_true", help="machine output")
    args = parser.parse_args(argv)

    from learning_at_home_tpu_torch.analysis.lint import (
        format_findings,
        lint_paths,
    )

    findings = lint_paths(args.paths)
    active = [f for f in findings if not f.suppressed]
    if args.json:
        print(json.dumps([f.__dict__ for f in findings], indent=2))
    else:
        print(format_findings(findings, show_suppressed=args.list_suppressed))
    if any(f.rule == "PARSE" for f in findings):
        return 2
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
