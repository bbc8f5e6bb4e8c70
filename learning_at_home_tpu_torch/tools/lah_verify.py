#!/usr/bin/env python
"""lah-verify CLI: deterministic interleaving model checker for the
gateway scheduler, drain lifecycle and handoff receiver (ISSUE 14).

Explores permuted operation orders of the REAL concurrent code on a
virtual clock and checks every registered invariant
(``VERIFIED_INVARIANTS`` in gateway/scheduler.py, models/kv_pages.py,
server/lifecycle.py; docs/CONCURRENCY.md "Verified invariants").

    python -m learning_at_home_tpu_torch.tools.lah_verify   # the port tree
    ... lah_verify --seeded-bugs    # + re-find the seeded races
    ... lah_verify --smoke          # small budget (CI gate)
    ... lah_verify --list-invariants
    ... lah_verify --json

Exit codes: 0 clean, 1 invariant violation (or a seeded bug the
explorer FAILED to re-find — the checker itself regressed), 2 usage.
Runs are deterministic per ``--seed``: the same seed reports the same
first failing interleaving.  ``LAH_SANITIZE=1`` additionally enables
footprint-based schedule pruning (learned from the named locks each op
acquires) — without it exploration is unpruned but equally sound.
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="lah-verify",
        description="deterministic interleaving model checker",
    )
    ap.add_argument("--seed", type=int, default=0,
                    help="exploration-order seed (default 0)")
    ap.add_argument("--max-schedules", type=int, default=200,
                    help="schedule budget per world (default 200)")
    ap.add_argument("--seeded-bugs", action="store_true",
                    help="also validate the checker re-finds both "
                         "mechanically re-introduced PR-13 races")
    ap.add_argument("--smoke", action="store_true",
                    help="small budget: merged-tree sweep + seeded-bug "
                         "validation sized for the CI collect gate")
    ap.add_argument("--list-invariants", action="store_true",
                    help="print every registered invariant and exit")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    args = ap.parse_args(argv)

    # exploration intentionally drives error paths (seeded handoff
    # failures, quiesce-budget expiry) — the per-module log chatter is
    # noise here, the Violation reports are the signal
    logging.getLogger("learning_at_home_tpu_torch").setLevel(logging.CRITICAL)

    from learning_at_home_tpu_torch.analysis import verify

    if args.list_invariants:
        rows = verify.collect_invariants()
        if args.json:
            print(json.dumps(
                [{"name": n, "description": d, "module": m}
                 for n, d, m in rows], indent=2,
            ))
        else:
            for name, desc, mod in rows:
                print(f"{name:36s} {desc}  [{mod}]")
            print(f"lah-verify: {len(rows)} machine-checked invariant(s)")
        return 0

    max_schedules = args.max_schedules
    run_seeded = args.seeded_bugs
    if args.smoke:
        max_schedules = min(max_schedules, 60)
        run_seeded = True

    report = verify.run_all(seed=args.seed, max_schedules=max_schedules)
    failed = not report["clean"]
    if run_seeded:
        report["seeded_bugs"] = verify.seeded_bug_validation(
            seed=args.seed, max_schedules=max_schedules
        )
        failed = failed or not report["seeded_bugs"]["ok"]

    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for w in report["worlds"]:
            print(
                f"  {w['world']:18s} {w['schedules_run']:4d} schedules "
                f"({w['schedules_pruned']} pruned), "
                f"{w['violations']} violation(s)"
            )
        for v in report["violations"]:
            print(f"VIOLATION [{v['world']}] {v['invariant']}: {v['detail']}")
            print(f"  schedule #{v['schedule_index']} "
                  f"(seed {report['seed']}): {' -> '.join(v['trace'])}")
        if "seeded_bugs" in report:
            sb = report["seeded_bugs"]
            print(
                "  seeded bugs: stale-prefill "
                f"{'FOUND' if sb['stale_prefill_found'] else 'MISSED'}, "
                "mutual-preemption "
                f"{'FOUND' if sb['mutual_preemption_found'] else 'MISSED'}"
                f", deterministic={sb['deterministic']}"
            )
            if not sb["ok"]:
                print(
                    "lah-verify: seeded-bug validation FAILED — the "
                    "checker no longer re-finds a known race; treat as a "
                    "checker regression, not a clean tree"
                )
        n = len(report["violations"])
        print(
            f"lah-verify: {n} violation(s) across "
            f"{report['invariants_checked']} invariant(s), seed "
            f"{report['seed']}"
        )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
