#!/usr/bin/env python
"""lah_rebalance: assign replicas of HOT experts to the least-loaded
servers (the small control-plane rebalancer of ISSUE 8 — MoETuner-style
balanced expert placement, decentralized inputs).

Inputs are DHT records only (no endpoint is ever typed on the CLI beyond
the bootstrap peers):

- ``replicas.wanted.<prefix>``  — experts whose hoster's queue-depth EMA
  crossed the hot threshold (subkey=uid, value=[depth EMA, host, port]);
- ``load.<prefix>``             — every server's load heartbeat
  (subkey="host:port", value={"q": queue depth, "n": experts, "hot": …});
- the expert's own full record  — its CURRENT replica set, so the tool
  never over-replicates.

For each hot expert (hottest first) with fewer than ``--max-replicas``
hosters, the least-loaded server not already hosting it gets a
``replica`` RPC.  The target restores the expert from ITS OWN checkpoint
root (or the uid's deterministic crc32 init) and starts advertising —
clients resolve the grown replica set on their next alive-TTL refresh
and the hedged dispatch path takes it from there.

Beyond hot-replica growth, the tool is also the swarm's PLACEMENT
driver (ISSUE 16): ``--placement`` runs a continuous
measure → solve → migrate loop.  Each pass discovers every peer's
``/metrics.json`` through ``telemetry.<prefix>``, merges the trainers'
co-activation graphs and link EMAs with the servers' hosted-expert maps
and the ``links.<prefix>`` DHT records into one solver snapshot
(``build_snapshot`` — pure, unit-testable), asks
``analysis/placement.solve`` for a migration plan, and executes it move
by move over the ``migrate`` RPC (handoff → verified install → retire,
so replication never dips).  The loop is SLO-GATED: before each move it
re-samples trainer dispatch p99 and the shed fraction; when either
degrades past the configured margin vs the pass baseline, the rest of
the plan is aborted and the pass interval backs off exponentially —
placement optimization must never make the swarm visibly worse to win
a theoretical cost.

``--plan SNAPSHOT.json`` runs the solver OFFLINE on a snapshot file and
prints the canonical plan JSON — deterministic per ``--seed``
byte-for-byte (the collect-gate placement stage runs it twice and
compares bytes).

Usage (``python -m learning_at_home_tpu_torch.tools.lah_rebalance ...``)::

    lah_rebalance --initial-peers 10.0.0.1:31338 --once
    lah_rebalance --initial-peers ... --interval 10 --sync
    lah_rebalance --plan snap.json --seed 0
    lah_rebalance --initial-peers ... --placement
"""

from __future__ import annotations

import argparse
import json
import sys
import time



def parse_endpoint(s: str) -> tuple[str, int]:
    host, sep, port = s.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"endpoint {s!r} must be host:port")
    return (host, int(port))


def current_hosters(dht, uid: str) -> set:
    """The uid's live replica set from its full DHT record (subkeys
    ``@host:port``; legacy ``""`` records count as one unnamed hoster)."""
    from learning_at_home_tpu_torch.dht import DHT

    hosters = set()
    for subkey, entry in dht.get_sync(uid).items():
        value = entry[0] if isinstance(entry, (tuple, list)) else entry
        endpoint = DHT._parse_endpoint(value)
        if endpoint is not None:
            hosters.add(endpoint)
    return hosters


def plan_actions(
    wanted: dict, loads: dict, hosters: dict, max_replicas: int
) -> list[dict]:
    """Pure planning step (unit-testable): which (uid → target endpoint)
    replica assignments to issue this pass.

    ``wanted``: uid → {"depth", "endpoint"} (parse_wanted_value output);
    ``loads``: "host:port" → {"q", "n", ...} (parse_load_value output);
    ``hosters``: uid → set of endpoints currently hosting it.
    Hottest experts first; each action targets the least-loaded server
    (queue depth, then expert count, then endpoint for determinism) that
    does not already host the uid.  A server picked for one uid has its
    planned expert count bumped so one pass spreads replicas instead of
    dog-piling the single coldest box."""
    planned_n = {}
    actions = []
    for uid, rec in sorted(
        wanted.items(), key=lambda kv: -kv[1].get("depth", 0.0)
    ):
        have = set(hosters.get(uid, ()))
        if len(have) >= max_replicas:
            continue
        candidates = []
        for ep_key, load in loads.items():
            host, _, port = ep_key.rpartition(":")
            if not port.isdigit():
                continue
            endpoint = (host, int(port))
            if endpoint in have:
                continue
            n = load.get("n", 0) + planned_n.get(endpoint, 0)
            candidates.append((load.get("q", 0.0), n, endpoint))
        if not candidates:
            continue
        _q, _n, target = min(candidates)
        planned_n[target] = planned_n.get(target, 0) + 1
        actions.append(
            {"uid": uid, "target": target, "depth": rec.get("depth", 0.0)}
        )
    return actions


def run_pass(dht, prefix: str, max_replicas: int, sync: bool) -> list[dict]:
    """One discover → plan → execute pass; returns executed actions
    (each stamped with the replica RPC's outcome)."""
    from learning_at_home_tpu_torch.client.rpc import client_loop, pool_registry
    from learning_at_home_tpu_torch.utils.telemetry import (
        load_key,
        parse_load_value,
        parse_wanted_value,
        replicas_wanted_key,
    )

    def parse_records(key, parse):
        out = {}
        for subkey, entry in dht.get_sync(key).items():
            value = entry[0] if isinstance(entry, (tuple, list)) else entry
            parsed = parse(value)
            if isinstance(subkey, str) and parsed is not None:
                out[subkey] = parsed
        return out

    wanted = parse_records(replicas_wanted_key(prefix), parse_wanted_value)
    loads = parse_records(load_key(prefix), parse_load_value)
    hosters = {uid: current_hosters(dht, uid) for uid in wanted}
    actions = plan_actions(wanted, loads, hosters, max_replicas)
    for action in actions:
        pool = pool_registry().get(action["target"])
        try:
            _tensors, meta = client_loop().run(
                pool.rpc(
                    "replica", (),
                    {"uid": action["uid"], "sync": sync},
                    timeout=60.0,
                )
            )
            action["installed"] = bool(meta.get("installed"))
            action["hosted"] = bool(meta.get("hosted"))
        except Exception as e:  # a dying target must not kill the pass
            action["error"] = f"{type(e).__name__}: {e}"
    return actions


# --------------------------------------------------------------------------
# placement: measure -> solve -> SLO-gated migrate (ISSUE 16)
# --------------------------------------------------------------------------


def collect_placement_rows(dht, prefix: str) -> list[dict]:
    """Discover + scrape every advertised peer concurrently (same shape
    as lah_top's snapshot pass: unreachable peers carry snapshot=None)."""
    from concurrent.futures import ThreadPoolExecutor

    from learning_at_home_tpu_torch.utils.telemetry import (
        discover_telemetry,
        fetch_json,
    )

    peers = sorted(discover_telemetry(dht, prefix).items())
    if not peers:
        return []
    with ThreadPoolExecutor(max_workers=min(16, len(peers))) as pool:
        snaps = list(pool.map(lambda kv: fetch_json(kv[1]["endpoint"]), peers))
    return [
        {"peer_id": peer_id, "role": info["role"],
         "snapshot": snap if isinstance(snap, dict) else None}
        for (peer_id, info), snap in zip(peers, snaps)
    ]


def collect_dht_links(dht, prefix: str) -> dict:
    """``links.<prefix>`` records: src key -> {dst: {"rtt_s","bw_bps"}}."""
    from learning_at_home_tpu_torch.utils.telemetry import (
        links_key,
        parse_links_value,
    )

    out = {}
    for subkey, entry in dht.get_sync(links_key(prefix)).items():
        value = entry[0] if isinstance(entry, (tuple, list)) else entry
        parsed = parse_links_value(value)
        if isinstance(subkey, str) and parsed:
            out[subkey] = parsed
    return out


def _numeric(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v) if v == v else None


def build_snapshot(
    rows: list[dict], dht_links: dict = None, capacity: int = None
) -> dict:
    """Merge scraped peer snapshots + DHT link records into ONE solver
    snapshot (analysis/placement docstring schema).  Pure and tolerant:
    peers are untrusted, so malformed sections are skipped, never raised
    on.

    - servers contribute the assignment (their ``experts`` section keyed
      by their RPC ``endpoint``) and per-uid update counts as activation
      weights;
    - trainers contribute co-activation pair counts, their measured
      src→server link EMAs (the trainer peer_id becomes a source node),
      their dispatch weight, and bytes-per-dispatch;
    - ``links.<prefix>`` DHT records fill in server→server links the
      scrape can't see."""
    experts: dict = {}
    activations: dict = {}
    coact: dict = {}
    links: dict = {}
    sources: dict = {}
    bytes_pd: list = []
    for row in rows if isinstance(rows, list) else []:
        snap = row.get("snapshot") if isinstance(row, dict) else None
        if not isinstance(snap, dict):
            continue
        ep = snap.get("endpoint")
        hosted = snap.get("experts")
        if (
            isinstance(ep, (list, tuple)) and len(ep) == 2
            and isinstance(hosted, dict)
        ):
            ep_key = f"{ep[0]}:{ep[1]}"
            for uid, updates in hosted.items():
                if not isinstance(uid, str):
                    continue
                experts[uid] = ep_key
                w = _numeric(updates)
                if w:
                    activations[uid] = activations.get(uid, 0.0) + w
        dispatch = snap.get("dispatch")
        placement = (
            dispatch.get("placement") if isinstance(dispatch, dict) else None
        )
        if not isinstance(placement, dict):
            continue
        pairs = placement.get("coact")
        if isinstance(pairs, dict):
            for key, n in pairs.items():
                w = _numeric(n)
                if isinstance(key, str) and w:
                    coact[key] = coact.get(key, 0.0) + w
        src_key = str(row.get("peer_id") or "") or None
        trainer_links = placement.get("links")
        if src_key and isinstance(trainer_links, dict) and trainer_links:
            links[src_key] = dict(trainer_links)
            weight = _numeric(placement.get("coact_dispatches")) or 1.0
            sources[src_key] = sources.get(src_key, 0.0) + weight
        bpd = _numeric(placement.get("bytes_per_dispatch"))
        if bpd:
            bytes_pd.append(bpd)
    if isinstance(dht_links, dict):
        for src, dsts in dht_links.items():
            if isinstance(src, str) and isinstance(dsts, dict):
                merged = dict(links.get(src, {}))
                merged.update(dsts)
                links[src] = merged
    snapshot = {
        "experts": experts,
        "activations": activations,
        "coact": coact,
        "links": links,
        "sources": sources,
        "bytes_per_dispatch": (
            max(bytes_pd) if bytes_pd else 0.0
        ),
    }
    if capacity:
        snapshot["capacity"] = {
            node: int(capacity) for node in set(experts.values())
        }
    return snapshot


def sample_slo(rows: list[dict]) -> dict:
    """The gate signals: worst trainer dispatch p99 and the swarm-wide
    client shed fraction (samples dropped / samples offered)."""
    p99 = 0.0
    dropped = samples = 0.0
    for row in rows if isinstance(rows, list) else []:
        snap = row.get("snapshot") if isinstance(row, dict) else None
        if not isinstance(snap, dict):
            continue
        metrics = snap.get("metrics")
        collected = (
            metrics.get("collected") if isinstance(metrics, dict) else None
        )
        if not isinstance(collected, dict):
            continue
        p99 = max(
            p99, _numeric(collected.get("lah_client_dispatch_p99_ms")) or 0.0
        )
        dropped += (
            _numeric(collected.get("lah_client_samples_dropped_total")) or 0.0
        )
        samples += (
            _numeric(collected.get("lah_client_samples_total")) or 0.0
        )
    return {
        "p99_ms": p99,
        "shed_fraction": dropped / samples if samples else 0.0,
    }


def _slo_degraded(baseline: dict, now: dict, args) -> str:
    """Non-empty reason string when the gate should fire.

    The comparisons run through the declarative SLO engine
    (utils/slo.py, ISSUE 19) with the bounds UNCHANGED: the p99 ceiling
    is ``max(baseline x factor, baseline + 5 ms)`` — skipped entirely on
    a cold baseline (p99 == 0) — and the shed ceiling is
    ``baseline + margin``."""
    from learning_at_home_tpu_torch.utils.slo import Threshold, evaluate_thresholds

    specs = []
    if baseline["p99_ms"] > 0:
        specs.append(Threshold(
            name="dispatch_p99_ceiling", metric="p99_ms", op="<=",
            bound=max(
                baseline["p99_ms"] * args.slo_p99_factor,
                baseline["p99_ms"] + 5.0,
            ),
        ))
    specs.append(Threshold(
        name="shed_fraction_ceiling", metric="shed_fraction", op="<=",
        bound=baseline["shed_fraction"] + args.slo_shed_margin,
    ))
    violations = evaluate_thresholds(now, specs)
    if not violations:
        return ""
    if violations[0]["slo"] == "dispatch_p99_ceiling":
        return (
            f"dispatch p99 {now['p99_ms']:.1f}ms > "
            f"{args.slo_p99_factor}x baseline {baseline['p99_ms']:.1f}ms"
        )
    return (
        f"shed fraction {now['shed_fraction']:.3f} > baseline "
        f"{baseline['shed_fraction']:.3f} + {args.slo_shed_margin}"
    )


def _wait_migration_idle(pool, timeout_s: float = 30.0) -> dict:
    """Poll the source's stats RPC until its one migration slot frees
    (placement.migration_in_flight is None); returns the last placement
    section seen ({} when the peer stopped answering)."""
    from learning_at_home_tpu_torch.client.rpc import client_loop

    deadline = time.monotonic() + timeout_s
    last = {}
    while time.monotonic() < deadline:
        try:
            _tensors, meta = client_loop().run(
                pool.rpc("stats", (), {}, timeout=10.0)
            )
        except Exception:
            return last
        placement = meta.get("placement")
        last = placement if isinstance(placement, dict) else {}
        if last.get("migration_in_flight") is None:
            return last
        time.sleep(0.2)
    return last


def run_placement_pass(dht, prefix: str, args, totals: dict) -> dict:
    """One measure → solve → SLO-gated execute pass.  ``totals``
    accumulates completed/failed/aborted_slo across passes (the driver's
    own observability — published when telemetry is up)."""
    from learning_at_home_tpu_torch.analysis.placement import solve
    from learning_at_home_tpu_torch.client.rpc import client_loop, pool_registry

    rows = collect_placement_rows(dht, prefix)
    snapshot = build_snapshot(
        rows, collect_dht_links(dht, prefix), capacity=args.capacity
    )
    plan = solve(snapshot, seed=args.seed, max_moves=args.max_moves)
    baseline = sample_slo(rows)
    summary = {
        "experts": len(snapshot["experts"]),
        "coact_pairs": len(snapshot["coact"]),
        "cost_before": plan["cost_before"],
        "cost_after": plan["cost_after"],
        "planned": len(plan["moves"]),
        "completed": 0,
        "failed": 0,
        "aborted_slo": 0,
        "slo_baseline": baseline,
        "moves": [],
    }
    for move in plan["moves"]:
        now = sample_slo(collect_placement_rows(dht, prefix))
        reason = _slo_degraded(baseline, now, args)
        if reason:
            remaining = summary["planned"] - len(summary["moves"])
            summary["aborted_slo"] += remaining
            totals["aborted_slo"] += remaining
            summary["slo_abort_reason"] = reason
            break
        src = parse_endpoint(move["from"])
        dst = parse_endpoint(move["to"])
        record = dict(move)
        totals["in_flight"] = move["uid"]
        try:
            pool = pool_registry().get(src)
            _tensors, meta = client_loop().run(
                pool.rpc(
                    "migrate", (),
                    {"uid": move["uid"], "target": [dst[0], dst[1]],
                     "timeout": args.migrate_timeout},
                    timeout=30.0,
                )
            )
            if meta.get("started"):
                placement = _wait_migration_idle(pool)
                record["started"] = True
                record["source_migrations_out"] = placement.get(
                    "migrations_out"
                )
                summary["completed"] += 1
                totals["completed"] += 1
            else:
                record["started"] = False
                summary["failed"] += 1
                totals["failed"] += 1
        except Exception as e:  # a dying source must not kill the pass
            record["error"] = f"{type(e).__name__}: {e}"
            summary["failed"] += 1
            totals["failed"] += 1
        finally:
            totals["in_flight"] = None
        summary["moves"].append(record)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prefix", default="swarm",
                    help="telemetry/load/replicas.wanted DHT scope")
    ap.add_argument("--initial-peers", nargs="+", default=None,
                    help="host:port DHT bootstrap peers (required for "
                         "every mode except --plan)")
    ap.add_argument("--max-replicas", type=int, default=2,
                    help="never grow an expert past this many hosters")
    ap.add_argument("--sync", action="store_true",
                    help="ask targets to start replica param averaging "
                         "(ReplicaSync) for installed replicas")
    ap.add_argument("--once", action="store_true",
                    help="one pass, JSON actions on stdout, exit 0")
    ap.add_argument("--interval", type=float, default=10.0)
    ap.add_argument("--plan", default=None, metavar="SNAPSHOT.json",
                    help="OFFLINE: solve the snapshot file, print the "
                         "canonical plan JSON, exit (no DHT)")
    ap.add_argument("--placement", action="store_true",
                    help="run the continuous placement loop (measure -> "
                         "solve -> SLO-gated migrate) instead of the "
                         "hot-replica pass")
    ap.add_argument("--seed", type=int, default=0,
                    help="placement solver seed (byte-deterministic)")
    ap.add_argument("--max-moves", type=int, default=8,
                    help="cap on distinct experts migrated per pass")
    ap.add_argument("--capacity", type=int, default=None,
                    help="per-node expert cap for the solver (default: "
                         "balanced ceil(n/nodes)+1)")
    ap.add_argument("--migrate-timeout", type=float, default=60.0,
                    help="per-move handoff timeout passed to the source")
    ap.add_argument("--slo-p99-factor", type=float, default=1.5,
                    help="abort a pass when trainer dispatch p99 exceeds "
                         "this factor of the pass baseline")
    ap.add_argument("--slo-shed-margin", type=float, default=0.05,
                    help="abort a pass when the client shed fraction "
                         "rises past baseline by this much")
    args = ap.parse_args(argv)

    if args.plan is not None:
        from learning_at_home_tpu_torch.analysis.placement import (
            plan_to_json,
            solve,
        )

        with open(args.plan) as f:
            snapshot = json.load(f)
        print(plan_to_json(
            solve(snapshot, seed=args.seed, max_moves=args.max_moves)
        ), flush=True)
        return 0

    if not args.initial_peers:
        ap.error("--initial-peers is required (every mode except --plan)")

    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.dht import DHT

    dht = DHT(initial_peers=[parse_endpoint(s) for s in args.initial_peers])
    telemetry = None
    # driver totals across passes; the rebalancer is a swarm peer too —
    # it heartbeats these under telemetry.<prefix> so the lah_top
    # placement panel shows migrations in flight / completed / aborted
    totals = {"completed": 0, "failed": 0, "aborted_slo": 0,
              "in_flight": None, "passes": 0}
    if args.placement:
        from learning_at_home_tpu_torch.utils.telemetry import TelemetryPublisher

        try:
            telemetry = TelemetryPublisher(
                dht, prefix=args.prefix, role="rebalancer",
                extra_fn=lambda: {"placement_driver": dict(totals)},
            ).start()
        except Exception:  # observability must never kill the driver
            telemetry = None
    backoff = 0.0
    try:
        while True:
            if args.placement:
                summary = run_placement_pass(dht, args.prefix, args, totals)
                totals["passes"] += 1
                print(json.dumps({"placement_pass": summary}), flush=True)
                # SLO aborts back the loop off exponentially: the swarm
                # is telling us optimization pressure is unwelcome NOW
                if summary["aborted_slo"]:
                    backoff = min(
                        8 * args.interval, max(args.interval, backoff * 2)
                    )
                else:
                    backoff = 0.0
            else:
                actions = run_pass(
                    dht, args.prefix, args.max_replicas, args.sync
                )
                print(json.dumps({"actions": actions}), flush=True)
            if args.once:
                return 0
            time.sleep(args.interval + backoff)
    except KeyboardInterrupt:
        return 0
    finally:
        if telemetry is not None:
            telemetry.stop()
        dht.shutdown()
        reset_client_rpc()


if __name__ == "__main__":
    sys.exit(main())
