#!/usr/bin/env python
"""lah_top: a live, DHT-discovered swarm telemetry view (``top`` for the
expert swarm).

No metrics endpoint is ever passed on the CLI: the tool joins the DHT via
``--initial-peers``, reads the ``telemetry.<prefix>`` key family (every
server and trainer heartbeats its metrics endpoint there — record expiry
IS the dead-peer detector), fetches each live peer's ``/metrics.json``,
and renders one aggregated view:

- per-peer rows: role, health, request throughput, queue depth, overlap
  fraction, padding waste, degraded-averaging fraction; serving gateways
  (ISSUE 12/13) additionally fill STREAMS/SLOTS/SHED plus the paged-KV
  columns PAGES (``used/total`` physical pages) and PFX-HIT
  (prefix-cache hits) from their ``gateway`` snapshot section;
- an expert table merged across servers: per-expert async update counts;
- a placement panel (ISSUE 16): the hottest gate co-activation pairs
  with each expert's home node, plus the migration ledger — per-server
  completed/failed counts, moves in flight, and the rebalancing
  driver's aborted-by-SLO total when one is heartbeating;
- a speculation panel (ISSUE 17): per-gateway draft acceptance rate,
  effective tokens per swarm round-trip and drafter overhead share,
  for gateways running with ``LAH_GW_SPEC_K > 0``;
- dead peers: ids seen in an earlier refresh whose record expired, plus
  peers whose record is live but whose endpoint stopped answering.

Usage (``python -m learning_at_home_tpu_torch.tools.lah_top ...``)::

    lah_top --initial-peers 10.0.0.1:31338            # live view
    lah_top --initial-peers ... --once                # one frame
    lah_top --initial-peers ... --json                # machine-readable
    lah_top --initial-peers ... --once \
        --dump-trace swarm_trace.json   # merge every peer's /trace into
                                        # one chrome://tracing file
"""

from __future__ import annotations

import argparse
import json
import sys
import time



def parse_endpoint(s: str) -> tuple[str, int]:
    host, sep, port = s.rpartition(":")
    if not sep or not port.isdigit():
        raise SystemExit(f"--initial-peers entry {s!r} must be host:port")
    return (host, int(port))


def collect_snapshot(dht, prefix: str) -> list[dict]:
    """One discovery + scrape pass: a row per advertised peer (rows for
    unreachable peers carry ``snapshot=None``).  Scrapes run
    CONCURRENTLY: during churn — exactly when this tool matters — several
    advertised endpoints are dead-but-not-yet-expired, and serial 3 s
    urlopen timeouts would stretch one frame to N×3 s."""
    from concurrent.futures import ThreadPoolExecutor

    from learning_at_home_tpu_torch.utils.telemetry import (
        discover_telemetry,
        fetch_json,
    )

    peers = sorted(discover_telemetry(dht, prefix).items())
    with ThreadPoolExecutor(max_workers=min(16, max(1, len(peers)))) as pool:
        snapshots = list(
            pool.map(lambda kv: fetch_json(kv[1]["endpoint"]), peers)
        )
    rows = []
    for (peer_id, info), snap in zip(peers, snapshots):
        rows.append(
            {
                "peer_id": peer_id,
                "role": info["role"],
                "endpoint": info["endpoint"],
                "expires_at": info["expires_at"],
                # peer-supplied: anything that isn't the expected dict
                # shape counts as unreachable, never as a crash
                "snapshot": snap if isinstance(snap, dict) else None,
            }
        )
    return rows


def _section(row: dict, key: str) -> dict:
    """A dict-valued section of a peer snapshot; {} for anything
    malformed (tolerate, never crash — the telemetry reader contract)."""
    section = (row.get("snapshot") or {}).get(key)
    return section if isinstance(section, dict) else {}


def _collected(row: dict) -> dict:
    collected = _section(row, "metrics").get("collected")
    return collected if isinstance(collected, dict) else {}


def _num(v, default=0.0) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def peer_health(row: dict) -> str:
    """Coarse health verdict: ``ok`` / ``degraded`` / ``unreachable``.
    Degraded = averaging rounds are failing over to survivor means, or
    the runtime queue is visibly backed up."""
    if row["snapshot"] is None:
        return "unreachable"
    m = _collected(row)
    rounds = _num(m.get("lah_averaging_rounds_total"))
    degraded = _num(m.get("lah_averaging_degraded_rounds_total"))
    if rounds and degraded / rounds > 0.5:
        return "degraded"
    if _num(m.get("lah_server_queue_depth")) > 64:
        return "degraded"
    return "ok"


def peer_lifecycle(row: dict) -> tuple[str, str, str]:
    """(STATE, UPTIME, RST) strings for a peer row (ISSUE 9): servers
    report SERVING/DRAINING/DRAINED plus uptime and how many times they
    restarted from a checkpoint; peers without a lifecycle section
    (trainers, old builds) render dashes."""
    lc = _section(row, "lifecycle")
    state = lc.get("state")
    if not isinstance(state, str) or not state:
        return "-", "-", "-"
    uptime = int(_num(lc.get("uptime_s")))
    return state, f"{uptime}s", str(int(_num(lc.get("restarts"))))


def peer_gateway(row: dict) -> tuple[str, str, str, str, str]:
    """(STREAMS, SLOTS, SHED, PAGES, PFX-HIT) strings for a peer row
    (ISSUE 12/13): gateways advertise a ``gateway`` section in their
    snapshot (stream counts, slot occupancy, admission sheds, KV page
    pool occupancy, prefix-cache hits); peers without one — servers,
    trainers — and malformed sections render dashes, never crash (the
    telemetry reader contract).  PAGES/PFX-HIT dash independently:
    a dense-layout gateway has no page pool to report."""
    gw = _section(row, "gateway")
    slots = gw.get("slots")
    if not isinstance(slots, (int, float)) or isinstance(slots, bool):
        return "-", "-", "-", "-", "-"
    pages_total = gw.get("kv_pages_total")
    if (
        isinstance(pages_total, (int, float))
        and not isinstance(pages_total, bool)
    ):
        pages = (
            f"{int(_num(gw.get('kv_pages_used')))}/{int(pages_total)}"
        )
        pfx = str(int(_num(gw.get("prefix_hits_total"))))
    else:
        pages, pfx = "-", "-"
    return (
        f"{int(_num(gw.get('streams_active')))}/"
        f"{int(_num(gw.get('streams_total')))}",
        f"{int(_num(gw.get('slots_in_use')))}/{int(slots)}",
        str(int(_num(gw.get("shed_total")))),
        pages,
        pfx,
    )


def fleet_latency_rows(rows: list[dict]) -> list[dict]:
    """TRUE fleet quantiles per histogram (ISSUE 19): merge each peer's
    wire-form DDSketch (``metrics.histograms.<name>.sketch``) bucketwise
    and read p50/p95/p99 off the merged sketch.  Peers that export no
    sketch (old builds, malformed sections) cannot contribute to the
    quantile — the row's SOURCE tags that (``sketch`` = full coverage,
    ``sketch+MAX`` = partial, so the registry's MAX-merged ``*_p99_ms``
    series remain the authority for the uncovered peers); a name with
    zero usable sketches renders dashes, never crashes."""
    from learning_at_home_tpu_torch.utils.sketch import merge_dicts, try_from_dict

    per_name: dict[str, dict] = {}
    for row in rows:
        hists = _section(row, "metrics").get("histograms")
        if not isinstance(hists, dict):
            continue
        for name, h in hists.items():
            if not isinstance(name, str) or not isinstance(h, dict):
                continue
            # unlabeled histograms fold flat; labeled ones map
            # label-string -> per-label state
            variants = (
                [h] if "count" in h
                else [v for v in h.values() if isinstance(v, dict)]
            )
            if not variants:
                continue
            entry = per_name.setdefault(
                name, {"sketches": [], "missing": 0, "count": 0.0}
            )
            for v in variants:
                entry["count"] += _num(v.get("count"))
                skd = v.get("sketch")
                if try_from_dict(skd) is not None:
                    entry["sketches"].append(skd)
                else:
                    entry["missing"] += 1
    out = []
    for name in sorted(per_name):
        e = per_name[name]
        merged = merge_dicts(e["sketches"])
        if merged is None:
            out.append({
                "name": name, "source": "-", "count": int(e["count"]),
                "p50": None, "p95": None, "p99": None,
            })
            continue
        out.append({
            "name": name,
            "source": "sketch" if not e["missing"] else "sketch+MAX",
            "count": int(e["count"]),
            "p50": merged.quantile(50),
            "p95": merged.quantile(95),
            "p99": merged.quantile(99),
        })
    return out


_SLO_STATE_NAMES = {0: "OK", 1: "WARN", 2: "PAGE"}


def slo_rows(rows: list[dict]) -> list[dict]:
    """Per-peer burn-rate SLO states from the ``lah_slo_<name>_*``
    series (utils/slo.py).  Malformed values render as dashes downstream
    — this only groups what parses."""
    import re as _re

    out = []
    for row in rows:
        m = _collected(row)
        if not isinstance(m, dict):
            continue
        for key in sorted(k for k in m if isinstance(k, str)):
            match = _re.fullmatch(r"lah_slo_(.+)_state", key)
            if not match:
                continue
            slo = match.group(1)
            state = _num(m.get(key), default=-1.0)
            out.append({
                "peer_id": row["peer_id"],
                "slo": slo,
                "state": _SLO_STATE_NAMES.get(int(state), "-"),
                "fast_burn": _num(m.get(f"lah_slo_{slo}_fast_burn")),
                "slow_burn": _num(m.get(f"lah_slo_{slo}_slow_burn")),
                "objective": _num(m.get(f"lah_slo_{slo}_objective")),
            })
    return out


def _q_ms(v) -> str:
    return "-" if v is None else f"{1000.0 * v:.2f}"


def render(rows: list[dict], prefix: str, dead: set[str]) -> str:
    lines = [
        f"lah_top — telemetry.{prefix} — {len(rows)} live peer(s), "
        f"{len(dead)} dead — {time.strftime('%H:%M:%S')}",
        "",
        f"{'PEER':<28} {'ROLE':<8} {'STATE':<9} {'UPTIME':>7} {'RST':>3} "
        f"{'HEALTH':<12} {'JOBS':>8} "
        f"{'QDEPTH':>6} {'OVERLAP':>8} {'PADWASTE':>9} {'DISP':>8} "
        f"{'INFLT':>6} {'HEDGE(w/f)':>11} {'AVG(dg/ok)':>11} "
        f"{'STREAMS':>9} {'SLOTS':>7} {'SHED':>6} "
        f"{'PAGES':>9} {'PFX-HIT':>7}",
    ]
    experts: dict[str, float] = {}
    # replication view (ISSUE 8): how many servers host each uid, which
    # hosted copies are replicas, and which uids run hot anywhere
    expert_hosts: dict[str, int] = {}
    replica_uids: set[str] = set()
    hot_uids: set[str] = set()
    for row in rows:
        m = _collected(row)
        jobs = _num(m.get("lah_server_jobs_processed_total"))
        overlapped = _num(m.get("lah_server_jobs_overlapped_total"))
        rows_total = _num(m.get("lah_server_rows_total"))
        padded = _num(m.get("lah_server_padded_rows_total"))
        denom = rows_total + padded
        rounds = _num(m.get("lah_averaging_rounds_total"))
        degraded = _num(m.get("lah_averaging_degraded_rounds_total"))
        # OVERLAP means the peer's own hot-path overlap: servers report
        # runtime job overlap (dispatch N+1 while N materializes);
        # trainers report the CLIENT dispatch overlap fraction — how much
        # in-flight RPC time the overlapped swarm step hid behind trunk
        # compute (ISSUE 7) — so the dashboard shows who is actually
        # overlapping on either side of the wire
        ovl = (
            overlapped / jobs if jobs
            else _num(m.get("lah_client_overlap_fraction"))
        )
        inflight = int(_num(m.get("lah_client_inflight_dispatches")))
        # hedged replica dispatch (ISSUE 8): wins/fires per trainer —
        # how often a backup replica actually rescued a dispatch
        hedge_w = int(_num(m.get("lah_client_hedge_wins_total")))
        hedge_f = int(_num(m.get("lah_client_hedge_fires_total")))
        state, uptime, rst = peer_lifecycle(row)
        streams, slots, shed, pages, pfx_hits = peer_gateway(row)
        lines.append(
            f"{row['peer_id']:<28.28} {row['role']:<8.8} "
            f"{state:<9.9} {uptime:>7} {rst:>3} "
            f"{peer_health(row):<12} {int(jobs):>8} "
            f"{int(_num(m.get('lah_server_queue_depth'))):>6} "
            f"{ovl:>8.2f} "
            f"{(padded / denom if denom else 0.0):>9.3f} "
            f"{int(_num(m.get('lah_client_dispatches_total'))):>8} "
            f"{inflight:>6} "
            f"{hedge_w:>5}/{hedge_f:<5} "
            f"{int(degraded):>5}/{int(rounds):<5} "
            f"{streams:>9} {slots:>7} {shed:>6} "
            f"{pages:>9} {pfx_hits:>7}"
        )
        for uid, n in _section(row, "experts").items():
            experts[uid] = experts.get(uid, 0) + _num(n)
            expert_hosts[uid] = expert_hosts.get(uid, 0) + 1
        snap = row.get("snapshot") or {}
        replicas = snap.get("replicas")
        if isinstance(replicas, list):
            replica_uids.update(u for u in replicas if isinstance(u, str))
        hot_uids.update(u for u in _section(row, "hot"))
    for peer_id in sorted(dead):
        lines.append(
            f"{peer_id:<28.28} {'?':<8} {'DEAD':<9} {'-':>7} {'-':>3} "
            f"(record expired)"
        )
    if experts:
        lines.append("")
        lines.append(
            "EXPERTS (async update counts merged across servers; REPLICAS "
            "= hosting servers):"
        )
        lines.append(f"  {'UID':<32} {'UPDATES':>10} {'REPLICAS':>9}")
        for uid in sorted(experts):
            flags = ("  HOT" if uid in hot_uids else "") + (
                "  +replica" if uid in replica_uids else ""
            )
            lines.append(
                f"  {uid:<32} {int(experts[uid]):>10} "
                f"{expert_hosts.get(uid, 0):>9}{flags}"
            )
    # placement panel (ISSUE 16): the co-activation pairs trainers
    # measured at the gate (merged, hottest first) with each side's
    # home node(s), plus the migration ledger — per-server outbound
    # counters and, when a rebalancer heartbeats, the driver's
    # completed / failed / aborted-by-SLO totals
    coact: dict[str, float] = {}
    homes: dict[str, set] = {}
    mig_out = mig_fail = 0
    mig_inflight: list[str] = []
    driver = None
    for row in rows:
        for uid in _section(row, "experts"):
            homes.setdefault(uid, set()).add(row["peer_id"])
        pl = _section(row, "dispatch").get("placement")
        if isinstance(pl, dict) and isinstance(pl.get("coact"), dict):
            for key, n in pl["coact"].items():
                if isinstance(key, str):
                    coact[key] = coact.get(key, 0.0) + _num(n)
        srv_pl = _section(row, "placement")
        if srv_pl:
            mig_out += int(_num(srv_pl.get("migrations_out")))
            mig_fail += int(_num(srv_pl.get("migration_failures")))
            moving = srv_pl.get("migration_in_flight")
            if isinstance(moving, str) and moving:
                mig_inflight.append(f"{row['peer_id']}:{moving}")
        drv = _section(row, "placement_driver")
        if drv:
            driver = (row["peer_id"], drv)
    if coact or mig_out or mig_fail or mig_inflight or driver:
        lines.append("")
        lines.append(
            "PLACEMENT (gate co-activation, hottest pairs; HOME = hosting "
            "peers):"
        )
        for key, n in sorted(
            coact.items(), key=lambda kv: (-kv[1], kv[0])
        )[:8]:
            a, _, b = key.partition("|")
            home_a = ",".join(sorted(homes.get(a, ()))) or "?"
            home_b = ",".join(sorted(homes.get(b, ()))) or "?"
            lines.append(
                f"  {key:<44.44} {int(n):>8}  {home_a} | {home_b}"
            )
        mig = f"  migrations: {mig_out} completed, {mig_fail} failed"
        if mig_inflight:
            mig += f", in flight: {', '.join(sorted(mig_inflight))}"
        lines.append(mig)
        if driver is not None:
            peer_id, drv = driver
            moving = drv.get("in_flight")
            lines.append(
                f"  driver {peer_id}: "
                f"{int(_num(drv.get('completed')))} completed, "
                f"{int(_num(drv.get('failed')))} failed, "
                f"{int(_num(drv.get('aborted_slo')))} aborted-by-SLO"
                + (f", moving {moving}" if isinstance(moving, str) else "")
            )
    # speculation panel (ISSUE 17): per-gateway acceptance rate,
    # effective tokens per swarm round-trip and draft overhead share —
    # only gateways running with spec_k > 0 appear (a dash-free panel:
    # spec-off gateways simply have no row)
    spec_rows = []
    for row in rows:
        gw = _section(row, "gateway")
        k = gw.get("spec_k")
        if (
            not isinstance(k, (int, float)) or isinstance(k, bool)
            or k <= 0
        ):
            continue
        draft = _num(gw.get("spec_draft_seconds_total"))
        verify = _num(gw.get("spec_verify_seconds_total"))
        wall = draft + verify
        spec_rows.append((
            row["peer_id"], int(k),
            _num(gw.get("spec_acceptance_rate")),
            _num(gw.get("spec_effective_k")),
            int(_num(gw.get("spec_rounds_total"))),
            draft / wall if wall else 0.0,
        ))
    if spec_rows:
        lines.append("")
        lines.append(
            "SPECULATION (per-gateway; EFF-K = tokens per swarm "
            "round-trip, DRAFT% = drafter share of decode wall time):"
        )
        lines.append(
            f"  {'GATEWAY':<28} {'K':>3} {'ACCEPT':>7} {'EFF-K':>6} "
            f"{'ROUNDS':>8} {'DRAFT%':>7}"
        )
        for peer_id, k, acc, eff, rounds, share in sorted(spec_rows):
            lines.append(
                f"  {peer_id:<28.28} {k:>3} {100 * acc:>6.1f}% "
                f"{eff:>6.2f} {rounds:>8} {100 * share:>6.1f}%"
            )
    # fleet latency panel (ISSUE 19): true quantiles from merged
    # per-peer DDSketches — NOT a max-of-p99s
    fleet = [r for r in fleet_latency_rows(rows) if r["count"]]
    if fleet:
        lines.append("")
        lines.append(
            "FLEET LATENCY (true quantiles from merged sketches; "
            "SOURCE=sketch+MAX ⇒ some peers lacked sketches and are "
            "covered only by the MAX-merged *_p99_ms series):"
        )
        lines.append(
            f"  {'HISTOGRAM':<36} {'COUNT':>8} {'P50ms':>9} {'P95ms':>9} "
            f"{'P99ms':>9} {'SOURCE':<11}"
        )
        for r in fleet:
            lines.append(
                f"  {r['name']:<36.36} {r['count']:>8} "
                f"{_q_ms(r['p50']):>9} {_q_ms(r['p95']):>9} "
                f"{_q_ms(r['p99']):>9} {r['source']:<11}"
            )
    # SLO panel (ISSUE 19): per-peer burn-rate objective states
    slos = slo_rows(rows)
    if slos:
        lines.append("")
        lines.append("SLO (burn-rate objectives; PAGE ⇒ flight artifact "
                     "dumped on the peer):")
        lines.append(
            f"  {'PEER':<28} {'SLO':<20} {'STATE':<6} {'FAST':>7} "
            f"{'SLOW':>7} {'OBJ':>7}"
        )
        for r in slos:
            lines.append(
                f"  {r['peer_id']:<28.28} {r['slo']:<20.20} "
                f"{r['state']:<6} {r['fast_burn']:>7.2f} "
                f"{r['slow_burn']:>7.2f} {r['objective']:>7.4f}"
            )
    # span-level latency only exists on peers running LAH_PROFILE=1
    p99 = {}
    for row in rows:
        for name, s in _section(row, "spans").items():
            if (
                isinstance(s, dict)
                and name.startswith("runtime.")
                and name.count(".") == 1
            ):
                p99[f"{row['peer_id']}:{name}"] = _num(s.get("p99_ms"))
    if p99:
        lines.append("")
        lines.append("RUNTIME p99 (profiled peers):")
        for k in sorted(p99):
            lines.append(f"  {k:<48} {p99[k]:>10.3f} ms")
    return "\n".join(lines)


def dump_trace(rows: list[dict], path: str) -> int:
    """Merge every reachable peer's /trace events into one Chrome trace
    file (each peer's events already carry its own pid).  Fetches run
    concurrently, and only against peers the snapshot pass already
    reached — dead endpoints don't burn a second round of timeouts."""
    from concurrent.futures import ThreadPoolExecutor

    from learning_at_home_tpu_torch.utils.telemetry import fetch_trace_events

    alive = [r for r in rows if r["snapshot"] is not None]
    events: list = []
    if alive:
        with ThreadPoolExecutor(max_workers=min(16, len(alive))) as pool:
            for chunk in pool.map(
                lambda r: fetch_trace_events(r["endpoint"]), alive
            ):
                events.extend(chunk)
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return len(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--prefix", default="swarm",
                    help="telemetry.<prefix> DHT scope to watch")
    ap.add_argument("--initial-peers", nargs="+", required=True,
                    help="host:port of existing DHT peers (bootstrap only "
                         "— metrics endpoints are DISCOVERED, never typed)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (0 iff ≥1 peer found)")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--json", action="store_true",
                    help="emit the raw merged snapshot as JSON")
    ap.add_argument("--dump-trace", default=None, metavar="PATH",
                    help="also merge every peer's /trace into one Chrome "
                         "trace_event file")
    args = ap.parse_args(argv)

    from learning_at_home_tpu_torch.dht import DHT

    dht = DHT(initial_peers=[parse_endpoint(s) for s in args.initial_peers])
    seen: set[str] = set()
    try:
        while True:
            rows = collect_snapshot(dht, args.prefix)
            alive = {r["peer_id"] for r in rows}
            dead = seen - alive
            seen |= alive
            if args.json:
                print(json.dumps({
                    "prefix": args.prefix,
                    "peers": [
                        {**r, "endpoint": list(r["endpoint"]),
                         "health": peer_health(r)}
                        for r in rows
                    ],
                    "dead": sorted(dead),
                }), flush=True)
            else:
                if not args.once:
                    print("\x1b[2J\x1b[H", end="")  # clear screen, go home
                print(render(rows, args.prefix, dead), flush=True)
            if args.dump_trace:
                n = dump_trace(rows, args.dump_trace)
                print(f"# wrote {n} trace events to {args.dump_trace}",
                      flush=True)
            if args.once:
                return 0 if rows else 1
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        dht.shutdown()


if __name__ == "__main__":
    sys.exit(main())
