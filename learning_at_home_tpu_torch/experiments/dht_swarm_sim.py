#!/usr/bin/env python
"""Simulated DHT swarm: hundreds-to-thousands of virtual Kademlia nodes
in ONE process, on ONE event loop.

The port of ``experiments/dht_swarm_sim.py`` over the port's ``dht/`` and
``sim/``, with its flags, floors and report; host-only (no device work).

Real sockets cap a single box at a few hundred nodes (fd limits, kernel
accept queues, per-connection buffers) and drown the measurement in
transport noise.  Here every node runs the REAL ``DHTNode`` /
``DHTProtocol`` code — routing tables, iterative lookups, adaptive
timeouts, batched stores — and only the one-request/one-reply exchange
(``DHTProtocol._transport``) is swapped for an in-process delivery shim,
so the control-plane numbers this reports are the protocol's, not the
kernel's.  Dead peers behave like dead sockets: the caller waits its own
adaptive timeout and gets nothing.

Three tracked measurements per swarm size:

- **join**: per-node wall-clock to bootstrap into the swarm (sequential
  joins against a single seed node — the worst-case star topology);
- **heartbeat A/B**: one server heartbeat's records (expert declares +
  prefix fan-in + telemetry/load/wanted sidecars) stored per-key vs
  coalesced through ``store_many``, with the
  store-RPC reduction counter-asserted in the same run;
- **lookup hit-rate under churn**: scheduled kill-and-replace rounds
  while a publisher heartbeats its records; random alive nodes then
  resolve random expert uids.

Examples:
  python -m learning_at_home_tpu_torch.experiments.dht_swarm_sim \\
      --sizes 128,512,1024 --check
  python -m learning_at_home_tpu_torch.experiments.dht_swarm_sim \\
      --sizes 128 --experts 64 --churn-rounds 2 --lookups 150 --check
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time
from typing import Any, Optional

from learning_at_home_tpu_torch.dht.node import DHTNode
from learning_at_home_tpu_torch.dht.protocol import PLAIN_SUBKEY
from learning_at_home_tpu_torch.dht.routing import Endpoint
# the simulated fabric (SimNetwork / SimDHTProtocol / spawn_node) and
# the clock/churn machinery live in the sim package, shared with the
# whole-system macro-sim; this experiment runs on wall time by default.
from learning_at_home_tpu_torch.sim.clock import WallClock
from learning_at_home_tpu_torch.sim.net import SIM_HOST, SimNetwork, spawn_node
from learning_at_home_tpu_torch.sim.trace import churn_rounds as churn_schedule
from learning_at_home_tpu_torch.utils.telemetry import (
    load_key,
    replicas_wanted_key,
    telemetry_key,
)
from learning_at_home_tpu_torch.utils.timed_storage import get_dht_time

__all__ = ["SIM_HOST", "SimNetwork", "spawn_node", "heartbeat_entries",
           "heartbeat_ab", "run_size", "main"]


# ---------------- heartbeat record bundle (mirrors DHT._declare) ----------------


def heartbeat_entries(
    prefix: str, n_experts: int, endpoint: Endpoint, ttl: float
) -> list[tuple]:
    """One server heartbeat's full record bundle: per-uid full records,
    the shared prefix record's per-uid subkeys, and the telemetry /
    load / replicas-wanted sidecars."""
    now = get_dht_time()
    exp = now + ttl
    value = [endpoint[0], int(endpoint[1])]
    ep_key = f"{endpoint[0]}:{int(endpoint[1])}"
    uids = [f"{prefix}.{i}" for i in range(n_experts)]
    entries: list[tuple] = [(uid, f"@{ep_key}", value, exp) for uid in uids]
    entries += [(prefix, f"{uid}@{ep_key}", value, exp) for uid in uids]
    entries.append(
        (telemetry_key(prefix), PLAIN_SUBKEY, {"endpoint": ep_key}, exp)
    )
    entries.append((load_key(prefix), f"@{ep_key}", [0.5, n_experts], exp))
    entries.append(
        (replicas_wanted_key(prefix), uids[0], [1.0, *value], exp)
    )
    return entries


async def heartbeat_ab(node: DHTNode, make_entries, clock=WallClock()) -> dict:
    """Store one heartbeat bundle twice — per-key (baseline) then
    coalesced — and report the store-RPC counts from the publisher's
    own ``rpcs_sent`` counter (the same-run A/B the acceptance asks
    for).  Acks must be all-True both ways.  ``make_entries`` is called
    per pass: a real heartbeat stamps fresh expirations each period,
    and the timed storage rejects non-newer re-stores."""
    entries = make_entries()
    by_key: dict[Any, list[tuple]] = {}
    for e in entries:
        by_key.setdefault(e[0], []).append(e)

    def stores() -> int:
        return node.protocol.rpcs_sent.get("store", 0)

    t0 = clock.monotonic()
    base = stores()
    for group in by_key.values():
        acks = await node.store_many(group)
        assert all(acks), "per-key baseline store failed"
    per_key_rpcs = stores() - base
    per_key_s = clock.monotonic() - t0

    t0 = clock.monotonic()
    base = stores()
    acks = await node.store_many(make_entries())
    assert all(acks), "coalesced store failed"
    coalesced_rpcs = stores() - base
    coalesced_s = clock.monotonic() - t0
    return {
        "keys": len(by_key),
        "records": len(entries),
        "store_rpcs_per_key": per_key_rpcs,
        "store_rpcs_coalesced": coalesced_rpcs,
        "reduction": round(per_key_rpcs / max(1, coalesced_rpcs), 2),
        "per_key_s": round(per_key_s, 3),
        "coalesced_s": round(coalesced_s, 3),
    }


# ---------------- one swarm size: join + A/B + churn hit-rate ----------------


async def run_size(
    n: int,
    experts: int,
    churn_rounds: int,
    churn_fraction: float,
    churn_wait: float,
    lookups: int,
    rpc_timeout: float,
    latency: float,
    record_ttl: float,
    rng: random.Random,
    clock=WallClock(),
) -> dict:
    network = SimNetwork(latency=latency)
    seed = await spawn_node(network, rpc_timeout=rpc_timeout)
    nodes = [seed]
    join_times: list[float] = []
    for _ in range(n - 1):
        t0 = clock.monotonic()
        nodes.append(
            await spawn_node(
                network, initial_peers=[seed.endpoint],
                rpc_timeout=rpc_timeout,
            )
        )
        join_times.append(clock.monotonic() - t0)
    join_times.sort()
    join = {
        "total_s": round(sum(join_times), 3),
        "mean_ms": round(1e3 * sum(join_times) / max(1, len(join_times)), 3),
        "p99_ms": round(
            1e3 * join_times[min(len(join_times) - 1,
                                 int(0.99 * len(join_times)))], 3
        ),
    }

    publisher = nodes[1]
    prefix = "simffn"
    # production-shaped record TTL: several heartbeat periods, NOT tied
    # to the churn pacing — expiry must stay the failure detector for
    # dead publishers, not a clock racing the measurement itself (the
    # sim's dead-peer stalls are real seconds while its transport is
    # instant, so a too-small TTL would measure expiry, not routing)
    hb_ttl = record_ttl
    ab = await heartbeat_ab(
        publisher,
        lambda: heartbeat_entries(prefix, experts, publisher.endpoint, hb_ttl),
        clock=clock,
    )

    # -- churn: kill-and-replace rounds against a heartbeating publisher --
    stop = asyncio.Event()

    async def heartbeat_forever() -> None:
        # several heartbeats per record TTL, like a real server's
        # update_period vs its expiration
        period = min(max(churn_wait / 2, 0.25), record_ttl / 4)
        while not stop.is_set():
            fresh = heartbeat_entries(
                prefix, experts, publisher.endpoint, hb_ttl
            )
            await publisher.store_many(fresh)
            try:
                await asyncio.wait_for(stop.wait(), timeout=period)
            except asyncio.TimeoutError:
                pass

    hb_task = asyncio.get_running_loop().create_task(heartbeat_forever())
    uids = [f"{prefix}.{i}" for i in range(experts)]
    want_subkey = (
        f"@{publisher.endpoint[0]}:{int(publisher.endpoint[1])}"
    )
    hits = 0
    total = 0
    lookup_times: list[float] = []
    killed_total = 0
    # the kill schedule in the shared trace vocabulary (sim/trace.py):
    # one kill event per round, paced at the settle interval
    schedule = churn_schedule(
        max(1, churn_rounds), churn_fraction, every_s=churn_wait
    )
    try:
        for event in schedule:
            killable = [
                nd for nd in nodes[2:]
                if nd.protocol.listen_port in network._by_port
            ]
            n_kill = int(len(killable) * event.fraction)
            victims = rng.sample(killable, n_kill) if n_kill else []
            for v in victims:
                await v.shutdown()
            killed_total += len(victims)
            # scheduled churn keeps the swarm size constant: every kill
            # round is matched by fresh joiners bootstrapping mid-run —
            # concurrently, as real rejoining hosts would (a sequential
            # respawn would serialize each joiner's dead-peer stalls
            # into half a minute of pure setup)
            nodes.extend(
                await asyncio.gather(
                    *(
                        spawn_node(
                            network, initial_peers=[seed.endpoint],
                            rpc_timeout=rpc_timeout,
                        )
                        for _ in range(len(victims))
                    )
                )
            )
            await asyncio.sleep(churn_wait)

            alive = [
                nd for nd in nodes
                if nd.protocol.listen_port in network._by_port
            ]

            async def one_lookup() -> bool:
                q = rng.choice(alive)
                uid = rng.choice(uids)
                t0 = clock.monotonic()
                rec = await q.get(uid)
                lookup_times.append(clock.monotonic() - t0)
                return want_subkey in rec

            n_round = max(1, lookups // max(1, churn_rounds))
            results = await asyncio.gather(
                *(one_lookup() for _ in range(n_round))
            )
            hits += sum(results)
            total += len(results)
    finally:
        stop.set()
        await hb_task
        for nd in nodes:
            await nd.shutdown()

    lookup_times.sort()
    return {
        "nodes": n,
        "experts": experts,
        "join": join,
        "heartbeat": ab,
        "churn": {
            "rounds": churn_rounds,
            "fraction": churn_fraction,
            "killed": killed_total,
            "lookups": total,
            "hit_rate": round(hits / max(1, total), 4),
            "lookup_p50_ms": round(
                1e3 * lookup_times[len(lookup_times) // 2], 3
            ) if lookup_times else None,
            "lookup_p99_ms": round(
                1e3 * lookup_times[min(len(lookup_times) - 1,
                                       int(0.99 * len(lookup_times)))], 3
            ) if lookup_times else None,
        },
        "rpcs": dict(sorted(network.rpcs.items())),
    }


def check(report: dict, args) -> list[str]:
    """Floor assertions for --check mode."""
    problems = []
    sizes = report["sizes"]
    for r in sizes:
        if r["churn"]["hit_rate"] < args.hit_rate_floor:
            problems.append(
                f"{r['nodes']} nodes: hit_rate {r['churn']['hit_rate']} "
                f"< floor {args.hit_rate_floor}"
            )
        if r["heartbeat"]["reduction"] < args.reduction_floor:
            problems.append(
                f"{r['nodes']} nodes: store-RPC reduction "
                f"{r['heartbeat']['reduction']}x < floor "
                f"{args.reduction_floor}x"
            )
    if len(sizes) >= 2:
        first, last = sizes[0], sizes[-1]
        size_ratio = last["nodes"] / first["nodes"]
        join_ratio = (
            last["join"]["mean_ms"] / max(1e-9, first["join"]["mean_ms"])
        )
        report["join_scaling"] = {
            "size_ratio": round(size_ratio, 2),
            "join_ratio": round(join_ratio, 2),
            "sublinear": join_ratio < size_ratio,
        }
        if join_ratio >= size_ratio:
            problems.append(
                f"per-node join grew {join_ratio:.2f}x over a "
                f"{size_ratio:.2f}x size increase (not sublinear)"
            )
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", default="128,512,1024",
                   help="comma-separated swarm sizes (virtual nodes)")
    p.add_argument("--experts", type=int, default=256,
                   help="experts per simulated server heartbeat")
    p.add_argument("--churn-rounds", type=int, default=3)
    p.add_argument("--churn-fraction", type=float, default=0.1,
                   help="fraction of nodes killed-and-replaced per round")
    p.add_argument("--churn-wait", type=float, default=1.0,
                   help="settle time after each churn round (s); the "
                        "publisher heartbeats at half this period")
    p.add_argument("--lookups", type=int, default=300,
                   help="total lookups across all churn rounds")
    p.add_argument("--rpc-timeout", type=float, default=0.25,
                   help="adaptive-timeout ceiling for virtual nodes; "
                        "scaled below the production 0.8 s default "
                        "because the shim's RTTs are ~0 while its "
                        "dead-peer stalls burn REAL wall-clock — the "
                        "ceiling-to-RTT ratio stays conservative")
    p.add_argument("--record-ttl", type=float, default=30.0,
                   help="expert record expiration (s); heartbeats "
                        "re-declare several times per TTL")
    p.add_argument("--latency", type=float, default=0.0,
                   help="simulated per-RPC one-way latency (s)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check", action="store_true",
                   help="assert floors; exit 1 and print violations")
    p.add_argument("--hit-rate-floor", type=float, default=0.99)
    p.add_argument("--reduction-floor", type=float, default=4.0)
    p.add_argument("--json", default=None, help="write the report here too")
    args = p.parse_args(argv)

    rng = random.Random(args.seed)
    sizes = [int(s) for s in args.sizes.split(",") if s]
    report: dict = {"metric": "dht_swarm_sim", "sizes": []}
    for n in sizes:
        t0 = time.monotonic()
        r = asyncio.run(
            run_size(
                n, args.experts, args.churn_rounds, args.churn_fraction,
                args.churn_wait, args.lookups, args.rpc_timeout,
                args.latency, args.record_ttl, rng,
            )
        )
        r["wall_s"] = round(time.monotonic() - t0, 2)
        report["sizes"].append(r)
        print(json.dumps(r), flush=True)

    problems = check(report, args) if args.check else []
    if "join_scaling" in report:
        print(json.dumps({"join_scaling": report["join_scaling"]}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    if problems:
        for pr in problems:
            print(f"DHT_SWARM_SIM_FAIL: {pr}", file=sys.stderr)
        return 1
    if args.check:
        print("DHT_SWARM_SIM_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
