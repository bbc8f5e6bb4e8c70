#!/usr/bin/env python
"""Macro-sim scenario orchestration + CLI.

The port's copy of ``learning_at_home_tpu/sim/runner.py``: the same
scenario at the same seed prints the same bytes.

Runs a whole-system swarm — plain DHT peers, expert servers, gateways —
in ONE process on ONE virtual clock, driven by a
:mod:`~learning_at_home_tpu_torch.sim.trace` arrival trace with scheduled
churn, and reports fleet throughput, shed fraction, TTFT/ITL tails
per trace segment, join/lookup health and placement-convergence cost as
one seeded, byte-deterministic JSON series.

The report deliberately contains NO wall-clock values, no ids derived
from ``os.urandom``/``uuid`` and no unsorted iteration — two runs at the
same seed and trace produce byte-identical canonical JSON (the
determinism contract).  Wall time goes to
stderr only.

Examples::

    python -m learning_at_home_tpu_torch.sim.runner --nodes 200 --servers 48 \\
        --gateways 4 --experts 64 \\
        --trace "poisson:60:6,burst:420:3" --churn "4:kill:0.15" --check

    python -m learning_at_home_tpu_torch.sim.runner --nodes 2048 --servers 256 \\
        --gateways 16 --experts 256 \\
        --trace "poisson:180:40,burst:900:10,diurnal:220:50:0.5:25" \\
        --churn "35:kill:0.1,60:join:26"
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time
from typing import Optional

from learning_at_home_tpu_torch.dht.routing import DHTID
from learning_at_home_tpu_torch.sim.clock import (
    VirtualClock,
    installed_entropy,
    run_virtual,
)
from learning_at_home_tpu_torch.sim.net import SIM_HOST, SimNetwork, spawn_node
from learning_at_home_tpu_torch.sim.serving import (
    LinkModel,
    SimGateway,
    VirtualExpertServer,
    pair_rng,
)
from learning_at_home_tpu_torch.sim.trace import Trace, parse_trace, trace_to_json
from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.telemetry import links_key, parse_links_value

# @runs_on("host") sites that legitimately execute ON the sim's event
# loop: the whole swarm is single-threaded on the virtual clock, so the
# "never block a loop" rationale behind the assertion does not apply
# (the macro-sim relaxation).
RELAXED_SITES = ("routing.cost_bias",)

DEFAULT_PREFIX = "sim_ffn"


def _pct(values, q) -> float:
    # shared percentile engine: "nearest" is the nearest-rank formula
    # (banker's rounding included) — the report stays byte-deterministic
    # per seed
    from learning_at_home_tpu_torch.utils.sketch import percentile

    return percentile(values, q, method="nearest", default=0.0)


def canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class Scenario:
    """One macro-sim run's mutable world state."""

    def __init__(self, cfg: dict, clock: VirtualClock):
        self.cfg = cfg
        self.clock = clock
        self.seed = int(cfg["seed"])
        self.prefix = cfg.get("prefix", DEFAULT_PREFIX)
        self.link_model = LinkModel(self.seed, n_clusters=cfg["clusters"])
        self.network = SimNetwork(latency_fn=self.link_model.delivery_delay)
        self.rng_ids = random.Random(f"{self.seed}|ids")
        self.rng_arrivals = random.Random(f"{self.seed}|arrivals")
        self.rng_work = random.Random(f"{self.seed}|work")
        self.rng_churn = random.Random(f"{self.seed}|churn")
        self.rng_probe = random.Random(f"{self.seed}|probe")
        self.plain_nodes: list = []
        self.servers: list = []            # VirtualExpertServer, spawn order
        self.servers_by_port: dict = {}    # port -> VirtualExpertServer
        self.gateways: list = []
        self.join_times: list = []
        self.join_failures = 0
        self.lookup_times: list = []
        self.lookup_hits = 0
        self.lookups_total = 0
        self.placement_rounds: list = []
        self.arrivals = 0
        self.arrivals_by_bucket: dict = {}
        self.shed_by_bucket: dict = {}
        self.killed_servers = 0
        self.joined_servers = 0

    def _next_node_id(self) -> DHTID:
        return DHTID(self.rng_ids.getrandbits(160))

    # ---- swarm construction ----

    async def _spawn_timed(self, peers, **kwargs):
        t0 = self.clock.monotonic()
        node = await spawn_node(
            self.network, initial_peers=peers,
            rpc_timeout=self.cfg["rpc_timeout"], clock=self.clock,
            node_id=self._next_node_id(), **kwargs,
        )
        self.join_times.append(self.clock.monotonic() - t0)
        if not any(
            b.peers for b in node.routing_table.buckets
        ) and peers:
            self.join_failures += 1
        return node

    async def build_swarm(self) -> None:
        cfg = self.cfg
        seed_node = await self._spawn_timed(())
        seed_ep = (SIM_HOST, seed_node.protocol.listen_port)
        self.plain_nodes.append(seed_node)
        n_plain = max(
            0, cfg["nodes"] - 1 - cfg["servers"] - cfg["gateways"]
        )
        batch = max(1, int(cfg["join_batch"]))

        async def join_many(n, **kwargs):
            out = []
            for i in range(0, n, batch):
                out.extend(await asyncio.gather(*(
                    self._spawn_timed((seed_ep,), **kwargs)
                    for _ in range(min(batch, n - i))
                )))
            return out

        self.plain_nodes.extend(await join_many(n_plain))
        server_nodes = await join_many(cfg["servers"])
        gateway_nodes = await join_many(cfg["gateways"])

        uids = [f"{self.prefix}.{i}" for i in range(cfg["experts"])]
        assign: dict[int, list] = {i: [] for i in range(cfg["servers"])}
        for i, uid in enumerate(uids):
            assign[i % cfg["servers"]].append(uid)
        for i, node in enumerate(server_nodes):
            srv = VirtualExpertServer(
                node, clock=self.clock, link_model=self.link_model,
                prefix=self.prefix, experts=assign[i],
                rng=random.Random(f"{self.seed}|srv{i}"),
                base_service_s=cfg["base_service_s"],
                per_token_s=cfg["per_token_s"],
                hb_period_s=cfg["hb_period_s"],
                record_ttl_s=cfg["record_ttl_s"],
            )
            self.servers.append(srv)
            self.servers_by_port[srv.port] = srv
        server_ports = sorted(self.servers_by_port)
        for srv in self.servers:
            k = server_ports.index(srv.port)
            ring = server_ports[k + 1:] + server_ports[:k]
            srv.peer_ports = ring[:16]
        # first declare lands BEFORE traffic so gateways can discover
        for i in range(0, len(self.servers), batch):
            await asyncio.gather(*(
                s.heartbeat_once() for s in self.servers[i:i + batch]
            ))
        for srv in self.servers:
            srv.start_heartbeat()
            srv.dht.start_maintenance(cfg["maintenance_s"])
        for i, node in enumerate(gateway_nodes):
            gw = SimGateway(
                f"gw{i}", node, clock=self.clock, network=self.network,
                link_model=self.link_model,
                servers_by_port=self.servers_by_port,
                prefix=self.prefix, n_experts=cfg["experts"],
                seed=self.seed, max_slots=cfg["slots"],
                fanout_k=cfg["fanout"],
                alive_ttl_s=cfg["alive_ttl_s"],
                mirror_period_s=cfg["mirror_period_s"],
                base_step_s=cfg["base_step_s"],
                max_pending=cfg["max_pending"] or None,
            )
            await gw.mirror.refresh_once()
            gw.start()
            node.start_maintenance(cfg["maintenance_s"])
            self.gateways.append(gw)

    # ---- the actors ----

    async def inject_arrivals(self, trace: Trace) -> None:
        cfg = self.cfg
        seg_ends, acc = [], 0.0
        for s in trace.segments:
            acc += s.duration_s
            seg_ends.append(acc)
        t_start = self.clock.monotonic()
        i = 0
        for t in trace.iter_arrivals(self.rng_arrivals):
            dt = (t_start + t) - self.clock.monotonic()
            if dt > 0:
                await asyncio.sleep(dt)
            seg_idx = next(
                j for j, end in enumerate(seg_ends) if t < end
            )
            bucket = f"seg{seg_idx}_{trace.segments[seg_idx].kind}"
            p_len = self.rng_work.randint(*cfg["prompt_len"])
            max_new = self.rng_work.randint(*cfg["max_new"])
            prompt = [
                self.rng_work.randrange(256) for _ in range(p_len)
            ]
            gw = self.gateways[i % len(self.gateways)]
            i += 1
            self.arrivals += 1
            self.arrivals_by_bucket[bucket] = (
                self.arrivals_by_bucket.get(bucket, 0) + 1
            )
            if not gw.submit_arrival(prompt, max_new, bucket):
                self.shed_by_bucket[bucket] = (
                    self.shed_by_bucket.get(bucket, 0) + 1
                )

    async def run_churn(self, trace: Trace) -> None:
        t_start = self.clock.monotonic()
        for ev in trace.churn:
            dt = (t_start + ev.at_s) - self.clock.monotonic()
            if dt > 0:
                await asyncio.sleep(dt)
            if ev.kind == "kill":
                alive = [s for s in self.servers if s.alive]
                n_kill = max(1, int(len(alive) * ev.fraction))
                for srv in self.rng_churn.sample(alive, min(n_kill, len(alive))):
                    await srv.kill(self.network)
                    self.killed_servers += 1
            elif ev.kind == "join":
                await self._join_servers(ev.count)

    async def _join_servers(self, count: int) -> None:
        """Replacement capacity: new servers adopt the experts with the
        fewest alive hosts (sorted for determinism)."""
        cfg = self.cfg
        coverage: dict[str, int] = {}
        for uid in (f"{self.prefix}.{i}" for i in range(cfg["experts"])):
            coverage[uid] = 0
        for srv in self.servers:
            if srv.alive:
                for uid in srv.experts:
                    if uid in coverage:
                        coverage[uid] += 1
        ranked = sorted(coverage, key=lambda u: (coverage[u], u))
        per = max(1, cfg["experts"] // max(1, cfg["servers"]))
        seed_ep = (SIM_HOST, self.plain_nodes[0].protocol.listen_port)
        for j in range(int(count)):
            node = await self._spawn_timed((seed_ep,))
            take = ranked[j * per:(j + 1) * per] or ranked[:per]
            idx = len(self.servers)
            srv = VirtualExpertServer(
                node, clock=self.clock, link_model=self.link_model,
                prefix=self.prefix, experts=list(take),
                rng=random.Random(f"{self.seed}|srv{idx}"),
                base_service_s=cfg["base_service_s"],
                per_token_s=cfg["per_token_s"],
                hb_period_s=cfg["hb_period_s"],
                record_ttl_s=cfg["record_ttl_s"],
            )
            srv.peer_ports = sorted(
                p for p, s in self.servers_by_port.items() if s.alive
            )[:16]
            self.servers.append(srv)
            self.servers_by_port[srv.port] = srv
            await srv.heartbeat_once()
            srv.start_heartbeat()
            self.joined_servers += 1

    async def probe_lookups(self) -> None:
        cfg = self.cfg
        while True:
            await asyncio.sleep(cfg["lookup_period_s"])
            uid = f"{self.prefix}.{self.rng_probe.randrange(cfg['experts'])}"
            gw = self.gateways[self.rng_probe.randrange(len(self.gateways))]
            t0 = self.clock.monotonic()
            records = await gw.dht.get(uid)
            self.lookup_times.append(self.clock.monotonic() - t0)
            self.lookups_total += 1
            hit = False
            for _sk, (value, _exp) in sorted(
                records.items(), key=lambda kv: str(kv[0])
            ):
                if isinstance(value, (list, tuple)) and len(value) == 2:
                    srv = self.servers_by_port.get(int(value[1]))
                    if srv is not None and srv.alive and uid in srv.experts:
                        hit = True
                        break
            if hit:
                self.lookup_hits += 1

    # ---- placement (real analysis/placement.py over DHT-read links) ----

    async def build_placement_snapshot(self) -> dict:
        experts: dict[str, str] = {}
        for srv in sorted(self.servers, key=lambda s: s.port):
            if not srv.alive:
                continue
            ep = f"{SIM_HOST}:{srv.port}"
            for uid in srv.experts:
                experts.setdefault(uid, ep)
        activations: dict[str, int] = {}
        coact: dict[str, int] = {}
        for gw in self.gateways:
            for uid, n in gw.activations.items():
                activations[uid] = activations.get(uid, 0) + n
            for (u, v), n in gw.coact.items():
                key = f"{u}|{v}"
                coact[key] = coact.get(key, 0) + n
        links: dict[str, dict] = {}
        recs = await self.gateways[0].dht.get(links_key(self.prefix))
        for subkey in sorted(recs, key=str):
            value, _exp = recs[subkey]
            if not (isinstance(subkey, str) and subkey.startswith("@")):
                continue
            parsed = parse_links_value(value)
            if parsed:
                links[subkey[1:]] = {
                    dst: [ent["rtt_s"], ent["bw_bps"]]
                    for dst, ent in sorted(parsed.items())
                }
        return {
            "experts": experts,
            "activations": activations,
            "coact": coact,
            "links": links,
        }

    async def run_placement(self) -> None:
        from learning_at_home_tpu_torch.analysis.placement import solve

        cfg = self.cfg
        while True:
            await asyncio.sleep(cfg["placement_period_s"])
            snapshot = await self.build_placement_snapshot()
            plan = solve(
                snapshot, seed=self.seed,
                max_moves=cfg["placement_moves"],
            )
            by_ep = {
                f"{SIM_HOST}:{p}": s for p, s in self.servers_by_port.items()
            }
            applied = 0
            for mv in plan["moves"]:
                src = by_ep.get(mv["from"])
                dst = by_ep.get(mv["to"])
                if src is None or dst is None or not dst.alive:
                    continue
                if mv["uid"] in src.experts:
                    src.experts.remove(mv["uid"])
                    dst.experts.append(mv["uid"])
                    applied += 1
            self.placement_rounds.append({
                "t": round(self.clock.monotonic(), 3),
                "cost_before": plan["cost_before"],
                "cost_after": plan["cost_after"],
                "moves": len(plan["moves"]),
                "applied": applied,
            })

    # ---- teardown + report ----

    async def shutdown(self) -> None:
        for gw in self.gateways:
            gw.mirror.stop()
        for srv in self.servers:
            if srv.alive:
                await srv.kill(self.network)
        for node in (
            self.plain_nodes
            + [s.dht for s in self.servers]
            + [g.dht for g in self.gateways]
        ):
            await node.shutdown()

    def report(self, trace: Trace) -> dict:
        cfg = self.cfg
        ttfts = [v for gw in self.gateways for (_b, v) in gw.ttfts]
        itls = [v for gw in self.gateways for (_b, v) in gw.itls]
        completed = sum(gw.completed for gw in self.gateways)
        errored = sum(gw.errored for gw in self.gateways)
        shed = sum(gw.shed for gw in self.gateways)
        tokens = sum(gw.tokens_served for gw in self.gateways)
        v_end = round(self.clock.monotonic(), 3)
        buckets = {}
        for bucket in sorted(self.arrivals_by_bucket):
            b_ttft = [
                v for gw in self.gateways
                for (b, v) in gw.ttfts if b == bucket
            ]
            b_itl = [
                v for gw in self.gateways
                for (b, v) in gw.itls if b == bucket
            ]
            buckets[bucket] = {
                "arrivals": self.arrivals_by_bucket[bucket],
                "shed": self.shed_by_bucket.get(bucket, 0),
                "ttft_p50_ms": round(_pct(b_ttft, 50) * 1e3, 1),
                "ttft_p99_ms": round(_pct(b_ttft, 99) * 1e3, 1),
                "itl_p50_ms": round(_pct(b_itl, 50) * 1e3, 1),
                "itl_p99_ms": round(_pct(b_itl, 99) * 1e3, 1),
            }
        placement = {
            "rounds": self.placement_rounds,
            "cost_initial": (
                self.placement_rounds[0]["cost_before"]
                if self.placement_rounds else None
            ),
            "cost_final": (
                self.placement_rounds[-1]["cost_after"]
                if self.placement_rounds else None
            ),
        }
        return {
            "config": {
                "seed": self.seed,
                "nodes": cfg["nodes"],
                "servers": cfg["servers"],
                "gateways": cfg["gateways"],
                "experts": cfg["experts"],
                "slots": cfg["slots"],
                "fanout": cfg["fanout"],
                "trace": trace_to_json(trace),
            },
            "swarm": {
                "joins": len(self.join_times),
                "join_failures": self.join_failures,
                "join_mean_ms": round(
                    sum(self.join_times) / len(self.join_times) * 1e3, 2
                ) if self.join_times else 0.0,
                "join_p99_ms": round(_pct(self.join_times, 99) * 1e3, 2),
                "killed": self.killed_servers,
                "joined": self.joined_servers,
            },
            "traffic": {
                "arrivals": self.arrivals,
                "completed": completed,
                "errored": errored,
                "shed": shed,
                "shed_fraction": round(
                    shed / self.arrivals, 4
                ) if self.arrivals else 0.0,
                "tokens_served": tokens,
                "fleet_tok_s": round(tokens / v_end, 2) if v_end else 0.0,
                "ttft_p50_ms": round(_pct(ttfts, 50) * 1e3, 1),
                "ttft_p99_ms": round(_pct(ttfts, 99) * 1e3, 1),
                "itl_p50_ms": round(_pct(itls, 50) * 1e3, 1),
                "itl_p99_ms": round(_pct(itls, 99) * 1e3, 1),
                "segments": buckets,
            },
            "dht": {
                "lookups": self.lookups_total,
                "hit_rate": round(
                    self.lookup_hits / self.lookups_total, 4
                ) if self.lookups_total else 1.0,
                "lookup_p50_ms": round(
                    _pct(self.lookup_times, 50) * 1e3, 2
                ),
                "lookup_p99_ms": round(
                    _pct(self.lookup_times, 99) * 1e3, 2
                ),
                "rpcs": {k: self.network.rpcs[k]
                         for k in sorted(self.network.rpcs)},
            },
            "routing": {
                "selection_rounds": sum(
                    gw.selection_rounds for gw in self.gateways
                ),
                "no_alive_rounds": sum(
                    gw.no_alive_rounds for gw in self.gateways
                ),
                "bias_applied": sum(
                    gw.cost.bias_applied for gw in self.gateways
                ),
                "link_fallbacks": sum(
                    gw.cost.link_fallbacks for gw in self.gateways
                ),
            },
            "placement": placement,
            "virtual_duration_s": v_end,
        }


async def _run(cfg: dict, clock: VirtualClock, trace: Trace) -> dict:
    sc = Scenario(cfg, clock)
    await sc.build_swarm()
    churn_task = asyncio.get_running_loop().create_task(
        sc.run_churn(trace), name="churn"
    )
    probe_task = asyncio.get_running_loop().create_task(
        sc.probe_lookups(), name="probe"
    )
    placement_task = asyncio.get_running_loop().create_task(
        sc.run_placement(), name="placement"
    )
    await sc.inject_arrivals(trace)
    await churn_task
    for gw in sc.gateways:
        await gw.drain_and_stop()
    for task in (probe_task, placement_task):
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
    report = sc.report(trace)
    await sc.shutdown()
    return report


def run_macro_sim(
    *,
    seed: int = 0,
    nodes: int = 200,
    servers: int = 48,
    gateways: int = 4,
    experts: int = 64,
    trace: str = "poisson:60:6,burst:360:3",
    churn: str = "4:kill:0.15",
    slots: int = 64,
    fanout: int = 2,
    clusters: int = 4,
    prompt_len: tuple = (4, 12),
    max_new: tuple = (8, 16),
    rpc_timeout: float = 0.8,
    join_batch: int = 32,
    hb_period_s: float = 15.0,
    record_ttl_s: float = 45.0,
    alive_ttl_s: float = 3.0,
    mirror_period_s: float = 5.0,
    maintenance_s: float = 60.0,
    base_service_s: float = 0.004,
    per_token_s: float = 0.0002,
    base_step_s: float = 0.002,
    lookup_period_s: float = 1.0,
    placement_period_s: float = 20.0,
    placement_moves: int = 12,
    max_pending: int = 0,
) -> dict:
    """One seeded macro-sim scenario → the deterministic report dict."""
    if servers + gateways + 1 > nodes:
        raise ValueError("nodes must cover servers + gateways + seed node")
    cfg = dict(
        seed=seed, nodes=nodes, servers=servers, gateways=gateways,
        experts=experts, slots=slots, fanout=fanout, clusters=clusters,
        prompt_len=tuple(prompt_len), max_new=tuple(max_new),
        rpc_timeout=rpc_timeout, join_batch=join_batch,
        hb_period_s=hb_period_s, record_ttl_s=record_ttl_s,
        alive_ttl_s=alive_ttl_s, mirror_period_s=mirror_period_s,
        maintenance_s=maintenance_s, base_service_s=base_service_s,
        per_token_s=per_token_s, base_step_s=base_step_s,
        lookup_period_s=lookup_period_s,
        placement_period_s=placement_period_s,
        placement_moves=placement_moves, max_pending=max_pending,
    )
    parsed = parse_trace(trace, churn)
    clock = VirtualClock(step=0.0)
    entropy = random.Random(f"{seed}|entropy")
    with sanitizer.allowed(*RELAXED_SITES), installed_entropy(entropy):
        return run_virtual(_run(cfg, clock, parsed), clock=clock)


def check_report(report: dict, args) -> list:
    """Regression floors; returns failure strings (empty = pass).

    The numeric floors/ceilings are declarative :class:`Threshold` specs
    run through the shared SLO engine (utils/slo.py) — same
    evaluator as the rebalancer's gate and the loadgen floors; bounds
    and failure messages unchanged.  The arrivals-accounting identity
    stays inline (it is an equality over three fields, not a
    threshold)."""
    from learning_at_home_tpu_torch.utils.slo import Threshold, evaluate_thresholds

    failures = []
    tr = report["traffic"]
    accounted = tr["completed"] + tr["shed"] + tr["errored"]
    if accounted != tr["arrivals"]:
        failures.append(
            f"accounting: completed+shed+errored {accounted} "
            f"!= arrivals {tr['arrivals']}"
        )
    specs = [
        Threshold("errored_zero", "traffic.errored", "<=", 0.0),
        Threshold("completed_floor", "traffic.completed", ">=",
                  float(args.min_completed)),
        Threshold("shed_floor", "traffic.shed_fraction", ">=",
                  float(args.shed_min)),
        Threshold("shed_ceiling", "traffic.shed_fraction", "<=",
                  float(args.shed_max)),
        Threshold("ttft_p99_ceiling", "traffic.ttft_p99_ms", "<=",
                  float(args.ttft_p99_max_ms)),
        Threshold("hit_rate_floor", "dht.hit_rate", ">=",
                  float(args.hit_rate_floor)),
        Threshold("join_failures_zero", "swarm.join_failures", "<=", 0.0),
    ]
    messages = {
        "errored_zero": f"errored streams: {tr['errored']}",
        "completed_floor": (
            f"completed {tr['completed']} < floor {args.min_completed}"
        ),
        "shed_floor": (
            f"shed_fraction {tr['shed_fraction']} < {args.shed_min} "
            "(the burst never pushed admission into shedding)"
        ),
        "shed_ceiling": (
            f"shed_fraction {tr['shed_fraction']} > {args.shed_max}"
        ),
        "ttft_p99_ceiling": (
            f"ttft_p99_ms {tr['ttft_p99_ms']} > {args.ttft_p99_max_ms}"
        ),
        "hit_rate_floor": (
            f"lookup hit_rate {report['dht']['hit_rate']} < "
            f"{args.hit_rate_floor}"
        ),
        "join_failures_zero": (
            f"join_failures: {report['swarm']['join_failures']}"
        ),
    }
    for v in evaluate_thresholds(report, specs):
        failures.append(messages.get(v["slo"], v["detail"]))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nodes", type=int, default=200)
    ap.add_argument("--servers", type=int, default=48)
    ap.add_argument("--gateways", type=int, default=4)
    ap.add_argument("--experts", type=int, default=64)
    ap.add_argument("--trace", type=str, default="poisson:60:6,burst:360:3",
                    help="arrival segments (sim/trace.py grammar)")
    ap.add_argument("--churn", type=str, default="4:kill:0.15",
                    help="churn events AT:kill:FRAC / AT:join:COUNT")
    ap.add_argument("--slots", type=int, default=64)
    ap.add_argument("--fanout", type=int, default=2)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--placement-period", type=float, default=20.0)
    ap.add_argument("--placement-moves", type=int, default=12)
    ap.add_argument("--check", action="store_true",
                    help="assert the regression floors; print MACRO_SIM_OK")
    ap.add_argument("--min-completed", type=int, default=50)
    ap.add_argument("--shed-min", type=float, default=0.0005)
    ap.add_argument("--shed-max", type=float, default=0.6)
    ap.add_argument("--ttft-p99-max-ms", type=float, default=60_000.0)
    ap.add_argument("--hit-rate-floor", type=float, default=0.95)
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    report = run_macro_sim(
        seed=args.seed, nodes=args.nodes, servers=args.servers,
        gateways=args.gateways, experts=args.experts, trace=args.trace,
        churn=args.churn, slots=args.slots, fanout=args.fanout,
        clusters=args.clusters,
        placement_period_s=args.placement_period,
        placement_moves=args.placement_moves,
    )
    wall = time.monotonic() - t0
    print(canonical_json(report))
    print(f"macro-sim wall: {wall:.1f}s for "
          f"{report['virtual_duration_s']}s virtual", file=sys.stderr)
    if args.check:
        failures = check_report(report, args)
        if failures:
            for f in failures:
                print(f"MACRO_SIM_FAIL: {f}", file=sys.stderr)
            return 1
        tr = report["traffic"]
        print(
            f"MACRO_SIM_OK nodes={args.nodes} arrivals={tr['arrivals']} "
            f"shed_fraction={tr['shed_fraction']} "
            f"ttft_p99_ms={tr['ttft_p99_ms']} "
            f"hit_rate={report['dht']['hit_rate']}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
