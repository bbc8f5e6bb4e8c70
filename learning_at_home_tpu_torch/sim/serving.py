"""Virtual serving layer: real control plane, modeled data plane.

The port's copy of ``learning_at_home_tpu/sim/serving.py``.

The REAL code under simulation (never reimplemented here):

- ``gateway.scheduler.SlotScheduler`` — driven by calling
  ``_iteration()`` directly (no decode thread); slots/pages bookkeeping
  is the real ``PagedKVCache`` via :class:`_FakePagedDecoder`;
- ``gateway.admission.AdmissionController`` — every arrival passes
  through ``admit()``; the worst-queue snapshot refreshes inline via
  ``maybe_refresh()`` on the virtual clock;
- ``client.routing`` — ``CachedAliveSet`` (TTL on the clock seam) over
  a real DHT read, ``select_top_k`` + ``RoutingCostModel.bias`` for
  expert selection, ``order_replicas`` for replica choice;
- ``dht.node.DHTNode`` / ``dht.protocol.DHTProtocol`` — every
  declare/lookup is a real iterative Kademlia exchange over
  :mod:`~learning_at_home_tpu_torch.sim.net`.

What is MODELED:

- per-link RTT/bandwidth (:class:`LinkModel`, seeded distributions on a
  clustered topology);
- expert-server compute: a scalar work backlog per server that drains
  in virtual time (:class:`VirtualExpertServer.dispatch`);
- trunk math: token arithmetic from ``_FakePagedDecoder`` — the content
  of tokens never affects timing, only their count does.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional, Sequence

import numpy as np

from learning_at_home_tpu_torch.client.routing import (
    CachedAliveSet,
    RoutingCostModel,
    as_replica_set,
    endpoint_key,
    select_top_k,
)
from learning_at_home_tpu_torch.dht.node import DHTNode
from learning_at_home_tpu_torch.dht.protocol import PLAIN_SUBKEY
from learning_at_home_tpu_torch.gateway.admission import AdmissionController
from learning_at_home_tpu_torch.gateway.scheduler import SlotScheduler
from learning_at_home_tpu_torch.sim.net import SIM_HOST, SimNetwork, spawn_node
from learning_at_home_tpu_torch.utils import flight
from learning_at_home_tpu_torch.utils.telemetry import (
    MAX_ADVERTISED_LINKS,
    links_key,
    load_key,
    parse_links_value,
    parse_load_value,
)
from learning_at_home_tpu_torch.utils.timed_storage import get_dht_time


def pair_rng(seed: int, a, b, salt: str) -> random.Random:
    """Seeded RNG for an unordered pair — stable across processes (string
    seeding hashes with sha512, never the salted builtin ``hash``)."""
    lo, hi = (a, b) if str(a) <= str(b) else (b, a)
    return random.Random(f"{seed}|{lo}|{hi}|{salt}")


class LinkModel:
    """Seeded per-link RTT/bandwidth on a clustered topology.

    Ports are assigned to ``n_clusters`` "regions"; intra-cluster links
    are fast/fat, inter-cluster links slow/thin.  Every draw is a pure
    function of (seed, port pair), cached, symmetric — the same numbers
    feed the SimNetwork delivery delay, the servers' published
    ``links.<prefix>`` records, and the placement snapshot, so routing
    and placement optimize against one consistent world.
    """

    def __init__(
        self,
        seed: int,
        *,
        n_clusters: int = 4,
        intra_rtt_s: tuple = (0.002, 0.012),
        inter_rtt_s: tuple = (0.030, 0.120),
        intra_bw_bps: tuple = (200e6, 1000e6),
        inter_bw_bps: tuple = (20e6, 200e6),
    ):
        self.seed = int(seed)
        self.n_clusters = max(1, int(n_clusters))
        self.intra_rtt_s = intra_rtt_s
        self.inter_rtt_s = inter_rtt_s
        self.intra_bw_bps = intra_bw_bps
        self.inter_bw_bps = inter_bw_bps
        self._cache: dict[tuple, tuple] = {}

    def cluster_of(self, port: int) -> int:
        # stable region assignment; ports are allocated densely from 1
        return int(port) % self.n_clusters

    def link(self, a_port: int, b_port: int) -> tuple:
        """(rtt_s, bw_bps) for the unordered port pair; rtt is the full
        request+reply round trip."""
        if a_port == b_port:
            return (0.0002, 1000e6)
        key = (min(a_port, b_port), max(a_port, b_port))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        rng = pair_rng(self.seed, *key, salt="link")
        same = self.cluster_of(a_port) == self.cluster_of(b_port)
        rtt_lo, rtt_hi = self.intra_rtt_s if same else self.inter_rtt_s
        bw_lo, bw_hi = self.intra_bw_bps if same else self.inter_bw_bps
        out = (rng.uniform(rtt_lo, rtt_hi), rng.uniform(bw_lo, bw_hi))
        self._cache[key] = out
        return out

    def rtt_s(self, a_port: int, b_port: int) -> float:
        return self.link(a_port, b_port)[0]

    def delivery_delay(self, src_port: int, dst_port: int) -> float:
        """SimNetwork ``latency_fn``: one RPC costs one round trip."""
        return self.rtt_s(src_port, dst_port)


class NullPoolRegistry:
    """RoutingCostModel registry stub: the sim gateway never dials a real
    socket, so there are no local pool EMAs — every prediction falls
    back to the swarm-published link prior + queue depth, which is
    exactly the routing cost model's cold-start path."""

    def peek(self, endpoint):
        return None


class DhtExpertSource:
    """``ExpertSource`` over a raw ``DHTNode`` (the facade's subkey
    parsing, minus its cache/loop bridge — the sim runs everything on
    one loop already).  Subkey forms as in ``dht/__init__._get_alive``."""

    def __init__(self, node: DHTNode):
        self.node = node

    @staticmethod
    def _parse_endpoint(v) -> Optional[tuple]:
        if (
            isinstance(v, (list, tuple)) and len(v) == 2
            and isinstance(v[0], str)
        ):
            try:
                return (v[0], int(v[1]))
            except (TypeError, ValueError):
                return None
        return None

    async def get_alive_experts(self, prefix: str) -> dict:
        records = await self.node.get(prefix)
        eps: dict[str, list] = {}
        for subkey in sorted(records, key=str):
            value, _exp = records[subkey]
            endpoint = self._parse_endpoint(value)
            if endpoint is None:
                continue
            if subkey == PLAIN_SUBKEY or not isinstance(subkey, str):
                uid = prefix
            elif subkey.startswith("@"):
                uid = prefix
            elif "@" in subkey:
                uid = subkey.rsplit("@", 1)[0]
            else:
                uid = subkey
            bucket = eps.setdefault(uid, [])
            if endpoint not in bucket:
                bucket.append(endpoint)
        return {
            uid: (lst[0] if len(lst) == 1 else tuple(sorted(lst)))
            for uid, lst in eps.items()
        }

    async def get_alive_experts_fresh(self, prefix: str) -> dict:
        return await self.get_alive_experts(prefix)


class VirtualExpertServer:
    """One expert host: a real DHT node + a scalar compute model.

    Work arrives through :meth:`dispatch` as seconds-of-compute; the
    backlog drains at one virtual second per virtual second, so queueing
    delay emerges from load instead of being scripted.  Heartbeats
    publish the REAL record bundle (per-uid declares + prefix fan-in +
    ``load``/``links`` sidecars) through real ``store_many`` calls.
    """

    def __init__(
        self,
        dht: DHTNode,
        *,
        clock,
        link_model: LinkModel,
        prefix: str,
        experts: list,
        rng: random.Random,
        base_service_s: float = 0.004,
        per_token_s: float = 0.0002,
        hb_period_s: float = 20.0,
        record_ttl_s: float = 60.0,
    ):
        self.dht = dht
        self.clock = clock
        self.link_model = link_model
        self.prefix = prefix
        self.experts = list(experts)
        self.rng = rng
        self.base_service_s = base_service_s
        self.per_token_s = per_token_s
        self.hb_period_s = hb_period_s
        self.record_ttl_s = record_ttl_s
        self.alive = True
        self.backlog_s = 0.0
        self._drained_at = clock.monotonic()
        self.dispatches_total = 0
        self.heartbeats_total = 0
        self._hb_task: Optional[asyncio.Task] = None
        self.peer_ports: list = []  # advertised link destinations

    @property
    def port(self) -> int:
        return self.dht.protocol.listen_port

    @property
    def endpoint(self) -> tuple:
        return (SIM_HOST, self.port)

    # ---- the compute model ----

    def _drain(self, now: float) -> None:
        self.backlog_s = max(0.0, self.backlog_s - (now - self._drained_at))
        self._drained_at = now

    def queue_delay_s(self, now: float) -> float:
        self._drain(now)
        return self.backlog_s

    def q_depth(self, now: float) -> float:
        """Advertised queue depth: backlog in units of mean batches."""
        return self.queue_delay_s(now) / max(1e-9, self.base_service_s)

    def dispatch(self, now: float, tokens: int) -> float:
        """Accept one expert dispatch; returns virtual seconds until its
        reply (queue wait + service)."""
        wait = self.queue_delay_s(now)
        work = self.base_service_s + self.per_token_s * int(tokens)
        self.backlog_s += work
        self.dispatches_total += 1
        return wait + work

    # ---- the declare/heartbeat path (real DHT stores) ----

    def heartbeat_entries(self) -> list:
        now = get_dht_time()
        exp = now + self.record_ttl_s
        value = [self.endpoint[0], int(self.endpoint[1])]
        ep_key = endpoint_key(self.endpoint)
        entries: list = []
        for uid in self.experts:
            entries.append((uid, f"@{ep_key}", value, exp))
            entries.append((self.prefix, f"{uid}@{ep_key}", value, exp))
        q = round(self.q_depth(self.clock.monotonic()), 3)
        entries.append((
            load_key(self.prefix), f"@{ep_key}",
            {"q": q, "n": len(self.experts)}, exp,
        ))
        if self.peer_ports:
            links = {
                f"{SIM_HOST}:{p}": [
                    round(self.link_model.rtt_s(self.port, p), 6),
                    round(self.link_model.link(self.port, p)[1], 1),
                ]
                for p in self.peer_ports[:MAX_ADVERTISED_LINKS]
            }
            entries.append((
                links_key(self.prefix), f"@{ep_key}", {"l": links}, exp,
            ))
        return entries

    async def heartbeat_once(self) -> None:
        acks = await self.dht.store_many(self.heartbeat_entries())
        self.heartbeats_total += 1
        if not all(acks):
            # best-effort like the real declare loop: count, don't raise
            pass

    async def heartbeat_forever(self) -> None:
        # deterministic phase offset so 2k servers don't stampede the
        # same virtual instant
        await asyncio.sleep(self.rng.uniform(0.0, self.hb_period_s))
        while self.alive:
            await self.heartbeat_once()
            await asyncio.sleep(self.hb_period_s)

    def start_heartbeat(self) -> None:
        self._hb_task = asyncio.get_running_loop().create_task(
            self.heartbeat_forever(), name=f"hb-{self.port}"
        )

    async def kill(self, network: SimNetwork) -> None:
        """Fail-stop: drop off the fabric mid-TTL, records left to decay
        — the failure mode the record-expiry detector exists for."""
        self.alive = False
        if self._hb_task is not None:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except asyncio.CancelledError:
                pass
            self._hb_task = None
        network.unregister(self.dht.protocol)


class TelemetryMirror:
    """The gateway's cached control-plane view: periodic REAL DHT reads
    of the ``load.<prefix>`` / ``links.<prefix>`` families, parsed with
    the production telemetry parsers, served to the cost model and the
    admission controller as plain sync getters (the same
    read-async/serve-sync split the real client uses)."""

    def __init__(self, node: DHTNode, prefix: str, *, period_s: float = 5.0):
        self.node = node
        self.prefix = prefix
        self.period_s = period_s
        self._loads: dict = {}
        self._links: dict = {}
        self.refreshes_total = 0
        self._task: Optional[asyncio.Task] = None

    async def refresh_once(self) -> None:
        load_recs = await self.node.get(load_key(self.prefix))
        loads: dict = {}
        for subkey in sorted(load_recs, key=str):
            value, _exp = load_recs[subkey]
            if not (isinstance(subkey, str) and subkey.startswith("@")):
                continue
            parsed = parse_load_value(value)
            if parsed is not None:
                loads[subkey[1:]] = parsed
        link_recs = await self.node.get(links_key(self.prefix))
        links: dict = {}
        for subkey in sorted(link_recs, key=str):
            value, _exp = link_recs[subkey]
            parsed = parse_links_value(value)
            if parsed is None:
                continue
            for dst, ent in sorted(parsed.items()):
                cur = links.get(dst)
                # best prior wins: keep the smallest published rtt
                if cur is None or ent["rtt_s"] < cur["rtt_s"]:
                    links[dst] = ent
        self._loads, self._links = loads, links
        self.refreshes_total += 1

    def load_getter(self) -> dict:
        return self._loads

    def link_getter(self) -> dict:
        return self._links

    async def run_forever(self) -> None:
        while True:
            await self.refresh_once()
            await asyncio.sleep(self.period_s)

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(
            self.run_forever(), name=f"mirror-{self.prefix}"
        )

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None


class _FakePagedDecoder:
    """Token-arithmetic stand-in for SwarmKVDecoder backed by a REAL
    :class:`PagedKVCache`: all slot/page bookkeeping is the production
    code path (alloc, map_shared, refcounts, prefix registry, release),
    only the trunk math is replaced by deterministic token arithmetic
    (the pools are small CPU tensors).  The port's copy of the class in
    ``learning_at_home_tpu/analysis/verify.py``.  Mirrors the
    real decoder's contract exactly, including raising on a
    ``prefill_step`` against a slot that is not mid-prefill (the call
    pattern only a stale scheduler snapshot produces)."""

    supports_chunked_prefill = True

    def __init__(self, *, max_slots=2, seq_len=8, page_len=2,
                 num_pages=5, prefix_cache=False):
        import numpy as np
        import torch

        from learning_at_home_tpu_torch.models.kv_pages import PagedKVCache

        self.max_slots = int(max_slots)
        self.seq_len = int(seq_len)
        self.kv = PagedKVCache(
            n_layers=1, n_heads=1, head_dim=1, dtype=torch.float32,
            max_slots=max_slots, seq_len=seq_len, page_len=page_len,
            num_pages=num_pages, enable_prefix_cache=prefix_cache,
            device="cpu",
        )
        self._np = np
        self.pos = np.zeros(self.max_slots, np.int32)
        self.live = np.zeros(self.max_slots, bool)
        self.prefilling = np.zeros(self.max_slots, bool)
        self._prefill_prompt: list = [None] * self.max_slots
        self.stream_ids: list = [None] * self.max_slots
        self.prefills_total = 0
        self.prefill_chunks_total = 0
        self.decode_steps_total = 0
        self.verify_rounds_total = 0
        self.last_verify: list = []

    # slot bookkeeping — same shapes as SwarmKVDecoder
    def free_slots(self):
        return [
            i for i in range(self.max_slots)
            if not self.live[i] and not self.prefilling[i]
        ]

    def live_slots(self):
        return [(i, self.stream_ids[i]) for i in range(self.max_slots)
                if self.live[i]]

    def prefilling_slots(self):
        return [(i, self.stream_ids[i]) for i in range(self.max_slots)
                if self.prefilling[i]]

    def busy_slots(self):
        return [i for i in range(self.max_slots)
                if self.live[i] or self.prefilling[i]]

    def at_capacity(self, slot):
        return int(self.pos[slot]) >= self.seq_len

    def evict(self, slot):
        self.live[slot] = False
        self.prefilling[slot] = False
        self._prefill_prompt[slot] = None
        self.stream_ids[slot] = None
        self.pos[slot] = 0
        self.kv.release_slot(slot)

    def pages_needed(self, prompt_len, max_new_tokens=0):
        total = min(int(prompt_len) + int(max_new_tokens), self.seq_len)
        return self.kv.pages_needed(total)

    def free_page_headroom(self):
        active = int((self.live | self.prefilling).sum())
        return self.kv.pages_free() + self.kv.pages_reclaimable() - active

    def kv_stats(self):
        return self.kv.stats()

    def _tok(self, slot) -> int:
        # deterministic pseudo-token from the slot's position
        return int(self.pos[slot]) * 7 % 251

    def begin_prefill(self, slot, prompt_ids, stream_id=None,
                      sampling=None) -> int:
        if self.live[slot] or self.prefilling[slot]:
            raise ValueError(f"slot {slot} is occupied")
        prompt = [int(t) for t in prompt_ids]
        if not 0 < len(prompt) < self.seq_len:
            raise ValueError("bad prompt length")
        from learning_at_home_tpu_torch.models.kv_pages import PagePressure

        full, partial = self.kv.prefix_lookup(prompt)
        matched = 0
        try:
            for e in full:
                self.kv.map_shared(slot, e)
            matched = len(full) * self.kv.page_len
            if partial is not None:
                e, r = partial
                dst = self.kv.alloc_slot_page(slot)
                self.kv.copy_page_rows(e.page_id, dst, r)
                matched += r
        except PagePressure:
            self.kv.release_slot(slot)
            raise
        self.prefilling[slot] = True
        self._prefill_prompt[slot] = prompt
        self.pos[slot] = matched
        self.stream_ids[slot] = stream_id
        return matched

    def prefill_step(self, slot, max_tokens):
        if not self.prefilling[slot]:
            raise ValueError(f"slot {slot} is not mid-prefill")
        prompt = self._prefill_prompt[slot]
        p = len(prompt)
        start = int(self.pos[slot])
        c = min(int(max_tokens), p - start)
        pages = self.kv.pages_needed(start + c)
        while int(self.kv.alloc_count[slot]) < pages:
            self.kv.alloc_slot_page(slot)  # may raise PagePressure
        self.pos[slot] = start + c
        self.prefill_chunks_total += 1
        if start + c < p:
            return c, None
        self.kv.register_prefix(slot, prompt)
        self.live[slot] = True
        self.prefilling[slot] = False
        self._prefill_prompt[slot] = None
        self.prefills_total += 1
        return c, self._tok(slot)

    def ensure_decode_pages(self):
        from learning_at_home_tpu_torch.models.kv_pages import PagePressure

        lacking = []
        for s in range(self.max_slots):
            if not self.live[s] or self.at_capacity(s):
                continue
            logical = int(self.pos[s]) // self.kv.page_len
            while int(self.kv.alloc_count[s]) <= logical:
                try:
                    self.kv.alloc_slot_page(s)
                except PagePressure:
                    lacking.append(s)
                    break
        return lacking

    def decode_step(self):
        nxt = self._np.zeros(self.max_slots, self._np.int32)
        for s in range(self.max_slots):
            if self.live[s]:
                nxt[s] = self._tok(s)
                self.pos[s] += 1
        self.decode_steps_total += 1
        return nxt

    # speculative contract — same shapes as SwarmKVDecoder, the trunk
    # replaced by the _tok arithmetic.  The PagedKVCache underneath is
    # REAL, so ensure_lookahead_pages allocates genuine pool pages and
    # verify_step's rollback runs the production truncate_slot with its
    # inline kv.rollback_private_only check.

    def ensure_lookahead_pages(self, slot, k) -> int:
        from learning_at_home_tpu_torch.models.kv_pages import PagePressure

        pos = int(self.pos[slot])
        top = min(pos + int(k), self.seq_len - 1)
        want = top // self.kv.page_len
        while int(self.kv.alloc_count[slot]) <= want:
            try:
                self.kv.alloc_slot_page(slot)
            except PagePressure:
                break
        covered = int(self.kv.alloc_count[slot]) * self.kv.page_len - 1
        return max(0, min(int(k), covered - pos))

    def verify_step(self, proposals: dict) -> dict:
        if not proposals:
            return {}
        out: dict = {}
        self.last_verify = []
        for s in sorted(int(x) for x in proposals):
            if not self.live[s]:
                raise ValueError(f"slot {s} is not live")
            drafts = [int(t) for t in proposals[s]]
            pos = int(self.pos[s])
            if pos + len(drafts) > self.seq_len - 1:
                raise ValueError(
                    f"slot {s}: {len(drafts)} drafts at position {pos} "
                    f"exceed the cache ({self.seq_len} positions)"
                )
            want = (pos + len(drafts)) // self.kv.page_len
            if int(self.kv.alloc_count[s]) <= want:
                raise ValueError(
                    f"slot {s} has no KV page for its lookahead — "
                    "call ensure_lookahead_pages() first"
                )
            # row j's sample is exactly what decode_step would emit at
            # position pos+j under the token arithmetic
            samples = [
                (pos + j) * 7 % 251 for j in range(len(drafts) + 1)
            ]
            a = 0
            while a < len(drafts) and drafts[a] == samples[a]:
                a += 1
            tokens = samples[:a + 1]
            self.pos[s] = pos + a + 1
            self.kv.truncate_slot(s, int(self.pos[s]))
            out[s] = {
                "tokens": tokens, "accepted": a, "proposed": len(drafts)
            }
            self.last_verify.append({
                "slot": s, "stream_id": self.stream_ids[s],
                "drafts": drafts, "samples": samples,
                "accepted": a, "tokens": list(tokens),
            })
        self.verify_rounds_total += 1
        return out


class SimGateway:
    """One gateway: the real scheduler/admission/routing stack pumped by
    a coroutine on the virtual clock.

    ``_iteration()`` itself is bookkeeping and costs zero virtual time;
    the iteration's virtual duration is then modeled as base step time
    plus the slowest selected expert's (link round trip + queue wait +
    service) and slept, so fleet throughput, TTFT and ITL all emerge
    from load, placement and the trace.  Token timestamps are taken at
    the END of the step that produced them.
    """

    def __init__(
        self,
        name: str,
        dht: DHTNode,
        *,
        clock,
        network: SimNetwork,
        link_model: LinkModel,
        servers_by_port: dict,
        prefix: str,
        n_experts: int,
        seed: int,
        max_slots: int = 64,
        seq_len: int = 96,
        page_len: int = 4,
        pages_per_slot: float = 6.0,
        fanout_k: int = 2,
        cost_weight: float = 1.0,
        alive_ttl_s: float = 3.0,
        base_step_s: float = 0.002,
        idle_wait_s: float = 0.01,
        dead_dispatch_s: float = 0.25,
        max_pending: Optional[int] = None,
        mirror_period_s: float = 5.0,
    ):
        self.name = name
        self.dht = dht
        self.clock = clock
        self.network = network
        self.link_model = link_model
        self.servers_by_port = servers_by_port
        self.prefix = prefix
        self.n_experts = int(n_experts)
        self.fanout_k = int(fanout_k)
        self.base_step_s = base_step_s
        self.idle_wait_s = idle_wait_s
        self.dead_dispatch_s = dead_dispatch_s
        self.decoder = _FakePagedDecoder(
            max_slots=max_slots, seq_len=seq_len, page_len=page_len,
            num_pages=int(max_slots * pages_per_slot),
        )
        self.sched = SlotScheduler(
            self.decoder, idle_wait_s=0.0, stream_ttl_s=10_000.0,
            prefill_chunk_tokens=8,
        )
        self.mirror = TelemetryMirror(dht, prefix, period_s=mirror_period_s)
        self.adm = AdmissionController(
            self.sched,
            max_pending=max_pending,
            load_fn=self.mirror.load_getter,
            refresh_period_s=mirror_period_s,
        )
        self.cost = RoutingCostModel(
            cost_weight,
            registry=NullPoolRegistry(),
            load_getter=self.mirror.load_getter,
            link_getter=self.mirror.link_getter,
        )
        self.alive_set = CachedAliveSet(
            DhtExpertSource(dht), prefix, ttl=alive_ttl_s, swr=False,
        )
        self.np_rng = np.random.RandomState(
            int(pair_rng(seed, name, "gw", "gate").random() * 2**31)
        )
        # per-stream bookkeeping (sim-side observability, not scheduler
        # internals): sid -> [submitted_at, first_token_at, cursor,
        # bucket, last_emit_at]
        self.inflight: dict[str, list] = {}
        self.arrival_queue: list = []  # (prompt, max_new, bucket) FIFO
        self.completed = 0
        self.errored = 0
        self.shed = 0
        self.tokens_served = 0
        self.ttfts: list = []   # (bucket, seconds) samples
        self.itls: list = []    # (bucket, seconds) samples
        # co-activation + routing observability shared with placement
        self.coact: dict[tuple, int] = {}
        self.activations: dict[str, int] = {}
        self.selection_rounds = 0
        self.no_alive_rounds = 0
        self._stopping = False
        self._task: Optional[asyncio.Task] = None

    @property
    def port(self) -> int:
        return self.dht.protocol.listen_port

    # ---- arrivals ----

    def submit_arrival(self, prompt: list, max_new: int, bucket: str) -> bool:
        """Admission + real submit; False = shed."""
        self.adm.maybe_refresh()
        pages = self.decoder.pages_needed(len(prompt), max_new)
        accepted, _retry, _reason = self.adm.admit(pages_needed=pages)
        if not accepted:
            self.shed += 1
            # virtual-clock-aware flight event (the seam in sim/clock.py
            # stamps t_mono from the scenario clock)
            flight.record(
                f"sim.{self.name}", "shed", reason=_reason, bucket=bucket,
                pages_needed=pages,
            )
            return False
        sid = self.sched.submit(prompt, max_new)
        now = self.clock.monotonic()
        self.inflight[sid] = [now, None, 0, bucket, now]
        return True

    # ---- expert selection (real routing code) ----

    async def _select_experts(self, tokens_this_step: int) -> list:
        """One routing decision for this iteration's microbatch; returns
        [(uid, endpoint, dispatch_cost_s)] for the chosen experts."""
        alive = await self.alive_set.get()
        if not alive:
            self.no_alive_rounds += 1
            return []
        uids = sorted(alive)
        replica_sets = {uid: as_replica_set(alive[uid]) for uid in uids}
        logits = [self.np_rng.randn(1, self.n_experts).astype(np.float32)]
        bias = self.cost.bias(uids, replica_sets, nbytes=tokens_this_step * 8)
        sel, _coords = select_top_k(
            logits, uids, min(self.fanout_k, len(uids)), bias=bias
        )
        now = self.clock.monotonic()
        chosen = []
        for j in sel[0]:
            uid = uids[int(j)]
            replicas = self.cost.order_replicas(
                replica_sets[uid], nbytes=tokens_this_step * 8
            )
            ep = replicas[0]
            server = self.servers_by_port.get(int(ep[1]))
            if server is None or not server.alive:
                # routed to a corpse mid-TTL: pay the timeout, learn
                # nothing (the alive set corrects itself at expiry)
                cost = self.dead_dispatch_s
            else:
                cost = (
                    self.link_model.rtt_s(self.port, server.port)
                    + server.dispatch(now, tokens_this_step)
                )
            chosen.append((uid, ep, cost))
        for i, (u, _e, _c) in enumerate(chosen):
            self.activations[u] = (
                self.activations.get(u, 0) + tokens_this_step
            )
            for v, _e2, _c2 in chosen[i + 1:]:
                if u == v:
                    continue
                key = (min(u, v), max(u, v))
                self.coact[key] = self.coact.get(key, 0) + 1
        self.selection_rounds += 1
        return chosen

    # ---- the pump ----

    def _harvest(self, stamp: float) -> None:
        """Fold newly produced tokens / finished streams into the
        sim-side accounting; tokens emitted this step complete at its
        END (``stamp``)."""
        done = []
        for sid in list(self.inflight):
            rec = self.inflight[sid]
            out = self.sched.poll(sid, rec[2])
            if out is None:
                done.append(sid)
                continue
            new = len(out["tokens"])
            if new:
                if rec[1] is None:
                    rec[1] = stamp
                    self.ttfts.append((rec[3], stamp - rec[0]))
                else:
                    # the gap since this stream last emitted is one ITL
                    # sample; extra tokens landing in the SAME step are
                    # simultaneous (zero-gap samples would only dilute
                    # percentiles, so they are not counted)
                    self.itls.append((rec[3], stamp - rec[4]))
                rec[4] = stamp
                rec[2] = out["cursor"]
            if out["done"]:
                if out["error"]:
                    self.errored += 1
                else:
                    self.completed += 1
                    self.tokens_served += rec[2]
                done.append(sid)
        for sid in done:
            self.inflight.pop(sid, None)

    async def run_forever(self) -> None:
        while True:
            self.adm.maybe_refresh()
            if self.sched.pending_count() + len(self.inflight) == 0:
                if self._stopping:
                    return
                await asyncio.sleep(self.idle_wait_s)
                continue
            worked = self.sched._iteration()
            if not worked:
                self._harvest(self.clock.monotonic())
                await asyncio.sleep(self.idle_wait_s)
                continue
            tokens_this_step = max(
                1, int((self.decoder.live | self.decoder.prefilling).sum())
            )
            chosen = await self._select_experts(tokens_this_step)
            step_dt = self.base_step_s + (
                max(c for _u, _e, c in chosen) if chosen else 0.0
            )
            await asyncio.sleep(step_dt)
            self._harvest(self.clock.monotonic())

    def start(self) -> None:
        self.mirror.start()
        self._task = asyncio.get_running_loop().create_task(
            self.run_forever(), name=f"gw-{self.name}"
        )

    async def drain_and_stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            await self._task
            self._task = None
        self.mirror.stop()
