"""DecentralizedAverager: DHT-matched, fault-tolerant group all-reduce.

One averager per trainer process.  It hosts an averaging peer endpoint
(handler.py) on its own background loop, declares itself in the DHT
under the group prefix, and on each :meth:`step_round` call:

1. **matchmaking** (host thread + loop): declare → discover → elect the
   deterministic leader (min peer id).  The leader gathers ``avg_join``
   calls until every expected peer joined (or the gather window lapses
   with ≥ ``min_group_size`` members) and freezes a group stamped with
   its monotonically increasing epoch; followers block in ``avg_join``
   until the freeze.  A peer knocking mid-round is told to wait for the
   next epoch (late-joiner semantics).
2. **reduction** (loop): chunked butterfly all-reduce.  Member *i* of
   the sorted group owns partition *i*: every member sends its slice of
   partition *i* to member *i* as pack-once ``WireTensors`` chunks over
   the v2 mux transport; member *i* reduces the partition ONCE (sorted
   weighted mean) and the held ``avg_part`` replies distribute the
   identical bytes back — so all members end bitwise-equal on every
   partition that reduced.
3. **fault tolerance**: the accumulator waits ``part_timeout`` for all
   members then degrades to a re-weighted mean over the survivors;
   senders bound each chunk RPC by ``sender_timeout`` and the whole
   round by ``round_timeout``, cancelling stragglers with
   ``QUORUM_STRAGGLER_CANCEL``-marked cancels (their elapsed wait folds
   into the transport's RTT EMA, same contract as the MoE fan-out).  A
   partition whose owner died keeps the LOCAL values on every survivor
   and the round is counted degraded — degraded, never hung.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import logging
import threading
import time
import uuid
from collections import deque
from typing import Any, Optional

import numpy as np

from learning_at_home_tpu_torch.averaging.handler import (
    AveragingPeerHandler,
    as_f32_chunk,
)
from learning_at_home_tpu_torch.averaging.matchmaking import (
    declare_peer,
    discover_peers,
    elect_leader,
    expected_members,
)
from learning_at_home_tpu_torch.averaging.partitioning import (
    chunk_ranges,
    flatten_tree,
    partition_bounds,
    unflatten_tree,
    weighted_mean,
)
from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.asyncio_utils import BackgroundLoop
from learning_at_home_tpu_torch.utils.connection import (
    QUORUM_STRAGGLER_CANCEL,
    PoolRegistry,
    RemoteCallError,
)
from learning_at_home_tpu_torch.utils.profiling import new_trace_id, timeline
from learning_at_home_tpu_torch.utils.serialization import WireTensors

logger = logging.getLogger(__name__)


class AveragingFailed(RuntimeError):
    """Matchmaking or reduction could not complete this round."""


# Hard cap on wire chunks per partition, kept BELOW the mux transport's
# per-pool in-flight limit (64): every chunk's reply is HELD until the
# whole partition reduces, so reduction progress requires ALL of a
# partition's chunk RPCs to be admitted concurrently — more chunks than
# in-flight slots would deadlock-until-timeout (the semaphore only frees
# when replies arrive, and replies need the not-yet-admitted chunks).
# Large partitions widen their chunks instead of adding more.
MAX_CHUNKS_PER_PART = 48


@dataclasses.dataclass
class AveragingConfig:
    """All times in seconds.  Derived timeouts keep the invariant
    ``part_timeout < sender_timeout < round_timeout``: an accumulator
    must get to degrade-and-reply BEFORE its senders give up on it, and
    the round deadline must outlast individual sends so the straggler
    cancel is the exception, not the rule."""

    prefix: str = "averaging.trunk"
    min_group_size: int = 2
    max_group_size: int = 16
    weight: float = 1.0  # this peer's contribution weight (e.g. batch share)
    ttl: float = 15.0  # DHT declaration TTL (expiry = failure detection)
    matchmaking_timeout: float = 30.0  # total budget to find a group
    gather_timeout: float = 6.0  # leader's join-collection window
    join_hold: float = 1.0  # handler wait for a local gather to open
    poll: float = 0.2  # matchmaking retry sleep
    part_timeout: float = 5.0  # accumulator wait for all members' parts
    sender_timeout: Optional[float] = None  # per-chunk RPC bound (derived)
    round_timeout: Optional[float] = None  # whole-reduction bound (derived)
    chunk_elems: int = 1 << 16  # elements per wire chunk (256 KiB of f32)
    orphan_ttl: float = 30.0  # GC for reductions never attached locally
    # wire codec for OUTGOING partition chunks (ISSUE 5): None/"none" =
    # raw f32 (today's wire); "bf16"/"u8"/"blockq8" encode each chunk
    # off-loop before sending (4x fewer contribute-direction bytes at
    # 8 bit).  The accumulator decodes to f32 before the sorted-peer
    # reduction, and averaged REPLIES always travel raw f32 — one set of
    # exact result bytes for everyone is what keeps members
    # bitwise-equal per reduced partition.  Quantized chunks are only
    # offered to owners whose hello echoed the ``codec`` feature (old
    # builds transparently get raw f32).  LAH_AVG_WIRE_CODEC overrides.
    wire_codec: Optional[str] = None

    def resolved_sender_timeout(self) -> float:
        return (
            self.sender_timeout
            if self.sender_timeout is not None
            else self.part_timeout * 1.5 + 2.0
        )

    def resolved_round_timeout(self) -> float:
        return (
            self.round_timeout
            if self.round_timeout is not None
            else self.resolved_sender_timeout() + 5.0
        )


@dataclasses.dataclass
class Group:
    """A frozen averaging group: sorted members, one leader epoch."""

    gid: str
    epoch: int
    members: list  # [(peer_id, host, port, weight)], sorted by peer_id


class _LeaderGather:
    """Leader-side join collection for one round (loop-confined)."""

    def __init__(self, gid: str, epoch: int, expected: set[str]):
        self.gid = gid
        self.epoch = epoch
        self.expected = expected  # peer ids still awaited (self excluded)
        self.joined: dict[str, tuple] = {}  # pid -> (host, port, w, future)
        self.frozen = False
        self.complete = asyncio.Event()


class _Reduction:
    """Accumulation state for ONE partition of one group on its owner.

    Created lazily by the first arriving ``avg_part`` (peers race their
    sends against the owner finishing matchmaking) and attached by the
    owner's local reducer, which supplies the expected member set, its
    own contribution, and starts the part timeout.  All access is
    loop-confined."""

    def __init__(self, gid: str, loop: asyncio.AbstractEventLoop):
        self.gid = gid
        self.loop = loop
        self.created = loop.time()
        self.finished: Optional[float] = None
        self.attached = False
        self.part_len: Optional[int] = None
        self.expected: dict[str, float] = {}
        self.contribs: dict[str, dict] = {}  # pid -> {w, buf, got}
        self.pending: list[tuple[int, int, asyncio.Future]] = []
        self.result: Optional[np.ndarray] = None
        self.missing: list[str] = []
        self.degraded = False
        self.done = asyncio.Event()
        self._timeout_handle: Optional[asyncio.TimerHandle] = None

    def _entry(self, sender: str, weight: float) -> dict:
        entry = self.contribs.get(sender)
        if entry is None:
            entry = {
                "w": float(weight),
                "buf": np.zeros(self.part_len, np.float32),
                "got": 0,
            }
            self.contribs[sender] = entry
        return entry

    def _set_part_len(self, part_len: int) -> None:
        if self.part_len is None:
            self.part_len = int(part_len)
        elif self.part_len != part_len:
            raise ValueError(
                f"group {self.gid}: inconsistent part_len "
                f"({self.part_len} vs {part_len}) — peers disagree on the "
                "averaged tree"
            )

    def add_chunk(
        self, sender: str, weight: float, part_len: int, off: int,
        chunk: np.ndarray,
    ) -> asyncio.Future:
        """Record one sender chunk; returns the held-reply future that
        resolves with the averaged bytes for the same range."""
        fut = self.loop.create_future()
        if self.result is not None:
            # late chunk after reduce (slow sender that missed the
            # cutoff): reply with the consensus bytes anyway
            fut.set_result(self.result[off : off + len(chunk)])
            return fut
        self._set_part_len(part_len)
        if off < 0 or off + len(chunk) > self.part_len:
            raise ValueError(
                f"chunk [{off}, {off + len(chunk)}) outside part of "
                f"{self.part_len} elements"
            )
        entry = self._entry(sender, weight)
        entry["buf"][off : off + len(chunk)] = chunk
        entry["got"] += len(chunk)
        self.pending.append((off, len(chunk), fut))
        self._maybe_reduce()
        return fut

    def attach(
        self, part_len: int, expected: dict[str, float], own_pid: str,
        own_weight: float, own_slice: np.ndarray, timeout: float,
    ) -> None:
        self._set_part_len(part_len)
        self.attached = True
        self.expected = dict(expected)
        entry = self._entry(own_pid, own_weight)
        entry["buf"][:] = own_slice
        entry["got"] = self.part_len
        self._timeout_handle = self.loop.call_later(timeout, self._on_timeout)
        self._maybe_reduce()

    def _complete_senders(self) -> list[str]:
        return [
            pid for pid, e in self.contribs.items()
            if e["got"] >= (self.part_len or 0)
        ]

    def _maybe_reduce(self) -> None:
        if self.result is not None or not self.attached:
            return
        if set(self._complete_senders()) >= set(self.expected):
            self._reduce()

    def _on_timeout(self) -> None:
        if self.result is None:
            self._reduce()

    def _reduce(self) -> None:
        complete = self._complete_senders()
        self.missing = sorted(set(self.expected) - set(complete))
        self.degraded = bool(self.missing)
        parts = [
            (pid, self.contribs[pid]["w"], self.contribs[pid]["buf"])
            for pid in complete
        ]
        if parts:
            self.result = weighted_mean(parts)
        else:  # cannot happen once attached (own contribution is complete)
            self.result = np.zeros(self.part_len or 0, np.float32)
            self.degraded = True
        self.finished = self.loop.time()
        if self._timeout_handle is not None:
            self._timeout_handle.cancel()
        for off, n, fut in self.pending:
            if not fut.done():
                fut.set_result(self.result[off : off + n])
        self.pending.clear()
        self.done.set()

    def fail(self, message: str) -> None:
        """Abandon this reduction (orphan GC, averager shutdown): error
        out held replies, disarm the part timer, and release a local
        ``own_part`` waiter — ``result`` stays None, which the reducer
        counts as a failed partition (never a round_timeout stall)."""
        if self._timeout_handle is not None:
            self._timeout_handle.cancel()
        exc = RemoteCallError(message)
        for _, _, fut in self.pending:
            if not fut.done():
                fut.set_exception(exc)
        self.pending.clear()
        self.degraded = True
        self.finished = self.loop.time()
        self.done.set()


class DecentralizedAverager:
    """One trainer's averaging peer: endpoint + matchmaking + reduction.

    Thread model: :meth:`step_round` is called from a HOST thread (the
    trainer / AveragingSession); DHT declare/discover run there via the
    DHT's sync bridge, while all networking state lives on the
    averager's own background loop with its own connection registry
    (averaging RTT never pollutes dispatch RTT EMAs, and vice versa).
    """

    def __init__(
        self,
        dht,
        config: Optional[AveragingConfig] = None,
        peer_id: Optional[str] = None,
        host: str = "127.0.0.1",
        chaos=None,
    ):
        self.dht = dht
        self.cfg = config or AveragingConfig()
        if self.cfg.min_group_size < 2:
            raise ValueError("min_group_size must be >= 2 (averaging with "
                             "yourself is a no-op)")
        self.peer_id = peer_id or uuid.uuid4().hex[:12]
        import os

        from learning_at_home_tpu_torch.utils.serialization import (
            validate_wire_codec,
        )

        env_codec = os.environ.get("LAH_AVG_WIRE_CODEC") or None
        validate_wire_codec(env_codec)
        validate_wire_codec(self.cfg.wire_codec)
        self._wire_codec = env_codec or self.cfg.wire_codec or "none"
        self.handler = AveragingPeerHandler(self, chaos=chaos)
        self._loop = BackgroundLoop(name="lah-avg")
        # require_v2: held avg_part replies NEED the out-of-order mux
        # contract — the process-wide legacy/A-B v1 pin (which A/Bs the
        # dispatch path) must not silently break averaging.  Chunk count
        # per partition is capped below max_inflight (step_round), so a
        # partition's held replies can all be in flight at once.
        self._registry = PoolRegistry(require_v2=True)
        # loop-confined round state
        self._epoch = 0
        self._gather: Optional[_LeaderGather] = None
        self._round_active = False
        self._reductions: dict[str, _Reduction] = {}
        # host-side stats (guarded: read by telemetry threads)
        self._stats_lock = sanitizer.lock("averaging.stats")
        self._rounds = 0
        self._degraded_rounds = 0
        self._failed_parts = 0
        self._group_sizes: deque[int] = deque(maxlen=256)
        self._round_times: deque[float] = deque(maxlen=256)
        self._late_join_waits = 0
        self._joins_deferred = 0
        self._matchmaking_failures = 0
        # test hook: die silently after matchmaking (mid-round failure)
        self.debug_die_after_match = False
        # always-on headline metrics (ISSUE 4): scrape-time collector on
        # the process registry, weakref-pruned like the MoE's
        import weakref

        from learning_at_home_tpu_torch.utils.metrics import (
            registry as _metrics_registry,
        )

        ref = weakref.ref(self)

        def _collect():
            av = ref()
            return None if av is None else av._headline_metrics()

        self._collector_key = f"averager-{id(self)}"
        _metrics_registry.register_collector(self._collector_key, _collect)
        try:
            self._server, self.port = self._loop.run(
                self._start_server(host), timeout=10
            )
        except BaseException:
            self._loop.shutdown()
            raise
        self.endpoint = (host, self.port)

    async def _start_server(self, host: str):
        server = await asyncio.start_server(
            self.handler.handle_connection, host, 0
        )
        return server, server.sockets[0].getsockname()[1]

    # ---------------- public API ----------------

    def step_round(
        self, tree: Any, matchmaking_timeout: Optional[float] = None
    ) -> tuple[Any, dict]:
        """One averaging round over ``tree``: matchmake, butterfly
        all-reduce, return ``(averaged_tree, round_info)``.  Raises
        :class:`AveragingFailed` when no group forms within the
        matchmaking budget; a mid-round member death never raises — the
        round completes degraded over the survivors."""
        t0 = time.monotonic()
        # distributed tracing: stamp this round's span (minted only while
        # profiling is on, same contract as the MoE dispatch trace)
        trace = new_trace_id() if timeline.enabled else None
        group = self._matchmake(
            matchmaking_timeout
            if matchmaking_timeout is not None
            else self.cfg.matchmaking_timeout
        )
        if self.debug_die_after_match:
            # simulate a member dying mid-round: the group counts on our
            # parts and our partition, and gets neither
            return None, {"died_after_match": True, "gid": group.gid}
        vec, treedef, specs = flatten_tree(tree)
        bounds = partition_bounds(vec.size, len(group.members))
        sends = self._prepare_sends(group, vec, bounds)
        try:
            result_vec, info = self._run_on_loop(
                self._reduce_async(group, vec, bounds, sends),
                timeout=self.cfg.resolved_round_timeout() + 15,
            )
        except AveragingFailed:
            raise
        except Exception as e:
            self._loop.submit(self._end_round())
            raise AveragingFailed(f"reduction failed: {e!r}") from e
        dt = time.monotonic() - t0
        with self._stats_lock:
            self._rounds += 1
            self._round_times.append(dt)
            self._group_sizes.append(len(group.members))
            if info["degraded"]:
                self._degraded_rounds += 1
            self._failed_parts += len(info["failed_parts"])
        timeline.record("averaging.round", t0, dt, trace=trace)
        timeline.count("averaging.rounds")
        if info["degraded"]:
            timeline.count("averaging.degraded_rounds")
        info.update(epoch=group.epoch, gid=group.gid, round_s=dt)
        return unflatten_tree(result_vec, treedef, specs), info

    @sanitizer.runs_on("host", site="averaging.chunk_prep")
    def _prepare_sends(self, group: Group, vec: np.ndarray, bounds) -> list:
        """Pack-once, OFF the loop: every chunk's WireTensors — including
        any 8-bit quantize (cfg.wire_codec) — is prepared here on the
        caller's host thread; the lah-avg loop only writes ready buffers
        (the sanitizer holds this to the same standard as the client's
        ``_prepare_payloads``).  The raw f32 slice view rides along so a
        peer that turns out not to speak the codec feature gets the
        uncompressed chunk instead (the fallback re-prepares specs only,
        never re-encodes bytes)."""
        from learning_at_home_tpu_torch.utils.serialization import (
            encode_wire_tensors,
        )

        sends = []
        for idx, (pid, mhost, mport, _w) in enumerate(group.members):
            if pid == self.peer_id:
                continue
            lo, hi = bounds[idx]
            # widen chunks so a partition never exceeds the held-reply
            # in-flight budget (see MAX_CHUNKS_PER_PART)
            chunk_elems = max(
                self.cfg.chunk_elems, -((hi - lo) // -MAX_CHUNKS_PER_PART)
            )
            chunks = []
            for off, n in chunk_ranges(hi - lo, chunk_elems):
                raw = vec[lo + off : lo + off + n]
                w_tensors, wmeta = encode_wire_tensors(
                    [raw], self._wire_codec
                )
                chunks.append(
                    (off, n, WireTensors.prepare(w_tensors), wmeta, raw)
                )
            sends.append((idx, pid, (mhost, int(mport)), chunks))
        return sends

    def _headline_metrics(self) -> dict:
        """Always-on counters exported through the unified metrics
        registry (utils/metrics.py) — also the backing data for
        :meth:`stats`, so the two surfaces cannot drift apart."""
        with self._stats_lock:
            times = list(self._round_times)
            out = {
                "lah_averaging_rounds_total": self._rounds,
                "lah_averaging_degraded_rounds_total": self._degraded_rounds,
                "lah_averaging_failed_parts_total": self._failed_parts,
                "lah_averaging_matchmaking_failures_total": (
                    self._matchmaking_failures
                ),
                "lah_averaging_late_join_waits_total": self._late_join_waits,
                "lah_averaging_joins_deferred_total": self._joins_deferred,
            }
        arr = np.asarray(times)
        out["lah_averaging_round_p50_ms"] = (
            round(float(np.percentile(arr, 50)) * 1e3, 3) if arr.size else 0.0
        )
        out["lah_averaging_bytes_sent_total"] = int(
            sum(p.bytes_sent for p in self._registry.pools())
        )
        out["lah_averaging_bytes_received_total"] = int(
            self.handler.bytes_received
        )
        out["lah_averaging_quantized_chunks_total"] = int(
            self.handler.quantized_chunks
        )
        return out

    def stats(self) -> dict:
        """Counters for telemetry/bench JSON; msgpack-safe values only.
        Plumbed through :meth:`_headline_metrics` (the registry's view)
        plus the fields only this surface reports."""

        def pct(values, q):
            arr = np.asarray(values)
            return (
                round(float(np.percentile(arr, q)) * 1e3, 3)
                if arr.size else None
            )

        m = self._headline_metrics()
        with self._stats_lock:
            times = list(self._round_times)
            sizes = list(self._group_sizes)
            out = {
                "peer_id": self.peer_id,
                "epoch": self._epoch,
                "rounds": int(m["lah_averaging_rounds_total"]),
                "degraded_rounds": int(
                    m["lah_averaging_degraded_rounds_total"]
                ),
                "failed_parts": int(m["lah_averaging_failed_parts_total"]),
                "matchmaking_failures": int(
                    m["lah_averaging_matchmaking_failures_total"]
                ),
                "late_join_waits": int(
                    m["lah_averaging_late_join_waits_total"]
                ),
                "joins_deferred": int(
                    m["lah_averaging_joins_deferred_total"]
                ),
            }
        out["group_size_last"] = sizes[-1] if sizes else None
        out["round_p50_ms"] = pct(times, 50)
        out["round_p99_ms"] = pct(times, 99)
        out["bytes_sent"] = int(m["lah_averaging_bytes_sent_total"])
        out["bytes_received"] = int(m["lah_averaging_bytes_received_total"])
        out["wire_codec"] = self._wire_codec
        out["quantized_chunks"] = int(
            m["lah_averaging_quantized_chunks_total"]
        )
        return out

    def shutdown(self) -> None:
        from learning_at_home_tpu_torch.utils.metrics import (
            registry as _metrics_registry,
        )

        _metrics_registry.unregister_collector(self._collector_key)

        async def _close():
            self._server.close()
            self._registry.close()
            for red in self._reductions.values():
                red.fail("averager shut down")
            self._reductions.clear()

        with contextlib.suppress(Exception):
            self._loop.run(_close(), timeout=5)
        self._loop.shutdown()

    def _run_on_loop(self, coro, timeout: float):
        """Submit to the averager loop; a shut-down loop surfaces as
        AveragingFailed (and the coroutine is closed, not leaked)."""
        try:
            return self._loop.run(coro, timeout=timeout)
        except RuntimeError as e:
            coro.close()
            raise AveragingFailed(f"averager unavailable: {e}") from e

    # ---------------- matchmaking ----------------

    def _matchmake(self, timeout: float) -> Group:
        deadline = time.monotonic() + timeout
        declared_until = 0.0
        while True:
            now = time.monotonic()
            if now >= declared_until:
                declare_peer(
                    self.dht, self.cfg.prefix, self.peer_id, self.endpoint,
                    self.cfg.ttl,
                )
                declared_until = now + self.cfg.ttl / 3
            peers = discover_peers(self.dht, self.cfg.prefix)
            peers[self.peer_id] = self.endpoint
            if len(peers) >= self.cfg.min_group_size:
                leader = elect_leader(peers)
                if leader == self.peer_id:
                    group = self._run_on_loop(
                        self._leader_gather(peers),
                        timeout=self.cfg.gather_timeout + 5,
                    )
                else:
                    group = self._run_on_loop(
                        self._join_leader(leader, peers[leader]),
                        timeout=self.cfg.gather_timeout
                        + self.cfg.join_hold + 5,
                    )
                if group is not None:
                    return group
            if time.monotonic() > deadline:
                with self._stats_lock:
                    self._matchmaking_failures += 1
                raise AveragingFailed(
                    f"no group of >= {self.cfg.min_group_size} formed under "
                    f"prefix {self.cfg.prefix!r} within {timeout:.1f}s "
                    f"({len(peers)} peer(s) visible)"
                )
            time.sleep(self.cfg.poll)

    async def _leader_gather(self, peers: dict) -> Optional[Group]:
        """Open a gather window, wait for the expected joins, freeze."""
        self._epoch += 1
        epoch = self._epoch
        gid = f"{self.peer_id}/{epoch}"
        expected = expected_members(peers, self.cfg.max_group_size)
        gather = _LeaderGather(gid, epoch, set(expected) - {self.peer_id})
        self._gather = gather
        try:
            with contextlib.suppress(asyncio.TimeoutError, TimeoutError):
                await asyncio.wait_for(
                    gather.complete.wait(), self.cfg.gather_timeout
                )
        finally:
            gather.frozen = True
            self._gather = None
        if len(gather.joined) + 1 < self.cfg.min_group_size:
            for _pid, (_h, _p, _w, fut) in gather.joined.items():
                if not fut.done():
                    fut.set_result({"status": "retry"})
            return None
        members = sorted(
            [(self.peer_id, self.endpoint[0], self.endpoint[1],
              float(self.cfg.weight))]
            + [
                (pid, h, p, w)
                for pid, (h, p, w, _fut) in gather.joined.items()
            ]
        )
        group = Group(gid=gid, epoch=epoch, members=members)
        self._round_active = True
        reply = {
            "status": "ok", "gid": gid, "epoch": epoch,
            "members": [[pid, h, p, w] for pid, h, p, w in members],
        }
        for _pid, (_h, _p, _w, fut) in gather.joined.items():
            if not fut.done():
                fut.set_result(reply)
        return group

    async def _join_leader(self, leader: str, endpoint) -> Optional[Group]:
        pool = self._registry.get(endpoint)
        try:
            _, meta = await pool.rpc(
                "avg_join", (),
                {
                    "peer": self.peer_id,
                    "ep": [self.endpoint[0], self.endpoint[1]],
                    "w": float(self.cfg.weight),
                },
                timeout=self.cfg.gather_timeout + self.cfg.join_hold + 2,
            )
        except (TimeoutError, OSError, ConnectionError, RemoteCallError,
                asyncio.CancelledError):
            return None
        status = meta.get("status")
        if status == "ok":
            members = [
                (str(pid), str(h), int(p), float(w))
                for pid, h, p, w in meta.get("members") or []
            ]
            if not any(pid == self.peer_id for pid, *_ in members):
                return None  # malformed reply: we're not in our own group
            self._round_active = True
            return Group(
                gid=str(meta["gid"]), epoch=int(meta["epoch"]),
                members=sorted(members),
            )
        if status == "wait":
            with self._stats_lock:
                self._late_join_waits += 1
        return None

    # ---------------- handler entry points (loop) ----------------

    async def _on_join(self, meta: dict) -> dict:
        pid = meta.get("peer")
        ep = meta.get("ep") or []
        weight = float(meta.get("w", 1.0))
        if not isinstance(pid, str) or len(ep) != 2:
            raise ValueError("avg_join needs peer id and ep [host, port]")
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.cfg.join_hold
        while True:
            gather = self._gather
            if gather is not None and not gather.frozen:
                room = len(gather.joined) + 1 < self.cfg.max_group_size
                if pid in gather.expected or room:
                    old = gather.joined.pop(pid, None)
                    if old is not None and not old[3].done():
                        old[3].set_result({"status": "retry"})
                    fut = loop.create_future()
                    gather.joined[pid] = (str(ep[0]), int(ep[1]), weight, fut)
                    if gather.expected <= set(gather.joined):
                        gather.complete.set()
                    return await fut
            elif self._round_active:
                with self._stats_lock:
                    self._joins_deferred += 1
                return {"status": "wait", "epoch": self._epoch}
            if loop.time() >= deadline:
                return {"status": "retry"}
            await asyncio.sleep(0.05)

    async def _on_part(self, meta: dict, tensors) -> np.ndarray:
        chunk = as_f32_chunk(tensors)
        gid = meta.get("gid")
        sender = meta.get("sender")
        if not isinstance(gid, str) or not isinstance(sender, str):
            raise ValueError("avg_part needs gid and sender")
        red = self._reductions.get(gid)
        if red is None:
            red = _Reduction(gid, asyncio.get_running_loop())
            self._reductions[gid] = red
            self._schedule_gc()
        fut = red.add_chunk(
            sender, float(meta.get("w", 1.0)), int(meta["part_len"]),
            int(meta.get("off", 0)), chunk,
        )
        return await fut

    _gc_task: Optional[asyncio.Task] = None

    def _schedule_gc(self) -> None:
        if self._gc_task is None or self._gc_task.done():
            self._gc_task = asyncio.get_running_loop().create_task(
                self._gc_reductions(), name="lah-avg-gc"
            )

    async def _gc_reductions(self) -> None:
        """Reap finished reductions (short linger for late chunks) and
        fail orphans no local round ever attached (our matchmaking died
        between freeze and reduce)."""
        while self._reductions:
            await asyncio.sleep(1.0)
            now = asyncio.get_running_loop().time()
            for gid, red in list(self._reductions.items()):
                if red.finished is not None and now - red.finished > 10.0:
                    del self._reductions[gid]
                elif (
                    not red.attached
                    and red.result is None
                    and now - red.created > self.cfg.orphan_ttl
                ):
                    red.fail(f"no local round attached group {gid}")
                    del self._reductions[gid]

    async def _end_round(self) -> None:
        self._round_active = False

    # ---------------- reduction ----------------

    async def _reduce_async(
        self, group: Group, vec: np.ndarray, bounds: list, sends: list
    ) -> tuple[np.ndarray, dict]:
        loop = asyncio.get_running_loop()
        try:
            my_index = next(
                i for i, (pid, *_ ) in enumerate(group.members)
                if pid == self.peer_id
            )
            lo, hi = bounds[my_index]
            expected = {pid: w for pid, _h, _p, w in group.members}
            red = self._reductions.get(group.gid)
            if red is None:
                red = _Reduction(group.gid, loop)
                self._reductions[group.gid] = red
                self._schedule_gc()
            red.attach(
                part_len=hi - lo, expected=expected, own_pid=self.peer_id,
                own_weight=float(self.cfg.weight), own_slice=vec[lo:hi],
                timeout=self.cfg.part_timeout,
            )

            async def own_part() -> np.ndarray:
                await red.done.wait()
                return red.result

            tasks: dict[int, asyncio.Task] = {
                my_index: loop.create_task(own_part())
            }
            for idx, _pid, endpoint, chunks in sends:
                tasks[idx] = loop.create_task(
                    self._send_part(group, idx, endpoint, chunks)
                )
            done, pending = await asyncio.wait(
                tasks.values(), timeout=self.cfg.resolved_round_timeout()
            )
            for task in pending:
                # round deadline: stragglers are cancelled with the
                # explicit marker so the transport folds their elapsed
                # wait into the RTT EMA (utils/connection.py contract)
                task.cancel(msg=QUORUM_STRAGGLER_CANCEL)
            for task in pending:
                with contextlib.suppress(BaseException):
                    await task
            result = vec.copy()
            failed_parts = []
            for idx, task in tasks.items():
                part = None
                if task in done and not task.cancelled():
                    exc = task.exception()
                    if exc is None:
                        # lah-lint: ignore[R2] task is in the done set —
                        # result() on a finished Task returns immediately
                        part = task.result()
                    else:
                        logger.warning(
                            "averaging part %d of %s failed: %r",
                            idx, group.gid, exc,
                        )
                if part is None:
                    failed_parts.append(idx)  # keep local values
                else:
                    plo, phi = bounds[idx]
                    result[plo:phi] = part
            degraded = bool(failed_parts) or red.degraded
            timeline.count(
                "averaging.bytes_sent",
                sum(c[2].nbytes for s in sends for c in s[3]),
            )
            return result, {
                "group_size": len(group.members),
                "degraded": degraded,
                "failed_parts": failed_parts,
                "missing_senders": list(red.missing),
                "members": [pid for pid, *_ in group.members],
            }
        finally:
            self._round_active = False

    async def _send_part(
        self, group: Group, part_index: int, endpoint, chunks: list
    ) -> np.ndarray:
        """Stream one partition's chunks to its owner and reassemble the
        averaged replies.  Any chunk failure fails the partition."""
        pool = self._registry.get(endpoint)
        part_len = sum(n for _off, n, *_rest in chunks)
        out = np.empty(part_len, np.float32)
        sender_timeout = self.cfg.resolved_sender_timeout()

        async def one(
            off: int, n: int, wire: WireTensors, wmeta, raw
        ) -> None:
            meta = {
                "gid": group.gid,
                # `part` is a diagnostic partition index for peer logs
                # and chaos traces; the receiver deliberately keys on
                # gid/off/part_len only (PROTOCOL.md avg_part field rows)
                # lah-lint: ignore[R12]
                "part": part_index,
                "sender": self.peer_id, "w": float(self.cfg.weight),
                "off": off, "part_len": part_len,
            }
            use_wire = wire
            if wmeta is not None:
                # encoded chunks are only OFFERED to owners that speak
                # the codec feature; negotiate first (idempotent, locked)
                # so the decision is made before the first byte moves.
                # An old-build owner gets the raw f32 slice — a spec-walk
                # re-prepare over the existing view, never a re-encode.
                await pool.ensure_negotiated(sender_timeout)
                if pool.supports("codec"):
                    meta["wire"] = wmeta
                else:
                    # lah-lint: ignore[R1] raw-fallback re-prepare: specs only
                    # over the retained f32 slice VIEW — O(1) spec walk,
                    # no tensor bytes encoded or copied on the loop
                    use_wire = WireTensors.prepare([raw])
            tensors, _meta = await pool.rpc_prepared(
                "avg_part", use_wire, meta, timeout=sender_timeout,
            )
            chunk = as_f32_chunk(tensors)
            if len(chunk) != n:
                raise ValueError(
                    f"averaged chunk of {len(chunk)} elements, expected {n}"
                )
            out[off : off + n] = chunk

        chunk_tasks = [
            asyncio.get_running_loop().create_task(one(off, n, w, wm, raw))
            for off, n, w, wm, raw in chunks
        ]
        try:
            await asyncio.gather(*chunk_tasks)
        except BaseException:
            # one failed chunk fails the partition — release the sibling
            # RPCs' in-flight slots NOW instead of letting them ride to
            # sender_timeout and starve the next round to this peer
            for task in chunk_tasks:
                if not task.done():
                    task.cancel()
            for task in chunk_tasks:
                with contextlib.suppress(BaseException):
                    await task
            raise
        return out
