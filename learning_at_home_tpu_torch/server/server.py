"""Server: the top-level expert-hosting peer.

The port of ``learning_at_home_tpu/server/server.py``: N ExpertBackends
on one device behind the framed tensor RPC protocol (the JAX package's
wire, byte for byte), a metrics endpoint, checkpoints, and — given a
``dht`` — the liveness heartbeat that re-declares the experts every
``update_period`` with TTL ``2 × update_period`` (record expiry is the
swarm's failure detector), bundled with the ``telemetry.``, ``load.``,
``links.`` and ``replicas.wanted.`` records.  Three execution domains in
one process:

- **event loop** (BackgroundLoop thread ``lah-server``): TCP accept, RPC
  parse, task pools, DHT client calls — all non-blocking;
- **Runtime thread** (``lah-runtime``): the single device consumer
  launching expert kernels (torch releases the GIL inside them);
- **main thread**: owns lifecycle (start/shutdown), free for user code.

The elastic tier is the JAX package's too: graceful drain and live
migration (``server/lifecycle.py``; SERVING → DRAINING → DRAINED, the
heartbeat stops declaring experts while it drains), replicas
(``add_replica``, ``ReplicaSync`` over ``averaging/``), and the native
data plane (``transport="native"``: the C++ frame pump of ``native/``,
which raises where it cannot be built — never a quiet fall back to
asyncio).  Handoffs and replicas cross packages: a replica or a migrated
expert is built from the uid's crc32 key, which draws the JAX package's
weights (``models/layers.py``).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import threading
import time
import weakref
import zlib
from typing import Any, Optional

import torch

from learning_at_home_tpu_torch.device import resolve_device
from learning_at_home_tpu_torch.models.layers import make_expert, sample_inputs
from learning_at_home_tpu_torch.optim import GradientTransformation, adam, sgd
from learning_at_home_tpu_torch.random import PRNGKey
from learning_at_home_tpu_torch.server import lifecycle
from learning_at_home_tpu_torch.server.connection_handler import ConnectionHandler
from learning_at_home_tpu_torch.server.expert_backend import ExpertBackend
from learning_at_home_tpu_torch.server.lifecycle import HandoffReceiver
from learning_at_home_tpu_torch.server.runtime import Runtime
from learning_at_home_tpu_torch.server.task_pool import TaskPool
from learning_at_home_tpu_torch.utils import flight, sanitizer
from learning_at_home_tpu_torch.utils.asyncio_utils import BackgroundLoop

logger = logging.getLogger(__name__)

Endpoint = tuple[str, int]


def uid_key(uid: str) -> torch.Tensor:
    """The key every process that hosts ``uid`` draws its expert from:
    ``PRNGKey(crc32(uid) & 0x7FFFFFFF)``, as the JAX package's."""
    return PRNGKey(zlib.crc32(uid.encode()) & 0x7FFFFFFF)


class Server:
    """Hosts a set of ExpertBackends behind the framed tensor RPC protocol."""

    def __init__(
        self,
        experts: dict[str, ExpertBackend],
        host: str = "0.0.0.0",
        port: int = 0,
        dht: Any = None,
        update_period: float = 15.0,
        batch_timeout: float = 0.002,
        chaos: Any = None,
        transport: str = "asyncio",
        telemetry_prefix: str = "swarm",
    ):
        if transport not in ("asyncio", "native"):
            raise ValueError(
                f"transport must be 'asyncio' or 'native', got {transport!r}")
        self.transport = transport
        self._pump = None
        self._native_threads: list[threading.Thread] = []
        self._native_stop = threading.Event()
        # conn_id -> tail future; the one native worker thread is the only
        # reader and writer, so no lock — and a SINGLE popper is what
        # makes per-connection reply order a guarantee (pop, chain-link
        # and callback-attach happen in program order on one thread)
        self._native_chains: dict[int, Any] = {}
        self.experts = dict(experts)
        self.host, self._requested_port = host, port
        self.dht = dht
        self.chaos = chaos.make() if hasattr(chaos, "make") else chaos
        self.update_period = update_period
        self.batch_timeout = batch_timeout
        # replica installs in flight (serving-loop state: single-threaded
        # there, so a set is race-free without a lock)
        self._replicas_installing: set[str] = set()
        self.runtime = Runtime()
        self.forward_pools: dict[str, TaskPool] = {}
        self.backward_pools: dict[str, TaskPool] = {}
        for uid, backend in self.experts.items():
            # forward and backward pools share serial_key=uid: the Runtime's
            # double buffering may overlap DIFFERENT experts' jobs, but a
            # backward rewrites this expert's params while a forward reads
            # them — same-expert jobs must never be in flight together.
            # warm_buckets is a callable so warmup run AFTER Server
            # construction still registers in the pools' telemetry
            warm = lambda b=backend: getattr(b, "warm_buckets", ())
            self.forward_pools[uid] = TaskPool(
                backend.forward,
                f"{uid}.forward",
                max_batch_size=backend.max_batch_size,
                batch_timeout=batch_timeout,
                serial_key=uid,
                warm_buckets=warm,
            )
            self.backward_pools[uid] = TaskPool(
                lambda tensors, b=backend: b.backward(
                    tensors[: b.n_inputs], tensors[b.n_inputs :]
                ),
                f"{uid}.backward",
                max_batch_size=backend.max_batch_size,
                batch_timeout=batch_timeout,
                serial_key=uid,
                warm_buckets=warm,
            )
        self._loop: Optional[BackgroundLoop] = None
        self._tcp_server: Optional[asyncio.base_events.Server] = None
        self._ready = threading.Event()
        self.port: Optional[int] = None
        # observability: every server hosts a tiny metrics endpoint
        # (Prometheus + JSON + chrome trace) on its own loop and
        # advertises it under the telemetry.<prefix> DHT key — same
        # TTL-as-failure-detector contract as expert heartbeats
        self.telemetry_prefix = telemetry_prefix
        self.metrics_server: Any = None
        self.metrics_port: Optional[int] = None
        self._metrics_loop: Optional[BackgroundLoop] = None
        # per-expert queue-depth EMAs sampled on the serving loop; experts
        # over the hot threshold show in the stats RPC
        self._queue_ema: dict[str, float] = {}
        try:
            self.hot_depth_threshold = float(
                os.environ.get("LAH_REPLICA_HOT_DEPTH", "8")
            )
        except ValueError:
            self.hot_depth_threshold = 8.0
        # how this server builds another expert of its zoo on request
        # (set by Server.create), and the ONLY place add_replica looks for
        # a warmer start than the uid's crc32 init — never a peer path
        self._replica_recipe: Optional[dict] = None
        self.replica_checkpoint_root: Optional[str] = None
        self.replica_uids: set[str] = set()
        self._replica_syncs: dict[str, "ReplicaSync"] = {}
        # elastic lifecycle: SERVING -> DRAINING -> DRAINED.  The flag is
        # written by the lah-drain thread (under the lifecycle lock) and
        # only READ by the serving loop's heartbeat and handoff handler —
        # plain attribute reads (docs/CONCURRENCY.md invariant 10)
        self.lifecycle_state: str = lifecycle.SERVING
        self.started_at = time.monotonic()
        self.restarts = 0  # set by the CLI from the checkpoint root
        self.draining_since: Optional[float] = None
        self.migrated_in: set[str] = set()  # uids received via handoff
        # outbound single-expert moves (the ``migrate`` RPC's lah-migrate
        # thread); at most one in flight (the uid mid-move, else None)
        self.migrations_out = 0
        self.migration_failures = 0
        self._migration_uid: Optional[str] = None
        self.handoff = HandoffReceiver(self)
        self._lifecycle_lock = sanitizer.lock("server.lifecycle")
        self._drain_thread: Optional[threading.Thread] = None
        self._drained = threading.Event()
        self.drain_summary: Optional[dict] = None
        self.checkpoint_manager: Any = None
        self._register_metrics_collector()

    def _register_metrics_collector(self) -> None:
        """Expose this server's always-on headline counters through the
        process metrics registry — scrape-time attribute reads only, and
        weakref-pruned once the server is garbage-collected."""
        from learning_at_home_tpu_torch.utils.metrics import registry

        ref = weakref.ref(self)

        def _collect():
            srv = ref()
            return None if srv is None else srv._headline_metrics()

        self._collector_key = f"server-{id(self)}"
        registry.register_collector(self._collector_key, _collect)

    def _headline_metrics(self) -> dict:
        """The always-on production counters: runtime pipeline, padding
        waste, staging reuse, buckets, expert updates — plain int/float
        reads, no locks, no spans."""
        rt = self.runtime
        staging = rt.staging.stats()
        rows = padded = batches = cold = hits = 0
        for pool_map in (self.forward_pools, self.backward_pools):
            for p in pool_map.values():
                rows += p.total_rows
                padded += p.padded_rows
                batches += p.batches_formed
                bs = p.bucket_stats()
                cold += bs["cold_compiles"]
                hits += bs["cache_hits"]
        return {
            "lah_server_experts_total": len(self.experts),
            "lah_server_updates_total": sum(
                b.update_count for b in self.experts.values()
            ),
            "lah_server_jobs_processed_total": rt.jobs_processed,
            "lah_server_jobs_overlapped_total": rt.jobs_overlapped,
            "lah_server_queue_depth": rt.queue_depth,
            "lah_server_queue_depth_max": rt.queue_depth_max,
            "lah_server_stack_seconds_total": rt.stack_time,
            "lah_server_materialize_seconds_total": rt.materialize_time,
            "lah_server_device_seconds_total": rt.device_time,
            "lah_server_staging_allocated_total": staging["allocated"],
            "lah_server_staging_reused_total": staging["reused"],
            "lah_server_rows_total": rows,
            "lah_server_padded_rows_total": padded,
            "lah_server_batches_formed_total": batches,
            "lah_server_bucket_cold_compiles_total": cold,
            "lah_server_bucket_cache_hits_total": hits,
            # replicas this server hosts for other hosters, and experts
            # over the hot queue-depth threshold
            "lah_server_replica_experts_total": len(self.replica_uids),
            "lah_server_hot_experts": sum(
                1 for v in self._snap_queue_ema().values()
                if v >= self.hot_depth_threshold
            ),
            # lifecycle: drain state, peer age, restarts from a
            # checkpoint, verified migrations in
            "lah_server_draining": (
                0.0 if self.lifecycle_state == lifecycle.SERVING else 1.0
            ),
            "lah_server_uptime_seconds": time.monotonic() - self.started_at,
            "lah_server_restarts_total": self.restarts,
            "lah_server_handoffs_received_total": self.handoff.received,
            # outbound moves, and moves whose handoff failed (source kept)
            "lah_placement_migrations_out_total": self.migrations_out,
            "lah_placement_migration_failures_total": (
                self.migration_failures
            ),
            **self._port_gauges(),
        }

    def _port_gauges(self) -> dict:
        """The port's own headline gauges: on a CUDA card, the caching
        allocator's peak bytes in this process; on the native transport,
        the frames the pump handed over and the replies it queued (the
        stats RPC's ``metrics`` section carries them)."""
        out = {}
        pump = self._pump
        if pump is not None:
            out["lah_server_native_frames_in_total"] = pump.frames_in
            out["lah_server_native_frames_out_total"] = pump.frames_out
        recipe = self._replica_recipe or {}
        cards = {b.device for b in self.experts.values()
                 if b.device.type == "cuda"}
        if recipe.get("device") is not None and recipe["device"].type == "cuda":
            cards.add(recipe["device"])
        if cards:
            out["lah_server_device_peak_bytes"] = \
                torch.cuda.max_memory_allocated(cards.pop())
        return out

    def _snap_queue_ema(self) -> dict:
        # the serving loop replaces entries in place; scrape threads
        # copy-with-retry like every other telemetry read
        for _ in range(4):
            try:
                return dict(self._queue_ema)
            except RuntimeError:
                continue
        return {}

    # ---- lifecycle ----

    @classmethod
    def create(
        cls,
        num_experts: int = 4,
        expert_cls: str = "ffn",
        hidden_dim: int = 1024,
        expert_prefix: str = "expert",
        expert_offset: int = 0,
        optimizer: Optional[GradientTransformation] = None,
        max_batch_size: int = 1024,
        warmup=False,
        seed: int = 0,
        start: bool = True,
        expert_uids=None,
        device=None,
        **server_kwargs,
    ) -> "Server":
        """Build a server from the expert zoo and (optionally) start it.

        Expert UIDs are ``{prefix}.{offset+i}``, each initialised from
        ``PRNGKey(seed + i)``; or pass ``expert_uids`` (an explicit
        iterable) to host arbitrary uids, each from ``PRNGKey(crc32(uid) &
        0x7FFFFFFF)`` — so every process that ever hosts a uid, of this
        package or the JAX one, initializes identical weights (the
        draws are flax's, ``models/layers.py``; the card draws the CPU's
        values).
        Experts, their optimizer state and compute live on ``device``
        (None: the CUDA card; raises where there is none).  ``warmup``
        records the batch buckets and the output schema before returning:
        ``True`` = all power-of-two buckets, or a list of bucket sizes."""
        dev = resolve_device(device)
        optimizer = optimizer if optimizer is not None else adam(1e-3)
        if expert_uids is not None:
            uid_keys = [(uid, uid_key(uid)) for uid in expert_uids]
        else:
            uid_keys = [
                (f"{expert_prefix}.{i}", PRNGKey(seed + i))
                for i in range(expert_offset, expert_offset + num_experts)
            ]
        experts = {}
        n_wire_inputs = len(sample_inputs(expert_cls, hidden_dim))
        t0 = time.monotonic()
        for uid, key in uid_keys:
            apply_fn, params = make_expert(expert_cls, hidden_dim, key,
                                           device=dev)
            experts[uid] = ExpertBackend(
                uid, apply_fn, params, optimizer,
                max_batch_size=max_batch_size, n_inputs=n_wire_inputs,
                device=dev,
            )
        logger.info("built %d %r experts on %s in %.1fs", len(experts),
                    expert_cls, dev, time.monotonic() - t0)
        if warmup:
            t0 = time.monotonic()
            sample = sample_inputs(expert_cls, hidden_dim, rows=1)
            buckets = None if warmup is True else list(warmup)
            n = sum(
                backend.warmup(sample, buckets=buckets)
                for backend in experts.values()
            )
            logger.info(
                "warmed %d buckets in %.1fs", n, time.monotonic() - t0
            )
        server = cls(experts, **server_kwargs)
        # everything needed to build ANOTHER expert of this zoo on demand
        # — the replica and handoff paths construct backends from this
        server._replica_recipe = {
            "expert_cls": expert_cls,
            "hidden_dim": hidden_dim,
            "optimizer": optimizer,
            "max_batch_size": max_batch_size,
            "n_inputs": n_wire_inputs,
            "device": dev,
            # whether THIS server's experts were crc32-uid-seeded (the
            # cross-process identical-init contract replicas rely on); a
            # server booted EMPTY (the replica-host pattern) carries no
            # conflicting evidence and stays on the crc32 contract
            "uid_seeded": expert_uids is not None or not uid_keys,
        }
        if start:
            server.run_in_background()
        return server

    def run_in_background(self, await_ready: bool = True) -> "Server":
        if self._loop is not None:
            raise RuntimeError("server already started")
        self._start_metrics_endpoint()
        self._loop = BackgroundLoop(name="lah-server")
        self.runtime.attach_loop(self._loop.loop)
        self.runtime.start()
        self._loop.run(self._start_async())
        if self.metrics_server is not None:
            # known only after the RPC socket binds; purely informational
            self.metrics_server.meta["rpc_port"] = self.port
        if await_ready:
            self._ready.wait(timeout=30)
        return self

    def _start_metrics_endpoint(self) -> None:
        """Per-server observability endpoint on its OWN loop thread: a
        /trace or /metrics.json scrape can serialize megabytes of JSON,
        and that must never stall the RPC serving loop."""
        from learning_at_home_tpu_torch.utils.metrics import MetricsHTTPServer

        self.metrics_server = MetricsHTTPServer(
            meta={"role": "server"}, extra_fn=self._telemetry_extra,
        )
        self._metrics_loop = BackgroundLoop(name="lah-metrics")
        try:
            self.metrics_port = self._metrics_loop.run(
                self.metrics_server.start(self.host), timeout=10
            )
        except Exception:
            logger.exception("metrics endpoint failed to start; serving blind")
            self._metrics_loop.shutdown()
            self.metrics_server = self.metrics_port = self._metrics_loop = None

    async def _start_async(self) -> None:
        handler = ConnectionHandler(self)
        if self.transport == "native":
            # GIL-free C++ epoll data plane (native/framepump.cpp): the
            # Python worker thread only sees whole frames and bridges them
            # onto the event loop for task-pool dispatch
            from learning_at_home_tpu_torch.native import FramePump

            self._pump = FramePump(self.host, self._requested_port)
            self.port = self._pump.port
            t = threading.Thread(
                target=self._native_worker, args=(handler,),
                name="lah-native-io", daemon=True,
            )
            t.start()
            self._native_threads.append(t)
        else:
            self._tcp_server = await asyncio.start_server(
                handler.handle_connection, self.host, self._requested_port
            )
            self.port = self._tcp_server.sockets[0].getsockname()[1]
        for pool in (*self.forward_pools.values(), *self.backward_pools.values()):
            pool.start(self.runtime)
        loop = asyncio.get_running_loop()
        self._load_monitor = loop.create_task(
            self._monitor_load_forever(), name="load-monitor"
        )
        if self.dht is not None:
            self._heartbeat = loop.create_task(
                self._declare_experts_forever(), name="dht-heartbeat"
            )
        logger.info(
            "server listening on %s:%d with %d experts (metrics on :%s)",
            self.host, self.port, len(self.experts), self.metrics_port,
        )
        self._ready.set()

    def _telemetry_extra(self) -> dict:
        """Per-request payload merged into ``/metrics.json``: per-expert
        update counts and the runtime/pool breakdown."""
        return {
            "experts": {
                uid: b.update_count for uid, b in self.experts.items()
            },
            "replicas": sorted(self.replica_uids),
            "hot": self.hot_experts(),
            "runtime": self.runtime.stats(),
            "endpoint": list(self.endpoint),
            "lifecycle": self.lifecycle_info(),
            "placement": self.placement_info(),
            # the port's addition: each synced replica's rounds and its
            # parameter crcs (ReplicaSync.stats)
            "replica_sync": {uid: sync.stats() for uid, sync
                             in list(self._replica_syncs.items())},
        }

    def placement_info(self) -> dict:
        """Serializable placement-actuation snapshot (stats RPC +
        telemetry extra): outbound move counters and the uid mid-move
        (None when idle)."""
        return {
            "migrations_out": self.migrations_out,
            "migration_failures": self.migration_failures,
            "migration_in_flight": self._migration_uid,
        }

    def lifecycle_info(self) -> dict:
        """Serializable lifecycle snapshot (stats RPC + telemetry extra):
        state, uptime, restart-from-checkpoint count, drain progress and
        inbound-migration counters."""
        info = {
            "state": self.lifecycle_state,
            "uptime_s": round(time.monotonic() - self.started_at, 1),
            "restarts": self.restarts,
            "handoff": self.handoff.stats(),
            "migrated_in": sorted(self.migrated_in),
        }
        if self.draining_since is not None:
            info["draining_for_s"] = round(
                time.monotonic() - self.draining_since, 1
            )
        if self.drain_summary is not None:
            info["drain_summary"] = self.drain_summary
        return info

    def _native_worker(self, handler: ConnectionHandler) -> None:
        """THE single dispatcher thread: shovels whole frames from the
        native pump onto the event loop (task pools are asyncio) WITHOUT
        waiting for each dispatch — the reply is pushed back to the pump
        from a done-callback, so in-flight concurrency matches the asyncio
        transport's one-coroutine-per-request.

        Dispatches are CHAINED per connection: request N+1 on a connection
        starts only after request N's reply was queued, making in-order
        replies a server guarantee (the asyncio transport serves each
        connection serially too).  Being the only popper is what makes the
        chain sound: pop, link and callback-attach happen in program order
        here, with no lock and no second thread to invert frames."""
        from learning_at_home_tpu_torch.utils.serialization import (
            frame_payload,
        )

        pump = self._pump
        chains = self._native_chains  # conn_id -> tail future (this thread)

        async def process(prev, payload: bytes):
            if prev is not None:
                try:
                    await asyncio.wrap_future(prev)
                # lah-lint: ignore[R6] ordering barrier only: the prior
                # request's failure was already logged (and replied) where
                # it happened; this await exists to sequence replies
                except BaseException:
                    pass
            # the pump's C side frames replies itself: join the vectored
            # parts back into one payload (no writev through ctypes)
            reply = frame_payload(await handler._dispatch(payload))
            if self.chaos is not None and not await self.chaos.before_reply(
                len(payload) + len(reply)
            ):
                return None  # injected drop: the client sees a timeout
            return reply

        def reply_cb(fut, conn_id):
            try:
                reply = fut.result()
            except BaseException as e:  # incl. CancelledError at shutdown
                if not isinstance(e, asyncio.CancelledError):
                    logger.exception("native dispatch failed")
                return
            if reply is None:
                return
            try:
                pump.send(conn_id, reply)  # cheap: C memcpy + eventfd
            except ValueError:
                logger.error("native reply exceeds frame cap — dropped")

        n_since_cleanup = 0
        while True:
            if self._native_stop.is_set():
                return
            try:
                item = pump.next(timeout=0.2)
            except EOFError:
                return
            loop = self._loop  # snapshot: shutdown() nulls the attribute
            if item is None or loop is None:
                if loop is None:
                    return
                continue
            conn_id, payload = item
            prev = chains.get(conn_id)
            if prev is not None and prev.done():
                prev = None
            try:
                fut = asyncio.run_coroutine_threadsafe(
                    process(prev, payload), loop.loop
                )
            except RuntimeError:  # loop closed mid-shutdown
                return
            chains[conn_id] = fut
            # callback attached HERE, still in the dispatcher: attaching
            # after releasing ordering control could let reply N land after
            # N+1 (reply_cb of an already-done future runs inline)
            fut.add_done_callback(lambda f, cid=conn_id: reply_cb(f, cid))
            n_since_cleanup += 1
            if n_since_cleanup >= 256:  # lazily drop finished chains
                n_since_cleanup = 0
                for cid in [c for c, f in chains.items() if f.done()]:
                    del chains[cid]

    async def _monitor_load_forever(self) -> None:
        """Per-expert queue-depth EMA sampler (serving loop; qsize reads
        only — never tensor work)."""
        period = min(1.0, max(0.1, self.update_period / 4))
        while True:
            try:
                for uid, pool in list(self.forward_pools.items()):
                    depth = pool._tasks.qsize() + (
                        1 if pool._carry is not None else 0
                    )
                    prev = self._queue_ema.get(uid, 0.0)
                    self._queue_ema[uid] = 0.7 * prev + 0.3 * depth
            except Exception:  # telemetry must never kill the loop task
                logger.exception("load monitor sample failed")
            await asyncio.sleep(period)

    def hot_experts(self) -> dict[str, float]:
        """uids whose queue-depth EMA crossed the hot threshold → EMA."""
        return {
            uid: round(ema, 3)
            for uid, ema in self._snap_queue_ema().items()
            if ema >= self.hot_depth_threshold
        }

    async def _declare_experts_forever(self) -> None:
        """Liveness heartbeat: re-declare the experts so their DHT records
        stay fresh, and advertise the metrics endpoint under
        ``telemetry.<prefix>`` with the same TTL — one missed cycle and
        the swarm view marks this peer dead.  The same cycle publishes the
        ``load.<prefix>`` record (runtime queue depth and the per-expert
        hot map, keyed by this RPC endpoint), the ``links.<prefix>``
        record (this process's measured link EMAs) and one
        ``replicas.wanted.<prefix>`` entry per hot expert — all in one
        ``declare_experts`` bundle: one store RPC per destination peer.
        While draining only the telemetry record is re-stored."""
        from learning_at_home_tpu_torch.utils.telemetry import (
            link_snapshot,
            links_key,
            load_key,
            replicas_wanted_key,
            telemetry_key,
        )

        peer_id = f"server-{self.endpoint[0]}:{self.port}"
        ep_key = f"{self.endpoint[0]}:{self.port}"
        while True:
            try:
                serving = self.lifecycle_state == lifecycle.SERVING
                ttl = self.update_period * 2
                extra: list[tuple] = []
                if self.metrics_port is not None:
                    # telemetry keeps heartbeating through the drain so
                    # observers see DRAINING, not a dead peer
                    extra.append((
                        telemetry_key(self.telemetry_prefix),
                        [self.endpoint[0], self.metrics_port, "server"],
                        ttl, peer_id,
                    ))
                if serving:
                    hot = self.hot_experts()
                    extra.append((
                        load_key(self.telemetry_prefix),
                        {
                            "q": float(self.runtime.queue_depth),
                            "n": len(self.experts),
                            "hot": hot,
                        },
                        ttl, ep_key,
                    ))
                    links = link_snapshot()
                    if links:
                        extra.append((
                            links_key(self.telemetry_prefix),
                            {"l": links}, ttl, ep_key,
                        ))
                    for uid, ema in hot.items():
                        extra.append((
                            replicas_wanted_key(self.telemetry_prefix),
                            [ema, self.endpoint[0], self.port],
                            ttl, uid,
                        ))
                    # a DRAINING server stops re-declaring its experts (and
                    # its load/wanted records): the records it published
                    # expire within one TTL and new dispatch steers away
                    await self.dht.declare_experts(
                        list(self.experts), self.endpoint,
                        expiration=ttl, extra_records=extra,
                    )
                elif extra:
                    await self.dht.store_many(extra)
            except Exception:
                logger.exception("declare_experts heartbeat failed")
            await asyncio.sleep(self.update_period)

    # ---- checkpoint / resume ----

    def save_checkpoint(self, root: str, step: Optional[int] = None) -> int:
        """Snapshot every expert's params+opt_state (safe during serving:
        each snapshot serializes against that expert's updates).
        ``step=None`` picks the next unused step number; the completion
        marker is written only after every expert saved, so a crash
        mid-save can never masquerade as a usable checkpoint.  Returns
        the step saved."""
        from learning_at_home_tpu_torch.utils.checkpoint import (
            mark_step_complete,
            next_step,
            save_pytree,
        )

        step = next_step(root) if step is None else step
        experts = dict(self.experts)
        if not experts:
            # never mark an EMPTY step complete: the latest-step restore
            # would prefer it over the last real snapshot
            logger.warning(
                "checkpoint skipped: no experts to save (root %s)", root
            )
            return step
        for uid, backend in experts.items():
            save_pytree(root, step, uid.replace("/", "_"), backend.state_dict())
        mark_step_complete(root, step)
        logger.info("checkpointed %d experts to %s @ step %d",
                    len(experts), root, step)
        return step

    def load_checkpoint(self, root: str, step: Optional[int] = None) -> int:
        """Restore every hosted expert found in the checkpoint; returns the
        step restored."""
        from learning_at_home_tpu_torch.utils.checkpoint import (
            latest_step,
            restore_pytree,
        )

        step = step if step is not None else latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint steps under {root}")
        for uid, backend in self.experts.items():
            state = restore_pytree(
                root, step, uid.replace("/", "_"), backend.state_template()
            )
            backend.load_state_dict(state)
        logger.info("restored %d experts from %s @ step %d",
                    len(self.experts), root, step)
        return step

    # ---- elastic lifecycle: graceful drain + live migration ----

    def pools_idle(self) -> bool:
        """True when no task pool holds queued/carried work and the
        Runtime queue is empty — the quiesce predicate the drain polls.
        Cross-thread reads of loop-owned state: qsize/attribute reads
        only, tolerate-never-crash like every other telemetry read."""
        try:
            if self.runtime.queue_depth > 0:
                return False
            for pool_map in (self.forward_pools, self.backward_pools):
                for pool in list(pool_map.values()):
                    if pool._tasks.qsize() > 0 or pool._carry is not None:
                        return False
        except RuntimeError:  # dict mutated under us: call it busy
            return False
        return True

    def _begin_drain(self) -> bool:
        """Atomically flip SERVING -> DRAINING; True if already past it."""
        with self._lifecycle_lock:
            if self.lifecycle_state != lifecycle.SERVING:
                return True
            self.lifecycle_state = lifecycle.DRAINING
            self.draining_since = time.monotonic()
        flight.record(
            "server", "drain_transition", state=lifecycle.DRAINING,
            port=self.port,
        )
        return False

    def _finish_drain(self) -> None:
        with self._lifecycle_lock:
            self.lifecycle_state = lifecycle.DRAINED
        flight.record(
            "server", "drain_transition", state=lifecycle.DRAINED,
            port=self.port,
        )
        self._drained.set()

    @sanitizer.runs_on("host", site="server.drain")
    def drain(
        self,
        successor: Optional[tuple] = None,
        *,
        grace: Optional[float] = None,
        quiesce_timeout: float = 30.0,
        handoff: bool = True,
        handoff_timeout: float = 60.0,
    ) -> dict:
        """Blocking graceful drain (host thread ONLY — the sequence
        sleeps through the record-expiry grace window and blocks on
        handoff RPCs; see lifecycle.run_drain for the steps).  Returns
        the drain summary; raises if a drain already ran/is running."""
        summary = lifecycle.run_drain(
            self, successor=successor, grace=grace,
            quiesce_timeout=quiesce_timeout, handoff=handoff,
            handoff_timeout=handoff_timeout,
        )
        self.drain_summary = summary
        return summary

    def start_drain(self, **kwargs) -> bool:
        """Fire-and-watch drain on the dedicated ``lah-drain`` daemon
        thread (the ``drain`` RPC's path — the serving loop must reply
        immediately, never block through the sequence).  Idempotent:
        False when a drain is already underway."""
        with self._lifecycle_lock:
            if (
                self.lifecycle_state != lifecycle.SERVING
                or self._drain_thread is not None
            ):
                return False

            def _run():
                try:
                    self.drain(**kwargs)
                except Exception:
                    logger.exception("background drain failed")
                    self._drained.set()  # waiters must not hang on a bug

            self._drain_thread = threading.Thread(
                target=_run, name="lah-drain", daemon=True
            )
        self._drain_thread.start()
        return True

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def start_migration(
        self, uid: str, target: Endpoint, timeout: float = 60.0
    ) -> bool:
        """Fire-and-watch single-expert move on a ``lah-migrate`` daemon
        thread (the ``migrate`` RPC's path — the serving loop replies
        immediately and keeps serving the uid through the transfer).  One
        migration in flight per server; False when one already is, when a
        drain owns the lifecycle, or when not SERVING.  Callers watch the
        stats RPC's ``placement`` section for the outcome.  Raises
        ValueError for a uid not hosted here."""
        with self._lifecycle_lock:
            if (
                self.lifecycle_state != lifecycle.SERVING
                or self._drain_thread is not None
                or self._migration_uid is not None
            ):
                return False
            if uid not in self.experts:
                raise ValueError(f"migrate: uid {uid!r} is not hosted here")
            self._migration_uid = uid

            def _run():
                try:
                    lifecycle.run_migration(
                        self, uid, target, timeout=timeout
                    )
                except Exception:
                    logger.exception("background migration failed")
                finally:
                    self._migration_uid = None

            thread = threading.Thread(
                target=_run, name="lah-migrate", daemon=True
            )
        thread.start()
        return True

    async def _declare_now(self, uid: str) -> None:
        """Immediate single-uid declare (serving loop): new/updated
        hosters become discoverable within one alive-TTL instead of one
        heartbeat period.  Failures defer to the heartbeat."""
        if self.dht is None:
            return
        try:
            await self.dht.declare_experts(
                [uid], self.endpoint, expiration=self.update_period * 2
            )
        except Exception:
            logger.exception(
                "%s: immediate declare failed (the heartbeat will retry)",
                uid,
            )

    def _retire_expert(self, uid: str) -> None:
        """Drop a handed-off expert (drain thread): requests arriving
        after this get an unknown-expert error reply, which the client's
        retry/hedge machinery absorbs like any dead peer.  Pool shutdown
        runs on the serving loop, like Server.shutdown's."""
        self.experts.pop(uid, None)
        self.replica_uids.discard(uid)
        sync = self._replica_syncs.pop(uid, None)
        if sync is not None:
            sync.stop()
        for pool_map in (self.forward_pools, self.backward_pools):
            pool = pool_map.pop(uid, None)
            if pool is not None and self._loop is not None:
                with contextlib.suppress(Exception):
                    self._loop.loop.call_soon_threadsafe(pool.shutdown)

    # ---- dynamic expert replication ----

    def _make_replica_backend(
        self, uid: str, allow_checkpoint: bool = True
    ) -> ExpertBackend:
        """Build a replica backend for ``uid`` on this server's device:
        the uid's deterministic crc32-keyed init (every process that ever
        hosts a uid, of either package, starts from identical weights),
        upgraded to the latest state in this server's OWN checkpoint root
        when one exists.  The root is local configuration, NEVER a
        peer-supplied path — the replica RPC carries only the uid.
        ``allow_checkpoint=False`` skips the restore-and-warn path: the
        handoff receiver overwrites the whole state from the wire."""
        recipe = self._replica_recipe
        if recipe is None:
            raise RuntimeError(
                "server has no replica recipe: construct it via "
                "Server.create (which records the expert zoo config), or "
                "pass an explicit backend to add_replica"
            )
        apply_fn, params = make_expert(
            recipe["expert_cls"], recipe["hidden_dim"], uid_key(uid),
            device=recipe["device"],
        )
        backend = ExpertBackend(
            uid, apply_fn, params, recipe["optimizer"],
            max_batch_size=recipe["max_batch_size"],
            n_inputs=recipe["n_inputs"], device=recipe["device"],
        )
        root = self.replica_checkpoint_root if allow_checkpoint else None
        restored = False
        if root is not None:
            from learning_at_home_tpu_torch.utils.checkpoint import (
                latest_step,
                restore_pytree,
            )

            step = latest_step(root)
            if step is not None:
                try:
                    state = restore_pytree(
                        root, step, uid.replace("/", "_"),
                        backend.state_template(),
                    )
                    backend.load_state_dict(state)
                    restored = True
                    logger.info(
                        "replica %s restored from %s @ step %d",
                        uid, root, step,
                    )
                except Exception:
                    logger.exception(
                        "replica %s: checkpoint restore failed — serving "
                        "the crc32-seeded init (replica sync will pull it "
                        "toward the group)", uid,
                    )
        if allow_checkpoint and not restored and not recipe.get("uid_seeded"):
            # the crc32 init matches hosters created with explicit
            # expert_uids; a server whose OWN experts came from the
            # num_experts/seed path hints that the swarm seeds per server,
            # so this replica's init may not match its hoster's.  Never
            # silent.
            logger.warning(
                "replica %s: no checkpoint state to restore and this "
                "server's experts are seed-path initialized (not "
                "crc32-uid-seeded) — the replica starts from the uid's "
                "crc32 init, which matches expert_uids-created hosters "
                "only; enable replica sync (sync=true) or provide a "
                "checkpoint root so replies stay numerically aligned",
                uid,
            )
        return backend

    async def _install_replica(
        self, uid: str, backend: ExpertBackend, replica: bool = True
    ) -> None:
        """Register + start pools for a new expert ON the serving loop
        (the connection handler reads ``self.experts`` there), then
        declare it immediately so clients discover the new hoster within
        one alive-TTL instead of one heartbeat period.  ``replica=False``
        installs without the replica bookkeeping (the handoff path: a
        migrated expert is a full expert, not a copy of one)."""
        warm = lambda b=backend: getattr(b, "warm_buckets", ())
        fp = TaskPool(
            backend.forward, f"{uid}.forward",
            max_batch_size=backend.max_batch_size,
            batch_timeout=self.batch_timeout, serial_key=uid,
            warm_buckets=warm,
        )
        bp = TaskPool(
            lambda tensors, b=backend: b.backward(
                tensors[: b.n_inputs], tensors[b.n_inputs :]
            ),
            f"{uid}.backward", max_batch_size=backend.max_batch_size,
            batch_timeout=self.batch_timeout, serial_key=uid,
            warm_buckets=warm,
        )
        self.experts[uid] = backend
        self.forward_pools[uid] = fp
        self.backward_pools[uid] = bp
        if replica:
            self.replica_uids.add(uid)
        fp.start(self.runtime)
        bp.start(self.runtime)
        await self._declare_now(uid)
        logger.info("hosting %s expert %s",
                    "replica of" if replica else "migrated", uid)

    async def add_replica_async(self, uid: str, sync: bool = False) -> bool:
        """Loop-side replica install (the ``replica`` RPC's path).  The
        backend build runs in a worker thread so the serving loop never
        blocks.  Returns True when installed, False when already hosted,
        when an install for the uid is in flight, or when this server is
        draining (a peer about to exit must not take on new experts)."""
        if (
            uid in self.experts
            or uid in self._replicas_installing
            or self.lifecycle_state != lifecycle.SERVING
        ):
            return False
        self._replicas_installing.add(uid)
        try:
            backend = await asyncio.to_thread(self._make_replica_backend, uid)
            await self._install_replica(uid, backend)
        finally:
            self._replicas_installing.discard(uid)
        if sync:
            # ReplicaSync construction blocks on the lah-avg loop binding
            # its peer endpoint — never on the serving loop
            await asyncio.to_thread(self.enable_replica_sync, uid)
        return True

    def add_replica(
        self,
        uid: str,
        backend: Optional[ExpertBackend] = None,
        sync: bool = False,
        sync_period: float = 10.0,
    ) -> bool:
        """Host a replica of expert ``uid`` on this server (host-thread
        form; the ``replica`` RPC reaches :meth:`add_replica_async`
        instead).  ``sync=True`` also starts periodic replica averaging
        (:class:`ReplicaSync`)."""
        if self._loop is None:
            raise RuntimeError("server not started")
        if uid in self.experts:
            return False
        if backend is None:
            backend = self._make_replica_backend(uid)
        self._loop.run(self._install_replica(uid, backend), timeout=30)
        if sync:
            self.enable_replica_sync(uid, period=sync_period)
        return True

    def enable_replica_sync(
        self,
        uid: str,
        period: float = 10.0,
        min_group_size: int = 2,
    ) -> "ReplicaSync":
        """Start periodic parameter averaging with the other hosters of
        ``uid`` (idempotent per uid; requires a DHT for matchmaking)."""
        if self.dht is None:
            raise RuntimeError("replica sync needs a DHT for matchmaking")
        existing = self._replica_syncs.get(uid)
        if existing is not None:
            return existing
        sync = ReplicaSync(
            self, uid, period=period, min_group_size=min_group_size
        )
        self._replica_syncs[uid] = sync
        return sync

    @property
    def endpoint(self) -> tuple[str, int]:
        host = self.host
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"  # localhost swarm default; WAN peers configure host
        return (host, self.port)

    def shutdown(self) -> None:
        from learning_at_home_tpu_torch.utils.metrics import registry

        registry.unregister_collector(self._collector_key)
        if self.checkpoint_manager is not None:
            with contextlib.suppress(Exception):
                self.checkpoint_manager.stop()
            self.checkpoint_manager = None
        for sync in list(self._replica_syncs.values()):
            sync.stop()
        self._replica_syncs.clear()
        if self._metrics_loop is not None:
            with contextlib.suppress(Exception):
                self._metrics_loop.loop.call_soon_threadsafe(
                    self.metrics_server.close
                )
            self._metrics_loop.shutdown()
            self._metrics_loop = None
        if self._loop is None:
            return
        for pool in (*self.forward_pools.values(), *self.backward_pools.values()):
            with contextlib.suppress(Exception):
                self._loop.loop.call_soon_threadsafe(pool.shutdown)
        if self._tcp_server is not None:
            self._loop.loop.call_soon_threadsafe(self._tcp_server.close)
        # native teardown ORDER matters (the pump's shutdown frees its C
        # state): stop the worker, drain the loop (every reply callback
        # fires on the loop thread before its join returns), join the
        # worker, and only then destroy the pump
        self._native_stop.set()
        self.runtime.shutdown()
        loop = self._loop
        self._loop = None  # signals the native worker's timeout branch
        loop.shutdown()
        for t in self._native_threads:
            t.join(timeout=5)
        wedged = [t for t in self._native_threads if t.is_alive()]
        self._native_threads.clear()
        if self._pump is not None:
            if wedged:
                # a live worker may still be inside pump.next(): freeing
                # the C state under it is a use-after-free; leak the pump
                logger.error(
                    "%d native worker(s) did not join; leaking the pump "
                    "instead of freeing C state under them", len(wedged)
                )
            else:
                with contextlib.suppress(Exception):
                    self._pump.shutdown()
            self._pump = None
        logger.info("server shut down")


class ReplicaSync:
    """Keeps the replicas of ONE expert numerically aligned by running
    periodic parameter-averaging rounds over the decentralized averaging
    machinery (``averaging/``): every server hosting ``uid`` with sync
    enabled — of either package — rendezvouses under
    ``averaging.replica.<uid>`` and writes the group mean back through
    :meth:`ExpertBackend.replace_params` (under the backend's state
    lock).  Optimizer state stays local — it is per-hoster momentum, not
    shared identity.

    Thread model: ONE daemon thread per synced expert owns the blocking
    ``step_round`` calls; nothing here ever runs on a server loop.
    Matchmaking failures (a lone replica, a peer mid-death) just skip the
    round — sync is convergence pressure, not a barrier."""

    def __init__(
        self,
        server: "Server",
        uid: str,
        period: float = 10.0,
        min_group_size: int = 2,
        max_group_size: int = 16,
    ):
        from learning_at_home_tpu_torch.averaging import (
            AveragingConfig,
            DecentralizedAverager,
        )

        self.server = server
        self.uid = uid
        self.period = period
        self.rounds = 0
        self.failures = 0
        self._stop = threading.Event()
        # a write-back excludes stop() and an exclusive() window: once
        # stop() has set the flag no round writes into the backend, and a
        # round that read the params before a window never writes
        self._write_lock = sanitizer.lock("server.replica_sync")
        self._epoch = 0  # exclusive() windows opened so far
        cfg = AveragingConfig(
            prefix=f"averaging.replica.{uid}",
            min_group_size=min_group_size,
            max_group_size=max_group_size,
            matchmaking_timeout=max(2.0, period),
            gather_timeout=min(4.0, max(1.0, period)),
        )
        self._averager = DecentralizedAverager(
            server.dht, config=cfg,
            peer_id=f"replica-{server.endpoint[0]}:{server.port}",
        )
        self._thread = threading.Thread(
            target=self._run, name=f"lah-replica-sync-{uid}", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            backend = self.server.experts.get(self.uid)
            if backend is None:
                break
            try:
                epoch = self._epoch
                params = backend.state_dict()["params"]
                averaged, _info = self._averager.step_round(
                    params, matchmaking_timeout=self.period
                )
                with self._write_lock:
                    if self._stop.is_set():
                        break
                    if averaged is not None and epoch == self._epoch:
                        backend.replace_params(averaged)
                        self.rounds += 1
            except Exception as e:
                # lone replica / peer churn: skip this round, keep trying
                self.failures += 1
                logger.debug("replica sync round for %s skipped: %s: %s",
                             self.uid, type(e).__name__, e)
            self._stop.wait(self.period)

    def stats(self) -> dict:
        """Rounds, skipped rounds, the rounds' p50 time and the crc32 of
        each parameter leaf of this hoster's copy (manifest order), so two
        hosters' copies are compared bit for bit from outside."""
        backend = self.server.experts.get(self.uid)
        crcs = []
        if backend is not None:
            _, manifest = lifecycle.flatten_state(
                {"params": backend.state_dict()["params"], "opt_state": ()})
            crcs = [m["crc"] for m in manifest]
        return {"uid": self.uid, "rounds": self.rounds,
                "failures": self.failures,
                "round_p50_ms": self._averager.stats()["round_p50_ms"],
                "params_crc": crcs}

    @contextlib.contextmanager
    def exclusive(self):
        """Hold write-backs off while the caller replaces the backend's
        state (a handoff's install, verify and rollback).  A round that
        read the params before the window is dropped instead of writing
        its mean over what the window left; later rounds go on."""
        with self._write_lock:
            self._epoch += 1
            yield

    def stop(self) -> None:
        with self._write_lock:  # no round in flight writes after this
            self._stop.set()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            logger.warning("replica sync thread for %s did not join "
                           "(mid-round); averager shutdown will cancel it",
                           self.uid)
        self._averager.shutdown()


@contextlib.contextmanager
def background_server(
    num_experts: int = 2,
    expert_cls: str = "ffn",
    hidden_dim: int = 64,
    expert_prefix: str = "expert",
    optimizer: Optional[GradientTransformation] = None,
    max_batch_size: int = 256,
    dht: Any = None,
    seed: int = 0,
    device=None,
    **server_kwargs,
):
    """Spin up a localhost Server with generated experts (test/benchmark
    rig): yields ``(endpoint, server)``; tears down on exit.  Expert UIDs
    are ``{prefix}.{i}`` unless ``expert_uids`` is given; the optimizer
    defaults to ``sgd(0.05)`` as the JAX package's does.  With a ``dht``
    the server heartbeats its experts into it."""
    server = Server.create(
        num_experts=num_experts,
        expert_cls=expert_cls,
        hidden_dim=hidden_dim,
        expert_prefix=expert_prefix,
        optimizer=optimizer if optimizer is not None else sgd(0.05),
        max_batch_size=max_batch_size,
        seed=seed,
        host="127.0.0.1",
        dht=dht,
        device=device,
        **server_kwargs,
    )
    try:
        yield server.endpoint, server
    finally:
        server.shutdown()
