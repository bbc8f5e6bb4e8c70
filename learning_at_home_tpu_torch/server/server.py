"""Server: the top-level expert-hosting peer.

The port of ``learning_at_home_tpu/server/server.py``: N ExpertBackends
on one device behind the framed tensor RPC protocol (the JAX package's
wire, byte for byte), a metrics endpoint, checkpoints.  Three execution
domains in one process:

- **event loop** (BackgroundLoop thread ``lah-server``): TCP accept, RPC
  parse, task pools — all non-blocking;
- **Runtime thread** (``lah-runtime``): the single device consumer
  launching expert kernels (torch releases the GIL inside them);
- **main thread**: owns lifecycle (start/shutdown), free for user code.

Not in the port yet (the DHT's slice): the DHT heartbeat, the native
frame pump, graceful drain and live migration (``server/lifecycle.py``)
and replicas (``add_replica``, ``ReplicaSync``); their RPC ops answer
with an error frame (``connection_handler.LATER_OPS``).
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
from learning_at_home_tpu_torch.server.connection_handler import ConnectionHandler
from learning_at_home_tpu_torch.server.expert_backend import ExpertBackend
from learning_at_home_tpu_torch.server.runtime import Runtime
from learning_at_home_tpu_torch.server.task_pool import TaskPool
from learning_at_home_tpu_torch.utils.asyncio_utils import BackgroundLoop

logger = logging.getLogger(__name__)

SERVING = "SERVING"  # the only lifecycle state until drain is ported


class Server:
    """Hosts a set of ExpertBackends behind the framed tensor RPC protocol."""

    def __init__(
        self,
        experts: dict[str, ExpertBackend],
        host: str = "0.0.0.0",
        port: int = 0,
        update_period: float = 15.0,
        batch_timeout: float = 0.002,
        chaos: Any = None,
    ):
        self.experts = dict(experts)
        self.host, self._requested_port = host, port
        self.chaos = chaos.make() if hasattr(chaos, "make") else chaos
        self.update_period = update_period
        self.batch_timeout = batch_timeout
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
        # (Prometheus + JSON + chrome trace) on its own loop
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
        self.replica_uids: set[str] = set()
        self.lifecycle_state: str = SERVING
        self.started_at = time.monotonic()
        self.restarts = 0
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
            "lah_server_hot_experts": sum(
                1 for v in self._snap_queue_ema().values()
                if v >= self.hot_depth_threshold
            ),
            "lah_server_uptime_seconds": time.monotonic() - self.started_at,
        }

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

        Expert UIDs are ``{prefix}.{offset+i}``, each initialised from a
        ``torch.Generator`` seeded ``seed + i``; or pass ``expert_uids``
        (an explicit iterable) to host arbitrary uids, each seeded by the
        crc32 of its uid, so every torch process that hosts a uid
        initialises identical weights.  (The draws are torch's, not
        flax's: only the distributions match the JAX package's.)
        Experts, their optimizer state and compute live on ``device``
        (None: the CUDA card; raises where there is none).  ``warmup``
        records the batch buckets and the output schema before returning:
        ``True`` = all power-of-two buckets, or a list of bucket sizes."""
        dev = resolve_device(device)
        optimizer = optimizer if optimizer is not None else adam(1e-3)
        if expert_uids is not None:
            uid_seeds = [
                (uid, zlib.crc32(uid.encode()) & 0x7FFFFFFF)
                for uid in expert_uids
            ]
        else:
            uid_seeds = [
                (f"{expert_prefix}.{i}", seed + i)
                for i in range(expert_offset, expert_offset + num_experts)
            ]
        experts = {}
        n_wire_inputs = len(sample_inputs(expert_cls, hidden_dim))
        for uid, uid_seed in uid_seeds:
            gen = torch.Generator(dev).manual_seed(uid_seed)
            apply_fn, params = make_expert(expert_cls, hidden_dim, gen,
                                           device=dev)
            experts[uid] = ExpertBackend(
                uid, apply_fn, params, optimizer,
                max_batch_size=max_batch_size, n_inputs=n_wire_inputs,
                device=dev,
            )
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
        self._tcp_server = await asyncio.start_server(
            handler.handle_connection, self.host, self._requested_port
        )
        self.port = self._tcp_server.sockets[0].getsockname()[1]
        for pool in (*self.forward_pools.values(), *self.backward_pools.values()):
            pool.start(self.runtime)
        self._load_monitor = asyncio.get_running_loop().create_task(
            self._monitor_load_forever(), name="load-monitor"
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
        }

    def placement_info(self) -> dict:
        """The stats RPC's placement section: no outbound moves (migration
        is not ported)."""
        return {"migrations_out": 0, "migration_failures": 0,
                "migration_in_flight": None}

    def lifecycle_info(self) -> dict:
        """The stats RPC's lifecycle section: always SERVING (drain is not
        ported), uptime and restarts."""
        return {
            "state": self.lifecycle_state,
            "uptime_s": round(time.monotonic() - self.started_at, 1),
            "restarts": self.restarts,
            "migrated_in": [],
        }

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

    @property
    def endpoint(self) -> tuple[str, int]:
        host = self.host
        if host in ("0.0.0.0", "::"):
            host = "127.0.0.1"  # localhost swarm default; WAN peers configure host
        return (host, self.port)

    def shutdown(self) -> None:
        from learning_at_home_tpu_torch.utils.metrics import registry

        registry.unregister_collector(self._collector_key)
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
        self.runtime.shutdown()
        loop = self._loop
        self._loop = None
        loop.shutdown()
        logger.info("server shut down")


@contextlib.contextmanager
def background_server(
    num_experts: int = 2,
    expert_cls: str = "ffn",
    hidden_dim: int = 64,
    expert_prefix: str = "expert",
    optimizer: Optional[GradientTransformation] = None,
    max_batch_size: int = 256,
    seed: int = 0,
    device=None,
    **server_kwargs,
):
    """Spin up a localhost Server with generated experts (test/benchmark
    rig): yields ``(endpoint, server)``; tears down on exit.  Expert UIDs
    are ``{prefix}.{i}`` unless ``expert_uids`` is given; the optimizer
    defaults to ``sgd(0.05)`` as the JAX package's does."""
    server = Server.create(
        num_experts=num_experts,
        expert_cls=expert_cls,
        hidden_dim=hidden_dim,
        expert_prefix=expert_prefix,
        optimizer=optimizer if optimizer is not None else sgd(0.05),
        max_batch_size=max_batch_size,
        seed=seed,
        host="127.0.0.1",
        device=device,
        **server_kwargs,
    )
    try:
        yield server.endpoint, server
    finally:
        server.shutdown()
