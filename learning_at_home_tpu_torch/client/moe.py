"""RemoteMixtureOfExperts: the headline DMoE layer.

The port of ``learning_at_home_tpu/client/moe.py``: the host-side
dispatch (alive sets, top-k selection, pack-once payloads, the k-of-n
quorum fan-out, hedging, sessions, dispatch stats) is the JAX package's
numpy and asyncio code, copied; the gate and the mixture are torch, and
``jax.custom_vjp`` over ``io_callback`` becomes ``torch.autograd.Function``
(:class:`_Dispatch` for ``__call__``, :class:`_FireOp`/:class:`_JoinOp`
for the overlapped fire/join pair).  Tensors cross to the host as numpy
and come back on the input's device.

Contract from the reference's ``hivemind/client/moe.py`` (SURVEY.md §2 [BJ];
unverifiable refs, mount empty): linear gating over a multi-dimensional
expert grid (UIDs like ``ffn.4.17``); per-sample top-k expert choice among
*alive* experts; parallel dispatch; wait for ≥ ``k_min`` replies per sample
then a grace timeout; drop stragglers/failures; return the gate-weighted
mixture.  Backward mirrors this with ``backward_k_min`` — and triggers the
server-side async optimizer step on every expert that participates.

TPU-native structure (who computes what):

- in-graph (autograd, differentiable): gate logits ``x @ W_d`` per grid dim,
  score gathering at the chosen coordinates, masked softmax, weighted
  mixture.  Gradients to the gate weights flow through this path.
- host (the autograd functions' forward and backward): alive-set lookup,
  per-sample top-k selection, per-expert row dispatch over the framed RPC
  protocol with the k-of-n quorum, and the mirrored backward fan-out.
  Gradients to ``x`` flow through the backward RPCs; the discrete expert
  *choice* contributes zero gradient (straight-through on membership, exact
  on weights — same semantics as the reference).

The forward host call stashes a session (which experts answered, with which
rows) so backward targets exactly the responding experts — the
``_RemoteCallMany`` contract.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import threading
from collections import OrderedDict, deque
from typing import Optional, Sequence

import numpy as np
import torch

from learning_at_home_tpu_torch.client.routing import (
    CachedAliveSet,
    ExpertSource,
    ReplicaSet,
    RoutingCostModel,
    as_replica_set,
    beam_search_alive,
    filter_valid_uids,
    select_top_k,
)
from learning_at_home_tpu_torch.client.rpc import (
    DispatchFuture,
    client_loop,
    dispatch_mode,
    pool_registry,
)
from learning_at_home_tpu_torch.convert import numpy_to_tensor, tensor_to_numpy
from learning_at_home_tpu_torch.utils import flight, sanitizer
from learning_at_home_tpu_torch.utils.connection import (
    QUORUM_STRAGGLER_CANCEL,
    RemoteCallError,
)
from learning_at_home_tpu_torch.utils.profiling import new_trace_id, timeline

logger = logging.getLogger(__name__)

# co-activation table bound (ISSUE 16): distinct pairs tracked per MoE —
# a k-of-grid gate selects O(k²) pairs per dispatch, so real workloads
# sit far below this; the cap only bites on pathological gates
COACT_MAX_PAIRS = 4096


class MoEDispatchError(RuntimeError):
    """Total dispatch failure: no expert replied for ANY sample (or no
    experts are alive at all).  Per-sample quorum misses do NOT raise —
    those samples are masked to zero contribution and counted in
    ``samples_dropped`` (the swarm is staleness- and loss-tolerant by
    design; one dead server must degrade the batch, not kill the step)."""


class RemoteMixtureOfExperts:
    """Fault-tolerant mixture over a grid of network-remote experts.

    Usage::

        moe = RemoteMixtureOfExperts(in_features=1024, grid_size=(32, 32),
                                     uid_prefix="ffn", source=dht_or_static)
        gate = moe.init_gate_params(torch.Generator().manual_seed(0))
        y = moe(x, gate)                      # differentiable
        loss(y).backward()                    # backward RPCs happen inside

    Gate parameters live client-side (trained by the caller's optimizer);
    expert parameters live server-side (updated asynchronously by each
    backward RPC).
    """

    _call_counter = itertools.count()

    def __init__(
        self,
        *,
        in_features: int,
        grid_size: Sequence[int],
        uid_prefix: str,
        source: ExpertSource,
        k_best: int = 4,
        k_min: int = 1,
        backward_k_min: int = 1,
        timeout_after_k_min: float = 1.0,
        forward_timeout: float = 30.0,
        backward_timeout: float = 30.0,
        alive_ttl: float = 3.0,
        max_sessions: int = 1024,
        compute_dtype=torch.float32,
        routing: str = "enumerate",
        beam_size: int = 8,
        merge_rpcs: bool = True,
        wire_dtype: Optional[str] = None,
        wire_codec: Optional[str] = None,
        latency_weight: float = 0.0,
        routing_cost_weight: Optional[float] = None,
        telemetry_prefix: str = "swarm",
        hedge_mult: Optional[float] = None,
        hedge_floor_s: Optional[float] = None,
        alive_swr: Optional[bool] = None,
    ):
        if routing not in ("enumerate", "beam"):
            raise ValueError(f"routing must be 'enumerate' or 'beam', got {routing!r}")
        from learning_at_home_tpu_torch.utils.serialization import (
            validate_wire_codec,
            validate_wire_dtype,
        )

        validate_wire_dtype(wire_dtype)
        self.in_features = in_features
        self.grid_size = tuple(grid_size)
        self.n_dims = len(self.grid_size)
        self.uid_prefix = uid_prefix
        self.k_best, self.k_min = k_best, k_min
        self.backward_k_min = backward_k_min
        self.timeout_after_k_min = timeout_after_k_min
        self.forward_timeout = forward_timeout
        self.backward_timeout = backward_timeout
        self.compute_dtype = compute_dtype
        self.routing = routing
        self.beam_size = beam_size
        # one 'multi' request per peer (overhead per PEER not per expert);
        # False restores the reference's strictly per-expert fan-out
        self.merge_rpcs = merge_rpcs
        # transport encoding for activation/grad payloads ("bfloat16" or
        # "float16"): floating tensors are downcast on the wire BOTH ways
        # (the server upcasts to f32 for compute and downcasts its reply —
        # see server/connection_handler.py).  Halves the payload of the
        # large-row swarm dispatches that dominate dispatch p50; math
        # still runs f32 on both ends.  None = uncompressed f32.
        self.wire_dtype = wire_dtype
        # wire CODEC (ISSUE 5): None = adaptive per-pool selection — the
        # escalation policy in serialization.select_wire_codec picks
        # none→bf16→8-bit from each pool's RTT EMA and measured bytes/sec
        # (unmeasured/fast pools stay on the wire_dtype base, so the
        # default wire is byte-identical to pre-codec builds).  An
        # explicit codec ("none"/"bf16"/"f16"/"u8"/"blockq8") pins every
        # pool; the LAH_WIRE_CODEC environment variable overrides both.
        # Quantized codecs are only ever OFFERED to pools whose hello
        # negotiation echoed the "codec" feature (v1 peers and old builds
        # transparently fall back to the wire_dtype base), and only in
        # pipelined dispatch mode (the legacy A/B arm keeps the exact
        # pre-PR-2 wire).
        env_codec = os.environ.get("LAH_WIRE_CODEC") or None
        validate_wire_codec(env_codec)
        validate_wire_codec(wire_codec)
        self.wire_codec = env_codec or wire_codec
        if self.wire_codec in ("bf16", "f16") and wire_dtype is not None:
            from learning_at_home_tpu_torch.utils.serialization import (
                _DTYPE_TO_CODEC,
            )

            if _DTYPE_TO_CODEC.get(wire_dtype) != self.wire_codec:
                raise ValueError(
                    f"wire_codec={self.wire_codec!r} conflicts with "
                    f"wire_dtype={wire_dtype!r}: a downcast codec pin must "
                    "match the configured wire dtype (or drop one of them)"
                )
        # per-codec payload counts (plain int adds on the host thread;
        # scrape readers copy-with-retry like the deques)
        self.codec_counts: dict[str, int] = {}
        # latency-aware SELECTION (ISSUE 8; cf. TA-MoE / MoETuner): the
        # RoutingCostModel debits each expert's selection score by
        # ``weight × predicted completion time`` — pool RTT EMA + the
        # peer's DHT-advertised queue depth + estimated transfer time at
        # the negotiated codec, minimized over the uid's replica set.
        # Combine weights stay clean-gate (selection-only, like router
        # jitter).  Weight resolution: LAH_ROUTING_COST_WEIGHT env >
        # ``routing_cost_weight`` ctor > the historical ``latency_weight``
        # alias (whose rtt-only behavior the model reproduces bitwise
        # when no load feed or bandwidth measurement exists).  0 = off:
        # bias is None and selection is bitwise today's blind gate.
        env_w = os.environ.get("LAH_ROUTING_COST_WEIGHT")
        if env_w not in (None, ""):
            cost_weight = float(env_w)
        elif routing_cost_weight is not None:
            cost_weight = float(routing_cost_weight)
        else:
            cost_weight = float(latency_weight)
        self.latency_weight = cost_weight  # historical alias, kept readable
        self.telemetry_prefix = telemetry_prefix
        load_getter = (
            self._make_load_getter(source, telemetry_prefix)
            if hasattr(source, "get") and hasattr(source, "declare_experts")
            else None
        )
        from learning_at_home_tpu_torch.utils.serialization import CODEC_WIRE_RATIO

        # placement/routing co-optimization (ISSUE 16): the swarm's
        # published ``links.<prefix>`` RTT/bw EMAs feed the cost model
        # as a prior for endpoints this process never dialed — the same
        # link data the placement solver scores assignments on
        link_getter = (
            self._make_link_getter(source, telemetry_prefix)
            if load_getter is not None
            else None
        )
        self.cost_model = RoutingCostModel(
            cost_weight,
            load_getter=load_getter,
            load_ttl=alive_ttl,
            codec_ratio=CODEC_WIRE_RATIO.get(self.wire_codec or "", 1.0),
            link_getter=link_getter,
        )
        # hedged replica dispatch (ISSUE 8): once a forward fan-out call
        # to a replicated expert outlives ``hedge_mult × the primary
        # pool's RTT EMA`` (floored at hedge_floor_s), the SAME prepared
        # payload is fired at the backup replica and the first successful
        # reply wins — a dying primary costs one hedge window, not a
        # quorum timeout.  mult ≤ 0 disables hedging entirely; backward
        # fan-outs never hedge (the optimizer step is a side effect — a
        # duplicate would apply the same gradients twice).
        if hedge_mult is None:
            try:
                hedge_mult = float(os.environ.get("LAH_HEDGE_MULT", "3"))
            except ValueError:
                hedge_mult = 3.0
        if hedge_floor_s is None:
            try:
                hedge_floor_s = float(
                    os.environ.get("LAH_HEDGE_MIN_S", "0.05")
                )
            except ValueError:
                hedge_floor_s = 0.05
        self.hedge_mult = hedge_mult
        self.hedge_floor_s = hedge_floor_s
        # hedge counters are owned by the lah-client LOOP thread (armed
        # and resolved inside the fan-out coroutine); scrape readers take
        # plain int snapshots — no lock on either side
        self.hedge_fires = 0
        self.hedge_wins = 0
        self.hedges_skipped = 0
        # sole-endpoint rescue (ISSUE 11): non-replicated uids whose only
        # endpoint hard-failed mid-record-TTL, re-resolved via a
        # cache-bypassing alive lookup (same loop-thread ownership)
        self.fresh_retries = 0
        self.fresh_retry_wins = 0
        # replica observability: uid → replica count from the latest
        # alive-set resolution (host-thread writes, copy-on-read scrapes)
        self._replica_counts: dict[str, int] = {}
        self.source = source
        # alive_swr: serve a stale alive set while a background task
        # refreshes it (CachedAliveSet; None → LAH_ALIVE_SWR env) — under
        # churn the discovery lookup can stall behind dead DHT peers and
        # must not block the dispatch path (ISSUE 9)
        self.alive_cache = CachedAliveSet(
            source, uid_prefix, ttl=alive_ttl, swr=alive_swr
        )
        self._sessions: OrderedDict[int, dict] = OrderedDict()
        self._sessions_lock = sanitizer.lock("moe.sessions")
        self.max_sessions = max_sessions
        self._grid_offsets = np.concatenate(
            [[0], np.cumsum(self.grid_size)[:-1]]
        ).astype(np.int32)
        # future-based dispatch (ISSUE 7): tickets for fired-but-unjoined
        # fan-outs, keyed by the handle the fire op returned.  Bounded
        # like _sessions — an evicted ticket cancels its fan-out.
        self._pending: OrderedDict[int, DispatchFuture] = OrderedDict()
        self._pending_bwd: OrderedDict[int, DispatchFuture] = OrderedDict()
        # overlap telemetry: time-weighted accumulators behind
        # lah_client_overlap_fraction (0 in the serial regime)
        self.inflight_seconds = 0.0
        self.join_blocked_seconds = 0.0
        self.inflight_dispatches = 0  # gauge: fired, not yet joined
        # dispatch latency telemetry (north-star: dispatch p50); bounded so
        # long runs don't grow memory
        self.dispatch_times: deque[float] = deque(maxlen=10_000)
        self.dispatches = 0  # cumulative (deques above are windows)
        # per-dispatch selected-uid sets (bounded like dispatch_times)
        self.selection_log: deque[frozenset] = deque(maxlen=10_000)
        # co-activation graph (ISSUE 16): bounded undirected pair counts
        # accumulated at the gate — which experts this trainer fires
        # TOGETHER.  Host-thread-owned plain dict (k_best is small, so a
        # dispatch adds at most k·(k-1)/2 increments); scrape readers
        # copy-with-retry like the deques.  The cap keeps a pathological
        # gate from growing the table unboundedly: increments to new
        # pairs past it are counted as dropped, existing pairs keep
        # counting.
        self.coact_counts: dict[str, int] = {}
        self.coact_dispatches = 0
        self.coact_pairs_dropped = 0
        # per-sample quorum telemetry: samples whose reply count fell below
        # k_min (forward) / backward_k_min (backward) and were masked out
        self.samples_total = 0
        self.samples_dropped = 0
        self.backward_samples_dropped = 0
        # backward-RPC ledger (guarded by _sessions_lock: pipelined
        # trainers run _host_backward concurrently).  ``sent`` counts
        # dispatched grad batches, ``ok`` the replies that came back.
        # The invariant servers' summed ``update_count`` obeys is
        # updates ≤ sent — NOT ≤ ok: a post-quorum straggler cancelled
        # client-side still executes (and updates) server-side, and a
        # task pool may merge concurrent trainers' tasks into one padded
        # batch = one optimizer step.
        self.backward_rpcs_sent = 0
        self.backward_rpcs_ok = 0
        # client hot-path pipeline telemetry (PR 2): host-side serialize
        # time vs loop round-trip wait per dispatch, bytes handed to the
        # wire, and the duplicated wire-encoding the pack-once fan-out
        # avoided (per-call packing downcasts each sample's rows once PER
        # selected expert; pack-once downcasts the batch once)
        self.pack_times: deque[float] = deque(maxlen=10_000)
        self.wait_times: deque[float] = deque(maxlen=10_000)
        self.pack_bytes = 0
        self.pack_bytes_saved = 0
        # always-on headline metrics (ISSUE 4): expose this layer's
        # counters through the process registry via a scrape-time
        # collector — zero hot-path cost, pruned automatically once the
        # MoE is garbage-collected (the weakref returns None)
        import weakref

        from learning_at_home_tpu_torch.utils.metrics import registry as _registry

        ref = weakref.ref(self)

        def _collect():
            moe = ref()
            return None if moe is None else moe._headline_metrics()

        _registry.register_collector(f"moe-{id(self)}", _collect)
        # quiesce-point audit (sanitizer-gated, weakly held): when the
        # client claims idle (reset_client_rpc), every fired dispatch
        # must have been joined or cancelled — a non-zero gauge there is
        # a leaked fan-out holding server-side sessions
        sanitizer.register_quiesce_audit(
            f"client.moe.{id(self):x}", self._quiesce_audit
        )

    def _quiesce_audit(self) -> list:
        leaks = []
        if self.inflight_dispatches:
            leaks.append(
                f"inflight_dispatches gauge is {self.inflight_dispatches} "
                "at client quiesce — fired fan-out never joined/cancelled"
            )
        with self._sessions_lock:
            pending = len(self._pending) + len(self._pending_bwd)
        if pending:
            leaks.append(
                f"{pending} unjoined dispatch ticket(s) at client quiesce"
            )
        return leaks

    @staticmethod
    def _make_load_getter(source, prefix: str):
        """TTL-refreshed ``host:port`` → load-record map from the DHT's
        ``load.<prefix>`` heartbeats (utils/telemetry.py).  Called by the
        cost model on the dispatching HOST thread at most once per TTL
        window — one bounded control-plane loop round-trip, mirroring the
        alive-set cache's refresh discipline."""

        def _get() -> dict:
            from learning_at_home_tpu_torch.utils.telemetry import (
                load_key,
                parse_load_value,
            )

            records = client_loop().run(source.get(load_key(prefix)))
            out = {}
            for subkey, entry in records.items():
                value = entry[0] if isinstance(entry, (tuple, list)) else entry
                parsed = parse_load_value(value)
                if isinstance(subkey, str) and parsed is not None:
                    out[subkey] = parsed
            return out

        return _get

    @staticmethod
    def _make_link_getter(source, prefix: str):
        """TTL-refreshed ``host:port`` → ``{"rtt_s", "bw_bps"}`` map from
        the swarm's ``links.<prefix>`` heartbeats: every publishing
        peer's view of each destination, aggregated per destination by
        MEDIAN rtt (robust to one peer's bad path) and median measured
        bandwidth.  Same refresh discipline as the load getter."""

        def _get() -> dict:
            from learning_at_home_tpu_torch.utils.telemetry import (
                links_key,
                parse_links_value,
            )

            records = client_loop().run(source.get(links_key(prefix)))
            rtts: dict[str, list] = {}
            bws: dict[str, list] = {}
            for _subkey, entry in records.items():
                value = entry[0] if isinstance(entry, (tuple, list)) else entry
                parsed = parse_links_value(value)
                if parsed is None:
                    continue
                for dst, ent in parsed.items():
                    rtts.setdefault(dst, []).append(ent["rtt_s"])
                    if ent["bw_bps"] is not None:
                        bws.setdefault(dst, []).append(ent["bw_bps"])
            out = {}
            for dst, vals in rtts.items():
                out[dst] = {
                    "rtt_s": float(np.median(vals)),
                    "bw_bps": (
                        float(np.median(bws[dst])) if dst in bws else None
                    ),
                }
            return out

        return _get

    # ---- gate parameters ----

    def init_gate_params(self, generator: torch.Generator) -> dict:
        """One ``[in_features, grid_d]`` normal(0, 1/in_features) matrix
        per grid dimension, drawn from ``generator`` on its device (the
        JAX package's distribution; its values differ)."""
        scale = 1.0 / np.sqrt(self.in_features)
        return {
            f"w{d}": torch.randn(
                (self.in_features, g), generator=generator,
                device=generator.device, dtype=self.compute_dtype,
            ) * scale
            for d, g in enumerate(self.grid_size)
        }

    # ---- the public call: gating in torch, dispatch on the host ----

    def gate_logits(self, gate_params: dict, x):
        """Concatenated per-dimension gate logits [B, sum(grid)] — THE
        gating math, shared by :meth:`__call__` and the fire half so
        expert selection cannot drift between the two paths."""
        logits = [x @ gate_params[f"w{d}"] for d in range(self.n_dims)]
        return torch.cat(logits, dim=-1)

    def _wants_session(self, x, logits_concat) -> bool:
        """A backward will come (grad mode on and an input that requires
        grad): the forward stores a session.  The no-grad path stores
        none — orphans would evict live training sessions."""
        return torch.is_grad_enabled() and (
            x.requires_grad or logits_concat.requires_grad)

    def __call__(self, x, gate_params: dict):
        logits_concat = self.gate_logits(gate_params, x)  # [B, sum(grid)]
        y, idx, mask = _Dispatch.apply(
            self, self._wants_session(x, logits_concat), x.to("cpu"),
            logits_concat.to("cpu"))
        return self._combine(*_on(x.device, y, idx, mask), logits_concat)

    def _combine(self, y, idx, mask, logits_concat):
        """Gate-weighted mixture of the dispatch replies — the
        differentiable second half shared by :meth:`__call__` and the
        fire/join path (identical ops, so the two paths stay bitwise
        comparable)."""
        # gather each chosen expert's score from the (differentiable) logits
        scores = torch.zeros(mask.shape, dtype=logits_concat.dtype,
                             device=logits_concat.device)
        for d in range(self.n_dims):
            flat_idx = idx[:, :, d] + int(self._grid_offsets[d])
            scores = scores + torch.gather(logits_concat, 1, flat_idx)
        # finite mask value (not -inf, and dtype-aware so fp16 doesn't
        # overflow it to -inf): a fully-masked row — a sample whose quorum
        # failed and was dropped — must yield zero weights, not NaN
        big_neg = torch.tensor(torch.finfo(scores.dtype).min / 2,
                               dtype=scores.dtype, device=scores.device)
        scores = torch.where(mask, scores, big_neg)
        weights = torch.softmax(scores, dim=-1)
        weights = torch.where(mask, weights, torch.zeros_like(weights))
        return torch.einsum("bk,bkd->bd", weights.to(y.dtype), y)

    def preview_expert_sets(self, logits_concat) -> list:
        """Per-row frozensets of the expert uids a dispatch of these gate
        logits WOULD select — the gateway's coalescing key (gateway/
        coalesce.py groups streams whose sets overlap so one pack-once
        dispatch serves many of them).

        Grid routing only (``routing="beam"`` resolves its alive set per
        fire and has no cacheable preview).  The preview selects with
        ``bias=None``: exact at routing cost weight 0 (bias is None on the
        real dispatch too) and a grouping heuristic otherwise — grouping
        never affects correctness because each group's dispatch reruns its
        own biased selection over its own rows."""
        if self.routing == "beam":
            raise MoEDispatchError(
                "preview_expert_sets requires grid routing (beam resolves "
                "its alive set per dispatch)"
            )
        if isinstance(logits_concat, torch.Tensor):
            logits_concat = tensor_to_numpy(logits_concat)
        logits_concat = np.asarray(logits_concat)
        logits = [
            logits_concat[:, off : off + g]
            for off, g in zip(self._grid_offsets, self.grid_size)
        ]
        alive = self.alive_cache.peek_fresh()
        if alive is None:
            alive = client_loop().run(self.alive_cache.get())
        alive_uids = sorted(
            filter_valid_uids(alive, self.uid_prefix, self.grid_size)
        )
        if not alive_uids:
            raise MoEDispatchError(
                f"no alive experts under prefix {self.uid_prefix!r}"
            )
        sel, _ = select_top_k(logits, alive_uids, self.k_best, bias=None)
        return [frozenset(alive_uids[e] for e in row) for row in sel]

    # ---- fire/join: the overlapped two-phase form of __call__ ----

    def fire(self, x, gate_params: dict):
        """Phase one of an overlapped dispatch: gating, then the fire op —
        selection + payload serialization on the host thread and a
        NON-BLOCKING fan-out submit to the client loop.  Returns
        ``(token, handle, logits_concat)`` for :meth:`join`; everything
        the caller computes between fire and join overlaps the in-flight
        expert RPCs."""
        logits_concat = self.gate_logits(gate_params, x)
        token, handle = _FireOp.apply(
            self, self._wants_session(x, logits_concat), x.to("cpu"),
            logits_concat.to("cpu"))
        return token, handle, logits_concat

    def join(self, token, handle, logits_concat):
        """Phase two: block until the fired fan-out resolves (the single
        join point), then mix replies with gate weights — the same math
        as :meth:`__call__`.  ``fire(...)`` immediately followed by
        ``join(...)`` is the serial schedule and produces bitwise the
        same values as deferring the join."""
        y, idx, mask = _JoinOp.apply(self, token, handle)
        return self._combine(*_on(logits_concat.device, y, idx, mask),
                             logits_concat)

    # ---- host side: forward fan-out with k-of-n quorum ----

    def _host_forward(self, x, logits_concat, store_session: bool = True):
        # distributed tracing: one compact trace id per dispatch, minted
        # ONLY while profiling is enabled (the disabled path carries no
        # extra meta and records nothing).  It rides in every RPC's meta,
        # is stamped onto the client pack/rpc spans here and the server's
        # stack/dispatch/materialize spans there, and the session carries
        # it into backward — one forward+backward, one joinable trace.
        trace = new_trace_id() if timeline.enabled else None
        with timeline.span(f"moe.dispatch.{self.uid_prefix}", trace=trace):
            return self._host_forward_impl(
                x, logits_concat, store_session, trace
            )

    def _host_forward_impl(
        self, x, logits_concat, store_session: bool = True, trace=None
    ):
        # serial schedule = fire immediately followed by join; the
        # overlapped swarm step calls the same two halves with trunk
        # compute in between, so the paths cannot drift apart
        return self.dispatch_async(
            x, logits_concat, store_session=store_session, trace=trace
        ).join()

    def _join_timeout(self, kind: str):
        """Hard join deadline for the future-based path (None = the
        legacy arm's unbounded watchdog-guarded wait).  Every RPC inside
        the fan-out is already bounded by rpc_timeout and the quorum
        grace, so a fan-out that outlives their sum plus the grace slack
        is stalled, not slow."""
        from learning_at_home_tpu_torch.client.rpc import JOIN_GRACE_S

        if dispatch_mode() == "legacy":
            return None
        base = self.forward_timeout if kind == "forward" else self.backward_timeout
        return base + self.timeout_after_k_min + JOIN_GRACE_S

    @sanitizer.runs_on("host", site="moe.join_exit")
    def _make_join_exit(self, trace):
        """on_join_exit hook: overlap accounting + the in-flight gauge,
        run in join's finally on the joining host thread — it fires even
        when the join times out or the fan-out raised."""

        def _exit(fut: DispatchFuture) -> None:
            import time as _time

            if fut.cancelled:
                # ticket eviction: nothing was joined — drain the gauge
                # but record no overlap evidence (a never-joined window
                # is not hidden latency)
                with self._sessions_lock:
                    self.inflight_dispatches -= 1
                return
            blocked = fut.blocked_s
            inflight = fut.inflight_s()
            self.wait_times.append(blocked)
            timeline.record(
                "client.dispatch.join",
                _time.monotonic() - blocked, blocked, trace=trace,
            )
            with self._sessions_lock:
                self.inflight_dispatches -= 1
                self.inflight_seconds += inflight
                self.join_blocked_seconds += min(blocked, inflight)

        return _exit

    @sanitizer.runs_on("host", site="moe.dispatch_async")
    def dispatch_async(
        self, x, logits_concat, *, store_session: bool = True, trace=None,
        session_id: Optional[int] = None,
    ) -> DispatchFuture:
        """FIRE half of a forward dispatch: alive-set lookup, per-sample
        top-k selection, payload serialization (pipelined mode: pack-once
        on this host thread) and a non-blocking submit of the quorum
        fan-out to the client loop.  Returns a joinable
        :class:`DispatchFuture` immediately — this path never waits for
        expert replies.  Loop touches are control-plane only: grid
        routing pays the once-per-TTL-window alive-set refresh;
        ``routing="beam"`` pays a bounded DHT beam-search round-trip on
        EVERY fire (prefix records are per-logit-row, not cacheable as
        one set) — on real WAN RTTs that lookup shrinks the overlap win
        by its latency, so latency-critical overlapped deployments
        should prefer grid routing or a DHT cache (ROADMAP item 4).

        ``session_id`` pins the backward-session key (the autograd
        fire/join pair uses the fire handle, so fire's residuals can
        find the backward the join fired)."""
        import time as _time

        t0 = _time.monotonic()
        x = np.asarray(x)
        logits_concat = np.asarray(logits_concat)
        batch = x.shape[0]
        with timeline.span("client.dispatch.fire", trace=trace):
            logits = [
                logits_concat[:, off : off + g]
                for off, g in zip(self._grid_offsets, self.grid_size)
            ]
            if self.routing == "beam":
                # prefix beam search: fetch only the records for each
                # sample's best first-dimension rows — scales to
                # 4096-expert grids without ever reading the full
                # top-level record.  Control-plane: bounded DHT reads,
                # not expert-reply waits.
                alive = client_loop().run(
                    beam_search_alive(
                        self.source,
                        self.uid_prefix,
                        logits,
                        self.grid_size,
                        self.beam_size,
                    )
                )
                alive_uids = sorted(alive)
            else:
                # sync TTL-cache fast path: the fire half must not
                # round-trip the loop per dispatch — only the expired
                # window pays the (bounded, control-plane) refresh
                alive = self.alive_cache.peek_fresh()
                if alive is None:
                    alive = client_loop().run(self.alive_cache.get())
                alive_uids = sorted(
                    filter_valid_uids(alive, self.uid_prefix, self.grid_size)
                )
            # replica-aware resolution: each uid's alive-map value may be
            # a single endpoint (the historical form) or a DHT-advertised
            # replica SET; the cost model orders every set cheapest-first,
            # so entry 0 is the least-loaded primary and entry 1 the
            # hedge backup
            replica_sets: dict[str, ReplicaSet] = {
                uid: self.cost_model.order_replicas(
                    as_replica_set(alive[uid]), nbytes=x.nbytes
                )
                for uid in alive_uids
            }
            alive_uids = [uid for uid in alive_uids if replica_sets[uid]]
            if not alive_uids:
                raise MoEDispatchError(
                    f"no alive experts under prefix {self.uid_prefix!r}"
                )
            self._replica_counts = {
                uid: len(replica_sets[uid]) for uid in alive_uids
            }
            # latency-aware selection bias (None at weight 0 → bitwise
            # the blind gate); combine weights stay clean-gate
            bias = self.cost_model.bias(
                alive_uids, replica_sets, nbytes=x.nbytes
            )
            sel, coords = select_top_k(
                logits, alive_uids, self.k_best, bias=bias
            )  # [B, k']
            k_eff = sel.shape[1]
            # which experts this dispatch actually selected — the observable
            # the latency-aware-routing tests assert on (mechanism, not clock)
            chosen = sorted({alive_uids[e] for e in np.unique(sel)})
            self.selection_log.append(frozenset(chosen))
            # co-activation accumulation (ISSUE 16): every pair selected
            # together this dispatch feeds the placement solver's graph
            self.coact_dispatches += 1
            for i in range(len(chosen)):
                for j in range(i + 1, len(chosen)):
                    key = f"{chosen[i]}|{chosen[j]}"
                    n = self.coact_counts.get(key)
                    if n is not None:
                        self.coact_counts[key] = n + 1
                    elif len(self.coact_counts) < COACT_MAX_PAIRS:
                        self.coact_counts[key] = 1
                    else:
                        self.coact_pairs_dropped += 1

            # group rows by chosen expert: expert -> (rows, slots)
            jobs: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            for j in range(k_eff):
                for e in np.unique(sel[:, j]):
                    rows = np.nonzero(sel[:, j] == e)[0]
                    if e in jobs:
                        jobs[e] = (
                            np.concatenate([jobs[e][0], rows]),
                            np.concatenate([jobs[e][1], np.full(len(rows), j)]),
                        )
                    else:
                        jobs[e] = (rows, np.full(len(rows), j))

            # least-loaded replica pick: the job targets the cheapest
            # replica; the second-cheapest (if any) rides along as the
            # hedge backup for the fan-out's hedged fallback
            backups: dict[str, Optional[tuple]] = {
                alive_uids[e]: (
                    replica_sets[alive_uids[e]][1]
                    if len(replica_sets[alive_uids[e]]) > 1 else None
                )
                for e in jobs
            }
            prepared = None
            if dispatch_mode() == "pipelined":
                # payload slot left empty: _prepare_payloads slices each
                # expert's rows from the ONE wire-cast batch — materializing
                # x[rows] here too would double the hot-path memcpy
                uid_jobs, prepared = self._prepare_payloads(
                    "forward",
                    {
                        alive_uids[e]: (
                            replica_sets[alive_uids[e]][0], None, rows, slots
                        )
                        for e, (rows, slots) in jobs.items()
                    },
                    x_full=x,
                    trace=trace,
                )
            else:
                uid_jobs = {
                    alive_uids[e]: (
                        replica_sets[alive_uids[e]][0], x[rows], rows, slots
                    )
                    for e, (rows, slots) in jobs.items()
                }

        coro = self._quorum_fanout(
            msg_type="forward",
            jobs=uid_jobs,
            batch=batch,
            quorum=self.k_min,
            rpc_timeout=self.forward_timeout,
            prepared=prepared,
            trace=trace,
            # hedging is a pipelined-path behavior: the legacy arm stays
            # the exact pre-replica A/B baseline
            backups=backups if dispatch_mode() == "pipelined" else None,
        )

        fut_box: list = []

        def finalize(results):
            # dispatch latency ends when the FAN-OUT resolved (stamped on
            # the loop thread), not when the caller got around to joining:
            # under the overlapped schedule now-minus-t0 would fold the
            # deliberately hidden trunk compute into the north-star
            # dispatch p50 and make overlap read as a latency regression
            t_end = fut_box[0].completed_at if fut_box else None
            return self._finalize_forward(
                results, x=x, coords=coords, sel=sel, batch=batch,
                store_session=store_session, session_id=session_id,
                trace=trace, t0=t0, t_end=t_end,
            )

        fut = DispatchFuture(
            "forward", coro, finalize,
            join_timeout=self._join_timeout("forward"),
            watchdog_rtt=(
                self._slowest_rtt(uid_jobs)
                if dispatch_mode() == "legacy" else None
            ),
            what=f"forward dispatch ({self.uid_prefix}, {batch} rows)",
            on_join_exit=self._make_join_exit(trace),
        )
        fut_box.append(fut)
        with self._sessions_lock:
            self.inflight_dispatches += 1
        return fut

    @sanitizer.runs_on("host", site="moe._finalize_forward")
    def _finalize_forward(
        self, results, *, x, coords, sel, batch, store_session, session_id,
        trace, t0, t_end=None,
    ):
        """JOIN-side accumulation of a forward fan-out's replies into the
        (y, idx, mask, cid) quadruple — quorum accounting, per-sample
        degradation, and the backward-session store.  Runs on the joining
        host thread via DispatchFuture's finalizer."""
        import time as _time

        k_eff = sel.shape[1]
        y = np.zeros((batch, self.k_best, x.shape[1]), x.dtype)
        mask = np.zeros((batch, self.k_best), bool)
        idx = np.zeros((batch, self.k_best, self.n_dims), np.int32)
        idx[:, :k_eff] = coords[sel]
        session: dict[str, tuple] = {}
        for uid, (endpoint, x_rows, rows, slots, reply) in results.items():
            if reply is None:
                continue
            arr = np.asarray(reply[0], x.dtype)
            if arr.shape != (len(rows), x.shape[1]):
                # wrong-arity reply from a buggy/malicious expert: treat it
                # exactly like a failed RPC, never slice-and-accept
                logger.warning(
                    "expert %s returned shape %s, expected %s — discarding",
                    uid, arr.shape, (len(rows), x.shape[1]),
                )
                continue
            y[rows, slots] = arr
            mask[rows, slots] = True
            session[uid] = (endpoint, x_rows, rows, slots)

        per_sample_ok = mask.sum(axis=1)
        dropped = per_sample_ok < self.k_min
        self.samples_total += batch
        if dropped.any():
            if dropped.all():
                raise MoEDispatchError(
                    f"total dispatch failure: no sample of {batch} reached "
                    f"k_min={self.k_min} expert replies"
                )
            # per-sample degradation: below-quorum samples contribute zero
            # (their mask rows go all-False → zero mixture weights) and are
            # counted, but the step survives
            n_drop = int(dropped.sum())
            self.samples_dropped += n_drop
            mask[dropped] = False
            y[dropped] = 0.0
            logger.warning(
                "quorum miss: %d of %d samples below k_min=%d — masked to "
                "zero contribution", n_drop, batch, self.k_min,
            )

        cid = -1
        if store_session:
            cid = session_id if session_id is not None else next(
                self._call_counter
            )
            with self._sessions_lock:
                # the forward-dropped mask rides along so the backward path
                # doesn't re-count those samples as backward failures; the
                # trace id rides too — backward joins the forward's trace
                self._sessions[cid] = (session, dropped.copy(), trace)
                while len(self._sessions) > self.max_sessions:
                    self._sessions.popitem(last=False)
        dispatch_s = (t_end if t_end is not None else _time.monotonic()) - t0
        self.dispatch_times.append(dispatch_s)
        # sketch-backed registry histogram (ISSUE 19): feeds TRUE fleet
        # dispatch-latency quantiles via mergeable sketches in telemetry,
        # alongside the deque-based single-process p50/p99 above
        from learning_at_home_tpu_torch.utils.metrics import registry as _registry

        _registry.histogram(
            "lah_client_dispatch_seconds",
            "end-to-end dispatch latency (fire → join done)",
        ).observe(dispatch_s)
        self.dispatches += 1
        return y, idx, mask, np.int32(cid)

    @staticmethod
    def _slowest_rtt(uid_jobs: dict):
        """Worst involved pool's RTT EMA (the dispatch-wait watchdog's
        scale); None when nothing has been measured yet."""
        registry = pool_registry()
        worst = None
        for job in uid_jobs.values():
            pool = registry.peek(job[0])
            if pool is not None and pool.rtt_ema is not None:
                worst = (
                    pool.rtt_ema if worst is None
                    else max(worst, pool.rtt_ema)
                )
        return worst

    # ---- host-thread serialization (the off-loop half of the pipeline) ----

    def _base_codec(self) -> str:
        from learning_at_home_tpu_torch.utils.serialization import _DTYPE_TO_CODEC

        return _DTYPE_TO_CODEC.get(self.wire_dtype, "none")

    def _select_codec(self, kind: str, endpoint, nbytes: int) -> str:
        """Per-pool wire codec for one fan-out request (docs/PROTOCOL.md
        escalation policy).  Override (LAH_WIRE_CODEC / constructor) wins;
        otherwise the adaptive selector escalates none→bf16→8-bit from
        the pool's RTT EMA + measured bytes/sec.  Quantized codecs are
        only offered to pools whose hello echoed the ``codec`` feature —
        v1 peers, old builds and not-yet-negotiated pools fall back to
        the wire_dtype base."""
        from learning_at_home_tpu_torch.utils.serialization import (
            QUANTIZED_CODECS,
            select_wire_codec,
        )

        base = self._base_codec()
        pool = pool_registry().peek(endpoint)
        if self.wire_codec is not None:
            codec = self.wire_codec
        else:
            codec = select_wire_codec(
                kind, nbytes,
                pool.rtt_ema if pool is not None else None,
                pool.bw_ema if pool is not None else None,
                base=base,
            )
        if codec in QUANTIZED_CODECS and (
            pool is None or not pool.supports("codec")
        ):
            return base
        return codec

    @staticmethod
    def _wire_meta_for(codec: str, headers: list):
        """meta ``{"wire": ...}`` value for one request's payload."""
        from learning_at_home_tpu_torch.utils.serialization import (
            _CODEC_TO_DTYPE,
            QUANTIZED_CODECS,
        )

        if codec in QUANTIZED_CODECS or any(
            isinstance(h, dict) and h.get("c") in QUANTIZED_CODECS
            for h in headers
        ):
            return {"c": codec, "h": headers}
        return _CODEC_TO_DTYPE.get(codec)  # legacy string, or None for raw

    @sanitizer.runs_on("host", site="moe._prepare_payloads")
    def _prepare_payloads(self, kind: str, uid_jobs: dict,
                          x_full=None, gy_full=None,
                          trace=None) -> tuple[dict, dict]:
        """Serialize the fan-out's payloads ON THIS host thread (the
        caller is already blocked in the autograd function) so the client event
        loop only writes ready buffers — the client-side mirror of PR 1's
        no-work-on-the-loop rule.

        Pack-once contract: the wire encode (downcast OR 8-bit quantize —
        ISSUE 5) runs once over the FULL batch (``x`` forward, ``gy``
        backward) per codec actually selected, and every expert's payload
        — including its per-tensor quantization header — is a slice of
        that one encoding (blockq8 blocks never cross the trailing axis,
        so row gathers keep block alignment); per-call packing would
        re-encode each sample's rows once per selected expert (k× the
        work).  The prepared blobs are immutable and shared across the
        merged ``multi`` call and any disaggregated per-expert retry.
        Backward reuses the forward's already-encoded rows stored in the
        session — identical bytes, so the server differentiates at
        exactly the point it evaluated — and encodes only the gradients
        (``blockq8`` when quantizing: gradient-safe per-block stats).

        The codec is chosen PER POOL (one codec per endpoint per
        direction, so a merged ``multi`` request stays one wire form);
        swarms with heterogeneous link speeds may encode the batch under
        more than one codec, each once.

        Returns ``(jobs, prepared)``: jobs with payload slots replaced by
        the wire-encoded arrays (sessions then store wire rows — wrapped
        with their headers for quantized codecs), and uid →
        ``(WireTensors, wire_meta)``.  ``pack_bytes_saved`` accumulates
        the wire-encode bytes avoided vs per-call packing."""
        import time as _time

        from learning_at_home_tpu_torch.utils.serialization import (
            EncodedBatch,
            LazyDecode,
            QUANTIZED_CODECS,
            WireTensors,
            is_float_dtype,
            wire_cast,
        )

        t0 = _time.monotonic()
        wd = self.wire_dtype
        out_jobs: dict = {}
        prepared: dict = {}
        saved = 0
        itemsize = 4  # selection estimates assume f32 payloads

        # one codec per endpoint per direction: estimate each pool's
        # total payload and ask the selector once
        ep_bytes: dict = {}
        for uid, job in uid_jobs.items():
            rows = job[2]
            feat = (
                int(np.prod(x_full.shape[1:])) if kind == "forward"
                else int(gy_full.shape[-1]) * 2
            )
            ep_bytes[job[0]] = ep_bytes.get(job[0], 0) + len(rows) * feat * itemsize
        ep_codec = {
            ep: self._select_codec(kind, ep, nb) for ep, nb in ep_bytes.items()
        }

        enc_cache: dict = {}

        def batch_enc(arr, codec, key) -> EncodedBatch:
            eb = enc_cache.get((key, codec))
            if eb is None:
                eb = enc_cache[(key, codec)] = EncodedBatch.encode(arr, codec)
            return eb

        dup: dict = {}
        if kind == "forward":
            for uid, (ep, _x_rows, rows, slots) in uid_jobs.items():
                codec = ep_codec[ep]
                eb = batch_enc(x_full, codec, "x")
                x_pay, h = eb.take(rows)
                dup[codec] = dup.get(codec, 0) + x_pay.nbytes
                # the session stores exactly the bytes the server saw, so
                # backward can resend them verbatim
                stored = (
                    LazyDecode(x_pay, h)
                    if isinstance(h, dict) and h.get("c") in QUANTIZED_CODECS
                    else x_pay
                )
                out_jobs[uid] = (ep, stored, rows, slots)
                prepared[uid] = (
                    WireTensors.prepare([x_pay]),
                    self._wire_meta_for(codec, [h]),
                )
                self.codec_counts[codec] = self.codec_counts.get(codec, 0) + 1
                timeline.count(f"client.pack.codec.{codec}")
                timeline.count(f"client.pack.codec.{codec}.bytes", x_pay.nbytes)
            for codec, nbytes_dup in dup.items():
                if codec != "none":
                    saved += max(0, nbytes_dup - enc_cache[("x", codec)].wire.nbytes)
        else:
            for uid, (ep, x_stored, rows, slots) in uid_jobs.items():
                codec = ep_codec[ep]
                eb = batch_enc(gy_full, codec, "gy")
                g_pay, gh = eb.take((rows, slots))
                # input half: resend the forward's exact wire bytes
                if isinstance(x_stored, LazyDecode):
                    pool = pool_registry().peek(ep)
                    if pool is not None and pool.supports("codec"):
                        x_pay, xh = x_stored.wire, x_stored.header
                        saved += x_stored.wire_nbytes  # re-encode avoided
                    else:  # peer demoted mid-session: decode locally
                        x_pay, xh = np.asarray(x_stored, np.float32), None
                        if codec in ("bf16", "f16"):
                            from learning_at_home_tpu_torch.utils.serialization import (  # noqa: E501
                                _CODEC_TO_DTYPE,
                            )

                            # downcast request: all floats must match
                            x_pay = wire_cast(
                                [x_pay], _CODEC_TO_DTYPE[codec]
                            )[0]
                            xh = {"c": codec}
                else:
                    from learning_at_home_tpu_torch.utils.serialization import (
                        _CODEC_TO_DTYPE,
                        _DTYPE_TO_CODEC,
                    )

                    x_pay = np.asarray(x_stored)
                    xh = None
                    if is_float_dtype(x_pay.dtype) and x_pay.dtype != np.dtype(
                        np.float32
                    ):
                        # session rows already downcast by the forward
                        name = _DTYPE_TO_CODEC.get(x_pay.dtype.name)
                        if codec in ("bf16", "f16") and name == codec:
                            saved += x_pay.nbytes  # reuse, same form
                            xh = {"c": codec}
                        elif name is not None and codec in QUANTIZED_CODECS:
                            # quantized request: the dict form declares
                            # the downcast per tensor — reuse the bytes
                            saved += x_pay.nbytes
                            xh = {"c": name}
                        else:
                            # form mismatch (adaptive drift between
                            # directions, or a legacy-mode forward):
                            # send exact f32 rather than violate the
                            # all-floats-compressed legacy contract
                            x_pay = np.asarray(x_pay, np.float32)
                    elif (
                        is_float_dtype(x_pay.dtype)
                        and codec in ("bf16", "f16")
                    ):
                        # f32 session rows under a downcast request: the
                        # legacy string form compresses ALL floats, x too
                        x_pay = wire_cast(
                            [x_pay], _CODEC_TO_DTYPE[codec]
                        )[0]
                        xh = {"c": codec}
                wire_meta = self._wire_meta_for(codec, [xh, gh])
                if not isinstance(wire_meta, dict):
                    xh = None  # legacy string form: headers don't travel
                out_jobs[uid] = (ep, x_pay, rows, slots, g_pay)
                prepared[uid] = (
                    WireTensors.prepare([x_pay, g_pay]), wire_meta
                )
                self.codec_counts[codec] = self.codec_counts.get(codec, 0) + 1
                timeline.count(f"client.pack.codec.{codec}")
                timeline.count(
                    f"client.pack.codec.{codec}.bytes",
                    x_pay.nbytes + g_pay.nbytes,
                )
        dt = _time.monotonic() - t0
        nbytes = sum(p[0].nbytes for p in prepared.values())
        self.pack_times.append(dt)
        self.pack_bytes += nbytes
        self.pack_bytes_saved += saved
        timeline.record(f"client.pack.{kind}", t0, dt, trace=trace)
        timeline.count("client.pack.bytes", nbytes)
        timeline.count("client.pack_once.bytes_saved", saved)
        return out_jobs, prepared

    def _headline_metrics(self) -> dict:
        """The ~always-on headline counters this layer contributes to the
        unified metrics registry (utils/metrics.py) — plain attribute
        reads plus two scrape-time percentiles, never hot-path work.
        ``dispatch_stats()`` and the Prometheus/JSON endpoints all read
        THIS dict, so the numbers cannot drift apart."""

        def snap(d):
            # scrape threads race the training thread's appends; deque
            # appends are atomic but ITERATION during one raises
            # RuntimeError — retry rather than putting a lock on the
            # per-dispatch hot path just for telemetry reads
            for _ in range(4):
                try:
                    return list(d)
                except RuntimeError:
                    continue
            return []

        def p_ms(d, q):
            arr = np.asarray(snap(d))
            return (
                round(float(np.percentile(arr, q)) * 1e3, 3)
                if arr.size else 0.0
            )

        codec_counts = self._snap_codec_counts()
        # time-weighted overlap: the fraction of all in-flight RPC time
        # this layer's caller hid behind its own compute (0.0 in the
        # serial regime, > 0 once a scheduler defers its joins)
        inflight_s = self.inflight_seconds
        blocked_s = self.join_blocked_seconds
        overlap = (
            max(0.0, min(1.0, 1.0 - blocked_s / inflight_s))
            if inflight_s > 0 else 0.0
        )
        replica_counts = self._snap_replica_counts()
        replicated = sum(1 for n in replica_counts.values() if n > 1)
        return {
            **{
                f"lah_client_wire_codec_payloads_total_codec_{c}": n
                for c, n in codec_counts.items()
            },
            # latency-aware routing + hedged replica dispatch (ISSUE 8)
            "lah_client_routing_bias_applied_total": (
                self.cost_model.bias_applied
            ),
            "lah_client_hedge_fires_total": self.hedge_fires,
            "lah_client_hedge_wins_total": self.hedge_wins,
            "lah_client_hedges_skipped_total": self.hedges_skipped,
            "lah_client_fresh_retries_total": self.fresh_retries,
            "lah_client_fresh_retry_wins_total": self.fresh_retry_wins,
            "lah_client_replicated_experts": replicated,
            "lah_client_replicas_max": max(
                replica_counts.values(), default=0
            ),
            "lah_client_overlap_fraction": round(overlap, 4),
            "lah_client_inflight_dispatches": self.inflight_dispatches,
            "lah_client_inflight_seconds_total": round(inflight_s, 3),
            "lah_client_join_blocked_seconds_total": round(blocked_s, 3),
            "lah_client_dispatches_total": self.dispatches,
            "lah_client_samples_total": self.samples_total,
            "lah_client_samples_dropped_total": self.samples_dropped,
            "lah_client_backward_samples_dropped_total": (
                self.backward_samples_dropped
            ),
            "lah_client_backward_rpcs_sent_total": self.backward_rpcs_sent,
            "lah_client_backward_rpcs_ok_total": self.backward_rpcs_ok,
            "lah_client_pack_bytes_total": self.pack_bytes,
            "lah_client_pack_once_bytes_saved_total": self.pack_bytes_saved,
            "lah_client_dispatch_p50_ms": p_ms(self.dispatch_times, 50),
            "lah_client_dispatch_p99_ms": p_ms(self.dispatch_times, 99),
            "lah_client_pack_p50_ms": p_ms(self.pack_times, 50),
            "lah_client_wait_p50_ms": p_ms(self.wait_times, 50),
            # placement measurement (ISSUE 16): the co-activation graph
            # this gate observed + routing's swarm-link-prior usage
            "lah_placement_coact_pairs": len(self._snap_coact_counts()),
            "lah_placement_coact_dispatches_total": self.coact_dispatches,
            "lah_placement_coact_pairs_dropped_total": (
                self.coact_pairs_dropped
            ),
            "lah_placement_link_fallbacks_total": (
                self.cost_model.link_fallbacks
            ),
        }

    def dispatch_stats(self) -> dict:
        """Client hot-path counters for benchmarks/telemetry: serialize
        vs wait breakdown, bytes on the wire, pack-once savings, and the
        per-pool multiplexed in-flight high-water mark.  Plumbed through
        the same ``_headline_metrics`` dict the registry exports (ISSUE
        4: no more hand-rolled parallel dicts) plus the process-wide
        transport counters from the connection-pool registry."""
        m = self._headline_metrics()

        def nz(v):  # deques empty → None, the historical contract
            return v if v else None

        pools = pool_registry().pools()
        return {
            "pack_p50_ms": nz(m["lah_client_pack_p50_ms"]),
            "wait_p50_ms": nz(m["lah_client_wait_p50_ms"]),
            "pack_bytes": int(m["lah_client_pack_bytes_total"]),
            "pack_once_bytes_saved": int(
                m["lah_client_pack_once_bytes_saved_total"]
            ),
            "dispatches": int(m["lah_client_dispatches_total"]),
            # who is actually overlapping (ISSUE 7): time-weighted hidden
            # fraction of the in-flight RPC windows + the live gauge of
            # fired-but-unjoined dispatches
            "overlap_fraction": m["lah_client_overlap_fraction"],
            "inflight_dispatches": int(m["lah_client_inflight_dispatches"]),
            "bytes_sent": int(sum(p.bytes_sent for p in pools)),
            "bytes_received": int(sum(p.bytes_received for p in pools)),
            "inflight_depth_max": max(
                (p.inflight_max for p in pools), default=0
            ),
            "protocol": "v2" if any(p._proto == 2 for p in pools) else "v1",
            # per-codec payload counts: which wire encoding dispatches
            # actually negotiated+selected (the codec-smoke observable);
            # copy-with-retry — a scrape racing the host thread's first
            # insert of a new codec key must not crash on "dict changed
            # size during iteration"
            "codecs": self._snap_codec_counts(),
            # latency-aware routing + replica/hedge observability
            # (ISSUE 8): what the cost model actually did this run
            "routing": {
                "cost_weight": self.cost_model.weight,
                "bias_applied": int(
                    m["lah_client_routing_bias_applied_total"]
                ),
                "load_refresh_failures": (
                    self.cost_model.load_refresh_failures
                ),
                "hedge_fires": int(m["lah_client_hedge_fires_total"]),
                "hedge_wins": int(m["lah_client_hedge_wins_total"]),
                "hedges_skipped": int(
                    m["lah_client_hedges_skipped_total"]
                ),
                "fresh_retries": int(m["lah_client_fresh_retries_total"]),
                "fresh_retry_wins": int(
                    m["lah_client_fresh_retry_wins_total"]
                ),
                "replicated_experts": int(
                    m["lah_client_replicated_experts"]
                ),
                "replica_counts": self._snap_replica_counts(),
            },
            # placement measurement (ISSUE 16): what the rebalancer's
            # snapshot builder scrapes off this trainer — the observed
            # co-activation graph (top pairs), this process's measured
            # per-destination link EMAs, and the mean payload size the
            # solver turns into transfer-time terms
            "placement": self.placement_stats(),
        }

    def placement_stats(self, top_pairs: int = 64) -> dict:
        """Serializable placement-measurement section: bounded top-N of
        the co-activation pair counts (count-desc then key, so the map
        is deterministic for a given graph), the swarm-wire link
        snapshot from this process's connection pools, and dispatch
        bytes.  Shapes match what ``tools/lah_rebalance.py`` merges into
        the solver snapshot."""
        from learning_at_home_tpu_torch.utils.telemetry import link_snapshot

        coact = self._snap_coact_counts()
        top = dict(
            sorted(coact.items(), key=lambda kv: (-kv[1], kv[0]))
            [:top_pairs]
        )
        dispatches = self.dispatches
        return {
            "coact": top,
            "coact_pairs": len(coact),
            "coact_dispatches": self.coact_dispatches,
            "coact_pairs_dropped": self.coact_pairs_dropped,
            "links": link_snapshot(),
            "link_fallbacks": self.cost_model.link_fallbacks,
            "bytes_per_dispatch": (
                round(self.pack_bytes / dispatches, 1) if dispatches else 0.0
            ),
        }

    def _snap_codec_counts(self) -> dict:
        for _ in range(4):
            try:
                return dict(self.codec_counts)
            except RuntimeError:
                continue
        return {}

    def _snap_coact_counts(self) -> dict:
        # copy-with-retry: scrapes race the host thread's pair inserts
        for _ in range(4):
            try:
                return dict(self.coact_counts)
            except RuntimeError:
                continue
        return {}

    def _snap_replica_counts(self) -> dict:
        # copy-with-retry: the host thread replaces this dict wholesale
        # per dispatch; a scrape racing the swap must never crash
        for _ in range(4):
            try:
                return dict(self._replica_counts)
            except RuntimeError:
                continue
        return {}

    # ---- hedge accounting (owned by the lah-client LOOP thread: armed
    #      and resolved inside the fan-out coroutine — docs/CONCURRENCY.md
    #      invariant 9; no locks, scrapes read plain-int snapshots) ----

    @sanitizer.runs_on("not:lah-runtime", site="moe.hedge_arm")
    def _arm_hedge(self, primary, backup) -> None:
        """Hedge-fire entry point: the primary outlived its RTT-derived
        deadline (or failed) and the backup replica is being dispatched."""
        self.hedge_fires += 1
        timeline.count("client.hedge.fires")
        flight.record(
            "client", "hedge_fire", primary=str(primary), backup=str(backup)
        )
        logger.debug("hedge fired: primary %s → backup %s", primary, backup)

    @sanitizer.runs_on("not:lah-runtime", site="moe.hedge_arm")
    def _hedge_skipped(self, backup) -> None:
        """A due hedge NOT fired: the backup pool cannot accept the
        prepared wire form (codec never negotiated) — counted, never
        silently dropped."""
        self.hedges_skipped += 1
        timeline.count("client.hedge.skipped")

    # ---- host side: backward fan-out to exactly the responders ----

    def _host_backward(self, cid, gy):
        gy = np.asarray(gy)
        with self._sessions_lock:
            entry = self._sessions.pop(int(cid), None)
        if entry is None:
            raise MoEDispatchError(
                f"no dispatch session {int(cid)}: backward without forward, "
                "or session evicted (raise max_sessions?)"
            )
        session, fwd_dropped, trace = entry
        with timeline.span(f"moe.backward.{self.uid_prefix}", trace=trace):
            return self._host_backward_impl(session, fwd_dropped, trace, gy)

    def _host_backward_impl(self, session, fwd_dropped, trace, gy):
        return self.backward_async(session, fwd_dropped, trace, gy).join()

    @sanitizer.runs_on("host", site="moe.backward_async")
    def backward_async(self, session, fwd_dropped, trace, gy) -> DispatchFuture:
        """FIRE half of a backward dispatch: serialize the gradient
        fan-out (reusing the forward's already-encoded session rows) and
        submit it non-blocking — the mirror of :meth:`dispatch_async`,
        so backward trunk compute can overlap the grad RPCs too."""
        batch = gy.shape[0]
        with self._sessions_lock:
            self.backward_rpcs_sent += len(session)
        with timeline.span("client.dispatch.fire", trace=trace):
            prepared = None
            if dispatch_mode() == "pipelined":
                uid_jobs, prepared = self._prepare_payloads(
                    "backward", session, gy_full=gy, trace=trace
                )
            else:
                uid_jobs = {
                    uid: (ep, x_rows, rows, slots, gy[rows, slots])
                    for uid, (ep, x_rows, rows, slots) in session.items()
                }
        coro = self._quorum_fanout(
            msg_type="backward",
            jobs=uid_jobs,
            batch=batch,
            quorum=self.backward_k_min,
            rpc_timeout=self.backward_timeout,
            prepared=prepared,
            trace=trace,
        )

        def finalize(results):
            return self._finalize_backward(
                results, session=session, fwd_dropped=fwd_dropped,
                gy=gy, batch=batch,
            )

        fut = DispatchFuture(
            "backward", coro, finalize,
            join_timeout=self._join_timeout("backward"),
            watchdog_rtt=(
                self._slowest_rtt(uid_jobs)
                if dispatch_mode() == "legacy" else None
            ),
            what=f"backward dispatch ({self.uid_prefix}, {batch} rows)",
            on_join_exit=self._make_join_exit(trace),
        )
        with self._sessions_lock:
            self.inflight_dispatches += 1
        return fut

    @sanitizer.runs_on("host", site="moe._finalize_backward")
    def _finalize_backward(self, results, *, session, fwd_dropped, gy, batch):
        gx = np.zeros((batch, gy.shape[-1]), gy.dtype)
        ok = np.zeros(batch, np.int64)
        with self._sessions_lock:
            # a reply means the expert ran backward AND queued its async
            # update, whether or not the grad shape below survives
            # client-side validation
            self.backward_rpcs_ok += sum(
                1 for p in results.values() if p[-1] is not None
            )
        for uid, payload in results.items():
            reply = payload[-1]
            if reply is None:
                continue
            _, _, rows, slots = session[uid][:4]
            arr = np.asarray(reply[0], gy.dtype)
            if arr.shape != (len(rows), gy.shape[-1]):
                logger.warning(
                    "expert %s returned grad shape %s, expected %s — discarding",
                    uid, arr.shape, (len(rows), gy.shape[-1]),
                )
                continue
            gx[rows] += arr
            ok[rows] += 1
        # samples already dropped in forward contributed zero to the loss;
        # their missing grads are expected, not a second failure
        below = (ok < self.backward_k_min) & ~fwd_dropped
        active = ~fwd_dropped
        if below.any():
            if active.any() and below[active].all():
                raise MoEDispatchError(
                    f"total backward failure: no live sample of {batch} "
                    f"reached backward_k_min={self.backward_k_min} grad replies"
                )
            # mirror the forward degradation: below-quorum samples get zero
            # input-gradient instead of killing the whole training step
            n_drop = int(below.sum())
            self.backward_samples_dropped += n_drop
            gx[below] = 0.0
            logger.warning(
                "backward quorum miss: %d of %d samples below "
                "backward_k_min=%d — zero input-grad", n_drop, batch,
                self.backward_k_min,
            )
        return gx

    # ---- host halves of the fire/join autograd pair ----

    def _host_fire(self, x, logits_concat, store_session: bool = True):
        trace = new_trace_id() if timeline.enabled else None
        fid = next(self._call_counter)
        fut = self.dispatch_async(
            x, logits_concat, store_session=store_session, trace=trace,
            session_id=fid,
        )
        evicted = []
        with self._sessions_lock:
            self._pending[fid] = fut
            while len(self._pending) > self.max_sessions:
                evicted.append(self._pending.popitem(last=False))
        # cancel OUTSIDE the lock: the future's join-exit hook re-acquires
        # it to drain the in-flight gauge
        for stale_fid, stale in evicted:
            stale.cancel()
            logger.warning(
                "evicted un-joined dispatch ticket %d — a fire without "
                "a join leaks an in-flight fan-out (raise max_sessions, "
                "or join what you fire)", stale_fid,
            )
        return np.int32(fid)

    def _host_join(self, handle):
        fid = int(handle)
        with self._sessions_lock:
            fut = self._pending.pop(fid, None)
        if fut is None:
            raise MoEDispatchError(
                f"no in-flight dispatch {fid}: join without fire, or the "
                "ticket was evicted (raise max_sessions?)"
            )
        try:
            return fut.join()
        except Exception as e:
            # a failed/timed-out join must surface as THE diagnosable
            # dispatch error, never a hang (the retired ROUND5 class)
            if isinstance(e, MoEDispatchError):
                raise
            raise MoEDispatchError(
                f"dispatch {fid} join failed: {type(e).__name__}: {e}"
            ) from e

    def _host_fire_backward(self, cid, gy):
        gy = np.asarray(gy)
        cid = int(cid)
        with self._sessions_lock:
            entry = self._sessions.pop(cid, None)
        if entry is None:
            raise MoEDispatchError(
                f"no dispatch session {cid}: backward without forward, "
                "or session evicted (raise max_sessions?)"
            )
        session, fwd_dropped, trace = entry
        fut = self.backward_async(session, fwd_dropped, trace, gy)
        evicted = []
        with self._sessions_lock:
            self._pending_bwd[cid] = fut
            while len(self._pending_bwd) > self.max_sessions:
                evicted.append(self._pending_bwd.popitem(last=False))
        for _sf, stale in evicted:  # outside the lock: see _host_fire
            stale.cancel()
        # the zeros cotangent for token: pure graph ordering (the joining
        # fire_bwd callback consumes it, so it runs after this one)
        return np.zeros((gy.shape[0], gy.shape[-1]), gy.dtype)

    def _host_join_backward(self, handle, _g_token):
        fid = int(handle)
        with self._sessions_lock:
            fut = self._pending_bwd.pop(fid, None)
        if fut is None:
            raise MoEDispatchError(
                f"no in-flight backward {fid}: the join op's bwd never "
                "fired (session evicted?)"
            )
        try:
            return fut.join()
        except Exception as e:
            # same contract as _host_join: a failed/timed-out backward
            # join surfaces as THE diagnosable dispatch error
            if isinstance(e, MoEDispatchError):
                raise
            raise MoEDispatchError(
                f"backward dispatch {fid} join failed: "
                f"{type(e).__name__}: {e}"
            ) from e

    def discard(self, token=None, handle=None, logits_concat=None) -> None:
        """Error-path cleanup for a fired-but-unjoined dispatch: pop the
        ticket and cancel its fan-out (draining the in-flight gauge),
        so an exception between :meth:`fire` and :meth:`join` never
        leaks an in-flight fan-out until eviction.  Accepts the full
        ``fire(...)`` return tuple (``discard(*pending)``); a no-op for
        already-joined tickets."""
        if handle is None:
            return
        fid = int(handle)
        with self._sessions_lock:
            fut = self._pending.pop(fid, None)
        if fut is not None:
            fut.cancel()

    # ---- the k-of-n gather loop (shared by forward and backward) ----

    async def _quorum_fanout(
        self, msg_type: str, jobs: dict, batch: int, quorum: int,
        rpc_timeout: float, prepared: Optional[dict] = None,
        trace: Optional[str] = None, backups: Optional[dict] = None,
    ) -> dict:
        """Run the fan-out in parallel; once every sample has ≥ quorum
        successful replies, wait a grace period then cancel stragglers (the
        reference's k_min + timeout_after_k_min contract).

        ``backups`` (uid → backup replica endpoint or None; FORWARD only)
        arms hedged fallback per group: once the primary's call outlives
        ``hedge_mult × its RTT EMA`` (floor ``hedge_floor_s``) — or fails
        outright — the SAME prepared payload fires at the backup replica
        and the first successful reply wins.  Cancel semantics
        (docs/PROTOCOL.md): a primary that lost to its hedge is cancelled
        WITH ``QUORUM_STRAGGLER_CANCEL`` (it exceeded the hedge deadline,
        so its elapsed wait folds into its RTT EMA), while a backup that
        lost the race is cancelled UNMARKED — its short unfinished wait
        is evidence about the race, not the peer, and must never reach
        the EMA.  Backward fan-outs never hedge: the server-side
        optimizer step is a side effect a duplicate request would apply
        twice (same reasoning as the no-retry rule below).

        Jobs for experts co-hosted on ONE endpoint travel as a single
        ``multi`` request (per-part replies) — per-request overhead is paid
        per peer, not per expert, and the failure/straggler granularity
        this coarsens to is the real one: co-hosted experts share a
        process, so they die (and straggle) together anyway.

        ``prepared`` (pipelined mode) maps uid → WireTensors serialized on
        the host thread; this coroutine then never casts or packs tensor
        bytes on the loop — merged calls concatenate blob REFERENCES, and
        a disaggregated retry reuses the same buffers."""
        loop = asyncio.get_running_loop()
        registry = pool_registry()
        groups: dict = {}  # endpoint -> [uid, ...]
        for uid, job in jobs.items():
            groups.setdefault(job[0], []).append(uid)
        group_list = list(groups.items())
        if not self.merge_rpcs:
            group_list = [
                (ep, [uid]) for ep, uids in group_list for uid in uids
            ]

        def cast(arr):
            """Downcast floating payloads to the wire dtype (transport
            encoding only; replies are upcast back at the accumulation
            sites via ``np.asarray(reply, dtype)``)."""
            from learning_at_home_tpu_torch.utils.serialization import wire_cast

            return wire_cast([arr], self.wire_dtype)[0]

        async def call_single(endpoint, uid) -> dict:
            meta = (
                {"uid": uid}
                if msg_type == "forward"
                else {"uid": uid, "n_inputs": 1}
            )
            if trace is not None:
                # the trace id rides in the SAME meta on the merged call,
                # the disaggregated retry, and the v1 fallback — the
                # server stamps it onto its pool/runtime spans
                meta["trace"] = trace
            pool = registry.get(endpoint)
            if prepared is not None:
                wire_obj, wmeta = prepared[uid]
                if wmeta is not None:
                    # wmeta is built per-endpoint by the adaptive codec
                    # selector, which only offers encoded (dict) forms to
                    # pools whose hello negotiated "codec" — the gate is
                    # upstream of this function, out of static reach
                    # lah-lint: ignore[R14]
                    meta["wire"] = wmeta
                tensors, _ = await pool.rpc_prepared(
                    msg_type, wire_obj, meta, timeout=rpc_timeout
                )
            else:
                if self.wire_dtype is not None:
                    meta["wire"] = self.wire_dtype
                job = jobs[uid]
                payload = (
                    [cast(job[1])]
                    if msg_type == "forward"
                    else [cast(job[1]), cast(job[4])]
                )
                tensors, _ = await pool.rpc(
                    msg_type, payload, meta, timeout=rpc_timeout
                )
            return {uid: tensors}

        async def call_group(endpoint, uids) -> dict:
            """Returns uid -> reply tensors (None for failed parts)."""
            if len(uids) == 1:
                return await call_single(endpoint, uids[0])
            n_payload = 1 if msg_type == "forward" else 2
            parts = []
            for uid in uids:
                part = {"uid": uid, "n_tensors": n_payload}
                if msg_type == "backward":
                    part["n_inputs"] = 1
                parts.append(part)
            multi_meta = {"op": msg_type, "parts": parts}
            if trace is not None:
                multi_meta["trace"] = trace
            pool = registry.get(endpoint)
            if prepared is not None:
                from learning_at_home_tpu_torch.utils.serialization import (
                    WireTensors,
                )

                # spec/blob reference concat — the per-uid buffers packed
                # once on the host thread serve the merged request as-is.
                # One codec per endpoint (prepared enforces it), so the
                # merged wire meta is the first uid's form with the
                # per-tensor headers concatenated in parts order.
                wire = WireTensors.concat(
                    [prepared[uid][0] for uid in uids]
                )
                wmeta = prepared[uids[0]][1]
                if isinstance(wmeta, dict):
                    wmeta = {
                        "c": wmeta["c"],
                        "h": [
                            h for uid in uids for h in prepared[uid][1]["h"]
                        ],
                    }
                if wmeta is not None:
                    # same contract as call_single: the codec selector
                    # only prepares dict wire forms for endpoints whose
                    # hello negotiated "codec", so the supports() gate
                    # sits upstream of this merged-call path
                    # lah-lint: ignore[R14]
                    multi_meta["wire"] = wmeta
                reply_tensors, reply_meta = await pool.rpc_prepared(
                    "multi", wire, multi_meta, timeout=rpc_timeout
                )
            else:
                if self.wire_dtype is not None:
                    multi_meta["wire"] = self.wire_dtype
                payload = []
                for uid in uids:
                    job = jobs[uid]
                    payload.extend(
                        [cast(job[1])]
                        if msg_type == "forward"
                        else [cast(job[1]), cast(job[4])]
                    )
                reply_tensors, reply_meta = await pool.rpc(
                    "multi", payload, multi_meta, timeout=rpc_timeout
                )
            # reply meta is peer-supplied: any structural lie fails the
            # whole group (equivalent to a failed RPC), never misbinds
            rparts = reply_meta.get("parts")
            if not isinstance(rparts, list) or len(rparts) != len(uids):
                raise RemoteCallError(f"{endpoint}: malformed multi reply")
            out, off = {}, 0
            for uid, rp in zip(uids, rparts):
                if not isinstance(rp, dict) or rp.get("uid") != uid:
                    raise RemoteCallError(
                        f"{endpoint}: multi reply part order mismatch"
                    )
                if rp.get("ok"):
                    n = rp.get("n_tensors")
                    if (
                        not isinstance(n, int) or n < 0
                        or off + n > len(reply_tensors)
                    ):
                        raise RemoteCallError(
                            f"{endpoint}: multi reply tensor counts lie"
                        )
                    out[uid] = reply_tensors[off : off + n]
                    off += n
                else:
                    logger.warning(
                        "%s multi part for %s failed at %s: %s",
                        msg_type, uid, endpoint, rp.get("message"),
                    )
                    out[uid] = None
            if off != len(reply_tensors):
                raise RemoteCallError(
                    f"{endpoint}: multi reply parts cover {off} tensors, "
                    f"reply has {len(reply_tensors)}"
                )
            return out

        # ---- hedged replica fallback (ISSUE 8; forward only) ----

        def _cancel_with(task, e: asyncio.CancelledError) -> None:
            """Forward an outer cancellation (quorum straggler marker or
            unmarked teardown) to a hedge leg unchanged, so the pool's
            RTT-EMA marker semantics survive the extra wrapper layer."""
            if task is not None and not task.done():
                msg = e.args[0] if e.args else None
                if msg is not None:
                    task.cancel(msg=msg)
                else:
                    task.cancel()

        def _hedge_delay(endpoint) -> Optional[float]:
            """RTT-EMA-derived hedge deadline for one primary; None (no
            timed hedge, fast-failure failover only) until the pool has
            any latency measurement to scale from."""
            pool = registry.peek(endpoint)
            if pool is None or pool.rtt_ema is None:
                return None
            return max(self.hedge_mult * pool.rtt_ema, self.hedge_floor_s)

        async def _hedge_wire_ok(backup_ep, uids) -> bool:
            """The hedge resends the SAME prepared bytes; a quantized
            (dict-form) payload needs the backup pool to have negotiated
            the ``codec`` feature — re-encoding on this loop is exactly
            what the pack-once contract forbids."""
            if prepared is None:
                return True
            if not any(isinstance(prepared[u][1], dict) for u in uids):
                return True
            pool = registry.get(backup_ep)
            try:
                await pool.ensure_negotiated(timeout=min(rpc_timeout, 5.0))
            except Exception:
                return False
            return pool.supports("codec")

        def _common_backup(uids):
            """The group's backup endpoint: hedging is per fate-shared
            group, so all its uids must agree on one backup replica host
            (disaggregated retries are single-uid groups and always
            qualify when a backup exists)."""
            if backups is None or msg_type != "forward" or self.hedge_mult <= 0:
                return None
            eps = {backups.get(uid) for uid in uids}
            backup = eps.pop() if len(eps) == 1 else None
            return backup

        async def run_group(endpoint, uids) -> tuple[dict, tuple]:
            """One group's exchange with hedged fallback.  Returns
            ``(uid → reply tensors, winner endpoint)`` — the winner is
            what the backward session must target."""
            t1 = asyncio.ensure_future(call_group(endpoint, uids))
            backup = _common_backup(uids)
            if backup is None:
                try:
                    return await t1, endpoint
                except asyncio.CancelledError as e:
                    _cancel_with(t1, e)
                    raise
            t2 = None
            try:
                primary_exc = None
                await asyncio.wait({t1}, timeout=_hedge_delay(endpoint))
                if t1.done():
                    primary_exc = t1.exception()
                    if primary_exc is None:
                        # awaiting a finished task yields its result
                        # without touching the loop (lint-clean R2 form)
                        return await t1, endpoint
                # the primary exceeded its hedge deadline (or failed
                # outright): fire the backup replica, first reply wins
                if not await _hedge_wire_ok(backup, uids):
                    self._hedge_skipped(backup)
                    if primary_exc is not None:
                        raise primary_exc
                    return await t1, endpoint
                self._arm_hedge(endpoint, backup)
                t2 = asyncio.ensure_future(call_group(backup, uids))
                racing = {t2} if primary_exc is not None else {t1, t2}
                last_exc = primary_exc
                while racing:
                    done, racing = await asyncio.wait(
                        racing, return_when=asyncio.FIRST_COMPLETED
                    )
                    winner = next(
                        (
                            t for t in done
                            if not t.cancelled() and t.exception() is None
                        ),
                        None,
                    )
                    if winner is t2:
                        # first-reply-wins, backup took it: cancel the
                        # loser primary WITH the straggler marker — it
                        # exceeded its hedge deadline, so the elapsed
                        # wait IS slowness evidence for its RTT EMA
                        self.hedge_wins += 1
                        if not t1.done():
                            t1.cancel(msg=QUORUM_STRAGGLER_CANCEL)
                        return await t2, backup
                    if winner is t1:
                        # the primary answered after the hedge fired:
                        # cancel the loser backup UNMARKED — its short
                        # unfinished wait says nothing about the peer
                        # and must not poison its RTT EMA
                        if not t2.done():
                            t2.cancel()
                        return await t1, endpoint
                    for t in done:
                        if not t.cancelled() and t.exception() is not None:
                            last_exc = t.exception()
                if last_exc is not None:
                    raise last_exc
                raise RemoteCallError(
                    f"{endpoint}: hedged {msg_type} group failed"
                )
            except asyncio.CancelledError as e:
                # outer cancel (quorum grace / teardown): forward the
                # SAME marker to both legs so straggler evidence folds
                # exactly as it would without the hedge layer
                _cancel_with(t1, e)
                _cancel_with(t2, e)
                raise

        async def _rescue_single(failed_ep, uid) -> tuple[dict, tuple]:
            """Sole-endpoint rescue (ISSUE 11): a NON-replicated uid has
            no hedge backup, so when its only endpoint hard-fails inside
            the record-TTL window the sample would lose the expert
            outright.  One cache-bypassing refresh — record cache AND
            alive-set cache both skipped (``get_alive_experts_fresh``) —
            re-resolves the uid (a restarted/migrated host re-declares
            within a heartbeat), and the SAME prepared payload retries
            once at the fresh endpoint."""
            self.fresh_retries += 1
            alive = await self.alive_cache.get(force_refresh=True)
            entry = alive.get(uid)
            fresh_ep = None
            if entry is not None:
                fresh_ep = next(
                    (
                        ep for ep in as_replica_set(entry)
                        if tuple(ep) != tuple(failed_ep)
                    ),
                    None,
                )
            if fresh_ep is None:
                raise RemoteCallError(
                    f"{uid}: sole endpoint {failed_ep} failed and the "
                    f"fresh lookup found no replacement"
                )
            if not await _hedge_wire_ok(fresh_ep, [uid]):
                raise RemoteCallError(
                    f"{uid}: fresh endpoint {fresh_ep} cannot accept "
                    f"the prepared wire form"
                )
            replies = await call_single(fresh_ep, uid)
            self.fresh_retry_wins += 1
            return replies, fresh_ep

        pending = {
            asyncio.ensure_future(run_group(ep, uids)): (ep, uids)
            for ep, uids in group_list
        }
        retried: set = set()  # endpoints whose merged call was disaggregated
        rescued: set = set()  # uids given their one sole-endpoint rescue
        rows_of = {uid: job[2] for uid, job in jobs.items()}
        per_sample = np.zeros(batch, np.int64)
        results = {uid: (*job, None) for uid, job in jobs.items()}
        deadline: Optional[float] = None
        while pending:
            timeout = None if deadline is None else max(0.0, deadline - loop.time())
            done, _ = await asyncio.wait(
                pending, timeout=timeout, return_when=asyncio.FIRST_COMPLETED
            )
            if not done:
                break  # grace period expired — drop stragglers
            for task in done:
                endpoint, uids = pending.pop(task)
                try:
                    # lah-lint: ignore[R2] task came out of asyncio.wait's
                    # done set — result() on a finished Task never blocks
                    group_replies, winner_ep = task.result()
                except Exception as e:
                    logger.warning(
                        "%s RPC to %s (%d experts) failed: %s: %s",
                        msg_type, endpoint, len(uids), type(e).__name__, e,
                    )
                    # a MERGED request is one fate-shared unit; a transient
                    # whole-group failure (reply drop, timeout) must not
                    # cost the per-expert independence the k-of-n quorum
                    # exploits — disaggregate ONCE into per-expert singles.
                    # FORWARD ONLY: backward applies the server-side
                    # optimizer step as a side effect, and a lost REPLY
                    # does not mean the request wasn't executed — a retry
                    # would apply the same gradients twice.  Failed
                    # backward groups just count as missing, exactly like
                    # the per-expert fan-out with no retry.
                    if (
                        msg_type == "forward"
                        and len(uids) > 1
                        and endpoint not in retried
                    ):
                        retried.add(endpoint)
                        for uid in uids:
                            # run_group so each retried single keeps its
                            # hedge backup (a merged-call failure is often
                            # the dying-primary case hedging exists for)
                            pending[
                                asyncio.ensure_future(
                                    run_group(endpoint, [uid])
                                )
                            ] = (endpoint, [uid])
                    elif (
                        msg_type == "forward"
                        and len(uids) == 1
                        and backups is not None
                        and backups.get(uids[0]) is None
                        and uids[0] not in rescued
                    ):
                        # non-replicated uid, sole endpoint dead: one
                        # fresh cache-bypassing re-resolution + retry
                        # instead of burning the sample's quorum slot
                        # on a stale record (ISSUE 11)
                        rescued.add(uids[0])
                        pending[
                            asyncio.ensure_future(
                                _rescue_single(endpoint, uids[0])
                            )
                        ] = (endpoint, [uids[0]])
                    continue
                for uid in uids:
                    tensors = group_replies.get(uid)
                    if tensors is None:
                        continue
                    # row-count check HERE, before the reply counts toward
                    # quorum: a fast wrong-shaped (buggy/malicious) reply
                    # must not arm the grace deadline and get honest
                    # stragglers cancelled (callers re-validate full shapes)
                    if not tensors or tensors[0].shape[0] != len(rows_of[uid]):
                        logger.warning(
                            "%s reply from %s has %s rows, expected %d — "
                            "treating as failed",
                            msg_type, uid,
                            tensors[0].shape[0] if tensors else "no",
                            len(rows_of[uid]),
                        )
                        continue
                    # the WINNER endpoint replaces the job's primary so
                    # the backward session targets the replica that
                    # actually evaluated this forward
                    results[uid] = (winner_ep, *jobs[uid][1:], tensors)
                    per_sample[rows_of[uid]] += 1
            if deadline is None:
                # arm the grace period once every sample is either quorate
                # or HOPELESS (even if all its still-pending RPCs landed it
                # could not reach quorum) — a crashed expert must not keep
                # the whole gather waiting on other samples' stragglers.
                # (A black-holed-but-pending RPC still counts as hope; the
                # hard bound for those is rpc_timeout.)
                still_possible = np.zeros(batch, np.int64)
                for _, uids in pending.values():
                    for uid in uids:
                        still_possible[rows_of[uid]] += 1
                settled = (per_sample >= quorum) | (
                    per_sample + still_possible < quorum
                )
                if settled.all():
                    deadline = loop.time() + self.timeout_after_k_min
        for task in pending:
            # explicit marker (NOT an elapsed-time heuristic): the pool
            # folds the straggler's elapsed wait into its RTT EMA however
            # short the configured grace period, while unmarked teardown
            # cancels are never mistaken for slowness (ADVICE r5 item 3)
            task.cancel(msg=QUORUM_STRAGGLER_CANCEL)
        return results


# ---- the autograd functions crossing the network ----
# They take and return host tensors (their callers move data with the
# differentiable ``.to``), so their backward, which blocks on the
# network, runs on the thread that called backward: autograd runs a node
# whose gradients lie on a card on its one worker thread for that card,
# which an expert server in the same process needs for its own backward.
# ``idx`` (int64) and ``mask`` (bool) take no gradient.


def _on(device, *tensors):
    return tuple(t.to(device) for t in tensors)


def _to_device(arr, like: torch.Tensor) -> torch.Tensor:
    return numpy_to_tensor(np.asarray(arr), like.device)


def _dispatch_outputs(moe, result, like):
    """(y, idx, mask) tensors of a host forward's (y, idx, mask, cid)."""
    y, idx, mask, cid = result
    return (_to_device(y, like), _to_device(idx.astype(np.int64), like),
            _to_device(mask, like), int(cid))


class _Dispatch(torch.autograd.Function):
    """``__call__``'s dispatch: the forward fan-out with the k-of-n quorum
    on the host, and its backward fan-out as the vjp.  The gradient to
    ``x`` comes back from the experts; the discrete choice contributes
    none to the logits (their gradient flows through the mixture)."""

    @staticmethod
    def forward(ctx, moe, store_session: bool, x, logits_concat):
        result = moe._host_forward(tensor_to_numpy(x),
                                   tensor_to_numpy(logits_concat),
                                   store_session=store_session)
        y, idx, mask, cid = _dispatch_outputs(moe, result, x)
        ctx.moe, ctx.cid = moe, cid
        ctx.mark_non_differentiable(idx, mask)
        return y, idx, mask

    @staticmethod
    def backward(ctx, gy, _gidx, _gmask):
        # the backward RPCs run whether or not x wants its gradient: they
        # are what steps the experts' optimizers
        gx = ctx.moe._host_backward(ctx.cid, tensor_to_numpy(gy))
        gx = _to_device(gx, gy) if ctx.needs_input_grad[2] else None
        return None, None, gx, None


class _FireOp(torch.autograd.Function):
    """``fire_op(x, logits) -> (token, handle)``: the fire half of the
    forward (selection, payload prep, non-blocking submit) returning an
    int32 ticket; ``token`` is ``x`` passed through so the graph keeps a
    float path from input to output.  Its backward JOINS the backward
    fan-out that :class:`_JoinOp`'s backward fired — the backward
    compute scheduled between them overlaps the grad RPCs exactly like
    the forward."""

    @staticmethod
    def forward(ctx, moe, store_session: bool, x, logits_concat):
        fid = moe._host_fire(tensor_to_numpy(x),
                             tensor_to_numpy(logits_concat),
                             store_session=store_session)
        handle = torch.tensor(int(fid), dtype=torch.int32)
        ctx.moe, ctx.fid = moe, int(fid)
        ctx.mark_non_differentiable(handle)
        return x.view_as(x), handle

    @staticmethod
    def backward(ctx, g_token, _g_handle):
        gx = ctx.moe._host_join_backward(ctx.fid, tensor_to_numpy(g_token))
        # token is an identity passthrough of x: any OTHER consumer's
        # cotangent (g_token — zeros in the fire/join pairing) adds to
        # the experts' input-gradient
        return None, None, _to_device(gx, g_token) + g_token, None


class _JoinOp(torch.autograd.Function):
    """``join_op(token, handle) -> (y, idx, mask)``: joins the ticket's
    fan-out — the SINGLE blocking point.  Its backward FIRES the backward
    fan-out and returns a zeros cotangent for ``token``, which orders
    :class:`_FireOp`'s joining backward after it."""

    @staticmethod
    def forward(ctx, moe, token, handle):
        y, idx, mask, cid = _dispatch_outputs(
            moe, moe._host_join(int(handle)), token)
        ctx.moe, ctx.cid = moe, cid
        ctx.mark_non_differentiable(idx, mask)
        return y, idx, mask

    @staticmethod
    def backward(ctx, gy, _gidx, _gmask):
        g_token = ctx.moe._host_fire_backward(ctx.cid, tensor_to_numpy(gy))
        return None, _to_device(g_token, gy), None
