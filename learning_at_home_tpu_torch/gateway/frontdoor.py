"""The gateway front door: framed-TCP serving process for generate
streams, plus the sync client that talks to it.

Speaks the SAME wire protocol as expert servers (utils/serialization.py
framing, ``hello`` → protocol v2 mux), so the existing
``ConnectionPool``/``PoolRegistry`` client stack works against a gateway
unchanged.  All gateway ops are meta-only control frames (token ids ride
in msgpack meta, never as tensors — a generate stream moves a few ints
per poll, not megabyte activations):

- ``gen_submit`` {prompt: [int], max_new_tokens, seed?, temperature?,
  top_p?, top_k?, trace?} → {"accepted": true, "sid", "trace"?} or
  {"accepted": false, "shed": true, "retry_after_s", "message"}
  (the four optional sampling fields select counter-based sampled
  decoding; all absent = greedy, the legacy wire shape unchanged.
  ``trace`` is an optional 16-hex stream trace id — a valid one is
  echoed and stamped on every lifecycle span, a malformed one is
  dropped, and with profiling on the gateway mints one itself)
- ``gen_poll``   {sid, cursor} → {"tokens": [int], "cursor", "done",
  "error"?, "trace"?} (tokens from ``cursor`` on; poll again from the
  returned cursor — replies are immediate, never held)
- ``gen_cancel`` {sid} → {"cancelled": bool}
- ``stats``      {} → gateway counters + the metrics registry snapshot

Invalid requests (unknown sid, malformed prompt, budget over capacity)
get an ``error`` frame; a SHED is a well-formed ``result`` with
``accepted=false`` — backpressure is an answer, not a failure
(docs/PROTOCOL.md "Gateway RPC family").

The serving loop (``lah-gateway`` BackgroundLoop) does admission reads,
stream-table reads/writes (short ``gateway.streams`` lock sections) and
framing only; prefill/decode compute and expert RPCs live on the
scheduler's ``lah-gw-decode`` thread (docs/CONCURRENCY.md).

The JAX package's front door with one addition: ``Gateway(device=)``
places the decoder (trunk, KV pool) on a device, the CUDA card unless
the caller passes ``device="cpu"``.  The wire and the ops are the JAX
package's, so a JAX ``GatewayClient`` drives a port ``Gateway`` and the
other way round.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

from learning_at_home_tpu_torch.gateway.admission import AdmissionController
from learning_at_home_tpu_torch.gateway.coalesce import ExpertCoalescer
from learning_at_home_tpu_torch.gateway.scheduler import SlotScheduler
from learning_at_home_tpu_torch.models.drafter import (
    NGramDrafter,
    TruncatedTrunkDrafter,
)
from learning_at_home_tpu_torch.models.sampling import SamplingParams
from learning_at_home_tpu_torch.models.swarm_decoder import SwarmKVDecoder
from learning_at_home_tpu_torch.utils import flight
from learning_at_home_tpu_torch.utils.asyncio_utils import BackgroundLoop
from learning_at_home_tpu_torch.utils.profiling import (
    new_trace_id,
    timeline,
    valid_trace_id,
)
from learning_at_home_tpu_torch.utils.slo import BurnRateSLO, SLOEvaluator
from learning_at_home_tpu_torch.utils.serialization import (
    WireTensors,
    pack_frames,
    peek_header,
    recv_frame,
    send_frame_parts,
    unpack_message,
)

logger = logging.getLogger(__name__)

# same negotiation surface as the expert server: mux so thousands of
# concurrent streams share connections; gateway frames are tiny control
# meta, so the quantized-codec feature is not offered
GATEWAY_FEATURES = ("mux",)


class Gateway:
    """Front-door serving process over one swarm model.

    Owns the whole serving stack: decoder (paged KV pool with
    shared-prefix reuse by default; ``kv_layout="dense"`` keeps the
    static slot table), coalescer (cross-user expert-set grouping),
    scheduler (continuous batching with chunked prefill on
    ``lah-gw-decode``), admission controller (slots, server queues AND
    free-page headroom), the
    ``lah-gateway`` serving loop, a metrics-registry collector, and —
    when a DHT handle is passed — a ``telemetry.<prefix>`` heartbeat with
    role ``gateway`` so ``lah_top`` renders it as a first-class peer.
    """

    def __init__(
        self,
        model,
        params,
        *,
        max_slots: int = 8,
        coalesce: bool = True,
        host: str = "127.0.0.1",
        port: int = 0,
        dht=None,
        telemetry_prefix: Optional[str] = None,
        max_pending: Optional[int] = None,
        max_server_queue: float = 64.0,
        stream_ttl_s: Optional[float] = None,
        kv_layout: str = "paged",
        page_len: Optional[int] = None,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        prefill_chunk_tokens: Optional[int] = None,
        spec_k: Optional[int] = None,
        spec_drafter: Optional[str] = None,
        device=None,
    ):
        self.model = model
        self.coalescer = ExpertCoalescer(coalesce=coalesce)
        if page_len is None:
            try:
                page_len = int(os.environ.get("LAH_GW_PAGE_LEN", "16"))
            except ValueError:
                page_len = 16
        # the gateway defaults to the paged layout (bounded by tokens in
        # flight, prefix reuse, chunked prefill); kv_layout="dense" keeps
        # the slot table as the bench/parity baseline
        self.decoder = SwarmKVDecoder(
            model, params, max_slots=max_slots,
            moe_dispatch=self.coalescer.dispatch,
            kv_layout=kv_layout, page_len=page_len, num_pages=num_pages,
            prefix_cache=prefix_cache, device=device,
        )
        # speculative decode: k drafted tokens verified per swarm
        # round-trip (LAH_GW_SPEC_K=0 keeps the token-at-a-time loop)
        if spec_k is None:
            try:
                spec_k = int(os.environ.get("LAH_GW_SPEC_K", "0"))
            except ValueError:
                spec_k = 0
        spec_k = max(0, int(spec_k))
        drafter = None
        if spec_k > 0:
            if spec_drafter is None:
                spec_drafter = os.environ.get(
                    "LAH_GW_SPEC_DRAFTER", "ngram"
                )
            if spec_drafter == "trunk":
                drafter = TruncatedTrunkDrafter(model, self.decoder.params)
            elif spec_drafter == "ngram":
                drafter = NGramDrafter()
            else:
                raise ValueError(
                    f"spec_drafter must be 'ngram' or 'trunk', got "
                    f"{spec_drafter!r}"
                )
        self.scheduler = SlotScheduler(
            self.decoder, stream_ttl_s=stream_ttl_s,
            prefill_chunk_tokens=prefill_chunk_tokens,
            spec_k=spec_k, drafter=drafter,
        )
        # stream traces nest the coalescer's client.dispatch.{fire,join}
        # spans under the submitting stream
        self.coalescer.trace_lookup = self.scheduler.trace_of
        # server-load feed: the MoE's own cost model already TTL-caches
        # the load.<prefix> heartbeats — reuse it instead of
        # growing a second DHT reader.  loads() blocks on the refresh
        # window, which is why admission polls it on its own thread.
        load_fn = (
            model.moes[0].cost_model.loads
            if getattr(model, "moes", None) else None
        )
        self.admission = AdmissionController(
            self.scheduler,
            max_pending=max_pending,
            max_server_queue=max_server_queue,
            load_fn=load_fn,
        )
        self._loop = BackgroundLoop(name="lah-gateway")
        self._server = None
        self.host = host
        try:
            self.port: int = self._loop.run(self._start(host, port), timeout=10)
        except BaseException:
            self._loop.shutdown()
            raise
        self.endpoint = (host, self.port)
        self.scheduler.start()
        self.admission.start()
        self.started_at = time.monotonic()
        from learning_at_home_tpu_torch.utils.metrics import registry

        self._collector_key = f"gateway-{id(self)}"
        registry.register_collector(self._collector_key, self._collect)
        # declarative TTFT SLO: the scheduler counts
        # first-token events against the target; burn-rate evaluation
        # runs at scrape time on the lah-metrics loop, and entering PAGE
        # dumps a flight-recorder artifact.  Env knobs exist so smokes
        # and operators can tighten without code changes.
        def _env_float(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, default))
            except ValueError:
                return default

        self.ttft_slo_target_s = _env_float("LAH_TTFT_SLO_S", 30.0)
        self.scheduler.ttft_target_s = self.ttft_slo_target_s
        self.slo = SLOEvaluator(component="gateway")
        sched = self.scheduler
        self.slo.register(
            BurnRateSLO(
                name="gateway_ttft",
                objective=min(
                    0.999999,
                    max(1e-6, _env_float("LAH_TTFT_SLO_OBJECTIVE", 0.99)),
                ),
                fast_window_s=_env_float("LAH_SLO_FAST_S", 60.0),
                slow_window_s=max(
                    _env_float("LAH_SLO_FAST_S", 60.0),
                    _env_float("LAH_SLO_SLOW_S", 600.0),
                ),
                description=(
                    f"TTFT <= {self.ttft_slo_target_s:g}s for the "
                    "objective fraction of streams"
                ),
            ),
            lambda: (
                sched.ttft_events_total - sched.ttft_slow_total,
                sched.ttft_slow_total,
            ),
        )
        self._slo_collector_key = f"slo-gateway-{id(self)}"
        registry.register_collector(self._slo_collector_key, self.slo.collect)
        self.telemetry = None
        if dht is not None:
            from learning_at_home_tpu_torch.utils.telemetry import (
                TelemetryPublisher,
            )

            self.telemetry = TelemetryPublisher(
                dht,
                prefix=telemetry_prefix or model.cfg.telemetry_prefix,
                role="gateway",
                host=host,
                meta={"gateway_port": self.port},
                extra_fn=lambda: {"gateway": self.gateway_stats()},
            ).start()

    # ---- lifecycle ----

    async def _start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(
            self._handle_connection, host, port
        )
        return self._server.sockets[0].getsockname()[1]

    def shutdown(self) -> None:
        from learning_at_home_tpu_torch.utils.metrics import registry

        registry.unregister_collector(self._collector_key)
        registry.unregister_collector(self._slo_collector_key)
        if self.telemetry is not None:
            self.telemetry.stop()
            self.telemetry = None
        self.admission.stop()
        self.scheduler.shutdown()
        if self._server is not None:
            self._loop.loop.call_soon_threadsafe(self._server.close)
            self._server = None
        self._loop.shutdown()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ---- observability ----

    def gateway_stats(self) -> dict:
        return {
            **self.scheduler.stats(),
            **self.admission.stats(),
            **self.coalescer.stats(),
            "uptime_s": time.monotonic() - self.started_at,
        }

    def _collect(self) -> dict:
        s = self.scheduler
        out = {
            "lah_gateway_streams_total": s.streams_total,
            "lah_gateway_streams_finished_total": s.streams_finished_total,
            "lah_gateway_streams_errored_total": s.streams_errored_total,
            "lah_gateway_streams_cancelled_total": s.streams_cancelled_total,
            "lah_gateway_streams_active": s.active_count(),
            "lah_gateway_slots": self.decoder.max_slots,
            "lah_gateway_slots_in_use": s.slots_in_use(),
            "lah_gateway_tokens_total": s.tokens_total,
            "lah_gateway_shed_total": self.admission.shed_total,
            "lah_gateway_shed_pages_total": self.admission.shed_pages_total,
            "lah_gateway_group_dispatches_total":
                self.coalescer.group_dispatches_total,
            "lah_gateway_coalesced_dispatches_total":
                self.coalescer.coalesced_dispatches_total,
            "lah_gateway_step_time_ema_s": s.step_time_ema or 0.0,
            "lah_gateway_preemptions_total": s.preemptions_total,
            "lah_gateway_prefill_chunks_total":
                self.decoder.prefill_chunks_total,
            "lah_gateway_spec_k": s.spec_k if s.speculative else 0,
            "lah_gateway_spec_rounds_total": s.spec_rounds_total,
            "lah_gateway_spec_proposed_total": s.spec_proposed_total,
            "lah_gateway_spec_accepted_total": s.spec_accepted_total,
            "lah_gateway_spec_tokens_total": s.spec_tokens_total,
            "lah_gateway_spec_draft_seconds_total":
                s.spec_draft_seconds_total,
            "lah_gateway_spec_verify_seconds_total":
                s.spec_verify_seconds_total,
        }
        kv = self.decoder.kv
        if kv is not None:
            out.update({
                "lah_gateway_kv_pages_total": kv.pages_total(),
                "lah_gateway_kv_pages_used": kv.pages_used(),
                "lah_gateway_kv_pages_reclaimable": kv.pages_reclaimable(),
                "lah_gateway_kv_page_len": kv.page_len,
                "lah_gateway_prefix_hits_total": kv.prefix_hits_total,
                "lah_gateway_prefix_hit_tokens_total":
                    kv.prefix_hit_tokens_total,
                "lah_gateway_cow_copies_total": kv.cow_copies_total,
                "lah_gateway_kv_pages_reclaimed_total":
                    kv.pages_reclaimed_total,
                "lah_gateway_kv_rollback_pages_total":
                    kv.rollback_pages_total,
            })
        return out

    # ---- the serving loop (lah-gateway) ----

    async def _handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = writer.get_extra_info("peername")
        muxed = False
        wlock = asyncio.Lock()
        inflight: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    payload = await recv_frame(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                try:
                    msg_type, rid = peek_header(payload)
                except Exception:
                    msg_type, rid = None, None
                if msg_type == "hello":
                    # peer-supplied hello: non-map meta / non-list offer
                    # negotiates the empty set, never a torn connection
                    try:
                        _, _, hmeta = unpack_message(payload)
                        offered = hmeta.get("features")
                    except Exception:
                        offered = None
                    if not isinstance(offered, list):
                        offered = []
                    common = [f for f in GATEWAY_FEATURES if f in offered]
                    muxed = "mux" in common
                    await self._send(
                        writer, wlock,
                        pack_frames(
                            "hello_ok", WireTensors.prepare(),
                            {"features": common}, rid=rid,
                        ),
                    )
                    continue
                if muxed and rid is not None:
                    task = asyncio.get_running_loop().create_task(
                        self._serve_muxed(payload, rid, writer, wlock)
                    )
                    inflight.add(task)
                    task.add_done_callback(inflight.discard)
                    continue
                await self._send(writer, wlock, self._dispatch(payload, rid))
        except Exception:
            logger.exception("gateway connection failed for peer %s", peer)
        finally:
            for task in inflight:
                task.cancel()
            writer.close()

    @staticmethod
    async def _send(writer, wlock: asyncio.Lock, parts: list) -> None:
        async with wlock:
            await send_frame_parts(writer, parts)

    async def _serve_muxed(
        self, payload: bytes, rid: int, writer, wlock: asyncio.Lock
    ) -> None:
        try:
            await self._send(writer, wlock, self._dispatch(payload, rid))
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("gateway muxed request %d failed", rid)

    # sync, not async: every op below is dict/lock bookkeeping — the
    # blocking compute lives on lah-gw-decode, never on this loop
    def _dispatch(self, payload: bytes, rid=None) -> list:
        def reply(msg_type: str, meta=None) -> list:
            return pack_frames(
                msg_type, WireTensors.prepare(), meta, rid=rid
            )

        try:
            msg_type, _tensors, meta = unpack_message(payload)
        except Exception as e:
            return reply("error", {"message": f"malformed request: {e}"})
        try:
            if msg_type == "gen_submit":
                return reply("result", self._gen_submit(meta))
            elif msg_type == "gen_poll":
                sid = meta.get("sid")
                out = self.scheduler.poll(
                    sid if isinstance(sid, str) else "",
                    int(meta.get("cursor") or 0),
                )
                if out is None:
                    return reply(
                        "error", {"message": f"unknown stream {sid!r}"}
                    )
                if out["error"] is None:
                    del out["error"]
                return reply("result", out)
            elif msg_type == "gen_cancel":
                sid = meta.get("sid")
                cancelled = self.scheduler.cancel(
                    sid if isinstance(sid, str) else ""
                )
                return reply("result", {"cancelled": cancelled})
            elif msg_type == "stats":
                from learning_at_home_tpu_torch.utils.metrics import registry

                return reply(
                    "result",
                    {"gateway": self.gateway_stats(),
                     "metrics": registry.snapshot()},
                )
            else:
                return reply(
                    "error",
                    {"message": f"unknown message type {msg_type!r}"},
                )
        except Exception as e:
            logger.exception("gateway request %s failed", msg_type)
            return reply("error", {"message": f"{type(e).__name__}: {e}"})

    def _gen_submit(self, meta: dict) -> dict:
        # per-stream trace id: echo a structurally valid
        # client-supplied id, mint one only while profiling is on (the
        # disabled path stays allocation-free), drop anything malformed
        trace = meta.get("trace")
        if not valid_trace_id(trace):
            trace = None
        if trace is None and timeline.enabled:
            trace = new_trace_id()
        prompt = meta.get("prompt")
        max_new = meta.get("max_new_tokens")
        vocab = self.model.cfg.vocab_size
        if not (
            isinstance(prompt, (list, tuple))
            and prompt
            and all(
                isinstance(t, int) and not isinstance(t, bool)
                and 0 <= t < vocab for t in prompt
            )
        ):
            raise ValueError(
                "prompt must be a non-empty list of token ids in "
                f"[0, {vocab})"
            )
        if (
            not isinstance(max_new, int) or isinstance(max_new, bool)
            or max_new < 1
        ):
            raise ValueError("max_new_tokens must be a positive int")
        # optional counter-based sampling fields — any present field
        # turns the stream sampled; hostile values (bools, NaN, out of
        # range) become well-formed error frames, never decoder state
        sampling = None
        seed = meta.get("seed")
        temperature = meta.get("temperature")
        top_p = meta.get("top_p")
        top_k = meta.get("top_k")
        if any(v is not None for v in (seed, temperature, top_p, top_k)):
            if seed is None:
                seed = 0
            if not isinstance(seed, int) or isinstance(seed, bool):
                raise ValueError("seed must be an int")
            if temperature is None:
                temperature = 0.0
            if isinstance(temperature, bool) or not isinstance(
                temperature, (int, float)
            ):
                raise ValueError("temperature must be a number")
            if top_p is None:
                top_p = 1.0
            if isinstance(top_p, bool) or not isinstance(
                top_p, (int, float)
            ):
                raise ValueError("top_p must be a number")
            if top_k is None:
                top_k = 0
            if not isinstance(top_k, int) or isinstance(top_k, bool):
                raise ValueError("top_k must be an int")
            # range validation (finite temperature >= 0, top_p in
            # (0, 1], top_k >= 0, seed in [0, 2**63)) lives in
            # SamplingParams and raises ValueError too
            sampling = SamplingParams(
                seed=seed, temperature=float(temperature),
                top_p=float(top_p), top_k=top_k,
            )
        # an over-long prompt is a well-formed error frame BEFORE the
        # stream table sees it — it must never reach the decode thread,
        # where it could only crash prefill or wedge the pending queue
        capacity = self.decoder.seq_len - len(prompt)
        if capacity < 1:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no decode capacity "
                f"(cache holds {self.decoder.seq_len} positions)"
            )
        max_new = min(max_new, capacity)
        # k-aware slot accounting: a speculative stream's peak page use
        # includes up to spec_k lookahead positions past its budget
        # (rolled back after rejection, but mapped at the peak)
        spec_k = (
            self.scheduler.spec_k if self.scheduler.speculative else 0
        )
        pages_needed = self.decoder.pages_needed(
            len(prompt), max_new + spec_k
        )
        if (
            self.decoder.kv is not None
            and self.decoder.pages_needed(len(prompt) + 1)
            > self.decoder.kv.pages_total()
        ):
            raise ValueError(
                f"prompt needs {self.decoder.pages_needed(len(prompt) + 1)}"
                f" KV pages but the pool holds "
                f"{self.decoder.kv.pages_total()}"
            )
        with timeline.span("gateway.admit", trace=trace):
            accepted, retry_after_s, reason = self.admission.admit(
                pages_needed=pages_needed
            )
        if not accepted:
            flight.record(
                "gateway", "shed", reason=reason,
                retry_after_s=retry_after_s, pages_needed=pages_needed,
            )
            out = {
                "accepted": False,
                "shed": True,
                "retry_after_s": retry_after_s,
                "message": reason,
            }
            if trace is not None:
                out["trace"] = trace
            return out
        sid = self.scheduler.submit(
            prompt, max_new, sampling=sampling, trace=trace
        )
        out = {"accepted": True, "sid": sid}
        if trace is not None:
            out["trace"] = trace
        return out


class GatewayClient:
    """Sync client over the shared RPC stack (control-plane ``rpc()`` on
    the ``lah-client`` loop — gateway frames are tiny meta maps)."""

    def __init__(self, endpoint, timeout: float = 30.0):
        self.endpoint = (endpoint[0], int(endpoint[1]))
        self.timeout = timeout

    def _rpc(self, msg_type: str, meta: dict) -> dict:
        from learning_at_home_tpu_torch.client.rpc import client_loop, pool_registry

        pool = pool_registry().get(self.endpoint)
        _tensors, reply = client_loop().run(
            pool.rpc(msg_type, meta=meta, timeout=self.timeout),
            timeout=self.timeout + 5,
        )
        return reply or {}

    def submit(self, prompt, max_new_tokens: int, *,
               seed=None, temperature=None, top_p=None,
               top_k=None, trace=None) -> dict:
        """One admission attempt; the reply is either accepted ({sid}) or
        a shed ({shed, retry_after_s}).  Raises RemoteCallError only for
        INVALID requests — backpressure is a normal reply.  The sampling
        kwargs ride as optional gen_submit fields (all None = greedy,
        and the wire frame carries no sampling keys at all).  ``trace``
        optionally carries a caller-minted 16-hex trace id; the gateway
        echoes it in the reply and stamps it on every lifecycle span."""
        meta = {
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
        }
        if seed is not None:
            meta["seed"] = int(seed)
        if temperature is not None:
            meta["temperature"] = float(temperature)
        if top_p is not None:
            meta["top_p"] = float(top_p)
        if top_k is not None:
            meta["top_k"] = int(top_k)
        if trace is not None:
            meta["trace"] = str(trace)
        return self._rpc("gen_submit", meta)

    def poll(self, sid: str, cursor: int = 0) -> dict:
        return self._rpc("gen_poll", {"sid": sid, "cursor": int(cursor)})

    def cancel(self, sid: str) -> bool:
        return bool(self._rpc("gen_cancel", {"sid": sid}).get("cancelled"))

    def stats(self) -> dict:
        return self._rpc("stats", {})

    def generate(
        self,
        prompt,
        max_new_tokens: int,
        *,
        poll_interval_s: float = 0.005,
        deadline_s: float = 120.0,
        on_token=None,
        seed=None,
        temperature=None,
        top_p=None,
        top_k=None,
    ) -> dict:
        """Submit once and poll to completion.  Returns
        ``{"tokens", "shed", "retry_after_s"?, "error"?}`` — a shed
        returns immediately (open-loop callers own the retry policy)."""
        sub = self.submit(
            prompt, max_new_tokens,
            seed=seed, temperature=temperature, top_p=top_p, top_k=top_k,
        )
        if not sub.get("accepted"):
            return {
                "tokens": [],
                "shed": True,
                "retry_after_s": sub.get("retry_after_s"),
            }
        sid = sub["sid"]
        tokens: list[int] = []
        cursor = 0
        deadline = time.monotonic() + deadline_s
        while True:
            out = self.poll(sid, cursor)
            fresh = out.get("tokens") or []
            if fresh:
                tokens.extend(int(t) for t in fresh)
                cursor = int(out.get("cursor") or cursor + len(fresh))
                if on_token is not None:
                    for _ in fresh:
                        on_token(time.monotonic())
            if out.get("done"):
                result = {"tokens": tokens, "shed": False}
                if out.get("error") is not None:
                    result["error"] = out["error"]
                return result
            if time.monotonic() > deadline:
                self.cancel(sid)
                return {"tokens": tokens, "shed": False,
                        "error": "client deadline exceeded"}
            time.sleep(poll_interval_s)
