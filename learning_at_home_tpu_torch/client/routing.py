"""Expert discovery sources + top-k selection for the DMoE client.

The reference client finds alive experts via DHT prefix beam search
(``first_k_active``-style, ``hivemind/client/moe.py`` — SURVEY.md §2;
unverifiable refs, mount empty).  This module defines the *source*
interface both the DHT (M2) and a static in-process table implement, plus
the batched per-sample top-k scoring used by RemoteMixtureOfExperts.

Expert UIDs are grid-structured: ``{prefix}.{i1}.{i2}...{in}`` for an
n-dimensional grid (e.g. ``ffn.4.17``), matching the reference's
multi-dimensional gating.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Any, Callable, Iterable, Optional, Protocol, Sequence

import numpy as np

from learning_at_home_tpu_torch.utils import sanitizer
from learning_at_home_tpu_torch.utils.connection import Endpoint

logger = logging.getLogger(__name__)

# Clock seam: alive-set and load/link feed TTL stamps read time through
# here so sim/clock.py can virtualize them (docs/SIMULATION.md).
_monotonic = time.monotonic

UID_DELIMITER = "."

# A replica set: every endpoint currently hosting one expert uid, in a
# deterministic order.  Alive-map values are EITHER a bare (host, port)
# endpoint (single-hoster uid — the historical form every existing
# consumer understands) OR a tuple of endpoints once an expert gained
# DHT-advertised replicas; ``as_replica_set`` normalizes both.
ReplicaSet = tuple[Endpoint, ...]


def as_replica_set(value) -> ReplicaSet:
    """Normalize an alive-map value to a tuple of endpoints.

    ``("10.0.0.1", 9000)`` → a 1-tuple; an iterable of endpoints passes
    through deduplicated with order preserved (the resolver's order is
    deterministic, so two clients see the same replica list).  Malformed
    entries inside a set are dropped rather than raised — alive maps are
    peer-supplied."""
    if (
        isinstance(value, (tuple, list))
        and len(value) == 2
        and isinstance(value[0], str)
        and not isinstance(value[1], (tuple, list))
    ):
        return ((value[0], int(value[1])),)
    out: list[Endpoint] = []
    seen = set()
    for ep in value:
        try:
            ep = (ep[0], int(ep[1]))
        except (TypeError, ValueError, IndexError):
            continue
        if not isinstance(ep[0], str) or ep in seen:
            continue
        seen.add(ep)
        out.append(ep)
    return tuple(out)


def endpoint_key(endpoint: Endpoint) -> str:
    """The ``host:port`` string form used as DHT subkey for per-endpoint
    records (replica advertisement, load heartbeats)."""
    return f"{endpoint[0]}:{endpoint[1]}"


def make_uid(prefix: str, coords: Sequence[int]) -> str:
    return UID_DELIMITER.join([prefix, *map(str, coords)])


def split_uid(uid: str, n_dims: Optional[int] = None) -> tuple[str, tuple[int, ...]]:
    """Split a grid uid into (prefix, coords).

    With ``n_dims`` given, exactly the last n_dims components are coords —
    required when the prefix itself may contain numeric segments (e.g.
    ``block.3.1.2`` with prefix ``block.3``).  Without it, all trailing
    numeric components are treated as coords (greedy; fine for display).
    """
    parts = uid.split(UID_DELIMITER)
    if n_dims is not None:
        if len(parts) <= n_dims or not all(p.isdigit() for p in parts[-n_dims:]):
            raise ValueError(f"uid {uid!r} does not end in {n_dims} grid coords")
        coords = tuple(int(p) for p in parts[-n_dims:])
        return UID_DELIMITER.join(parts[:-n_dims]), coords
    coords_rev = []
    while parts and parts[-1].isdigit():
        coords_rev.append(int(parts.pop()))
    return UID_DELIMITER.join(parts), tuple(reversed(coords_rev))


def filter_valid_uids(
    uids: Iterable[str], prefix: str, grid_size: Sequence[int]
) -> list[str]:
    """Keep only uids of the exact form prefix.c1...cn with coords in-grid.

    DHT alive-sets are peer-supplied; a malformed or out-of-range uid must
    not crash routing (IndexError in score_experts) or skew selection."""
    out = []
    n_dims = len(grid_size)
    for uid in uids:
        try:
            p, coords = split_uid(uid, n_dims)
        except ValueError:
            continue
        if p == prefix and all(0 <= c < g for c, g in zip(coords, grid_size)):
            out.append(uid)
    return out


class ExpertSource(Protocol):
    """Anything that can enumerate alive experts and resolve endpoints."""

    async def get_alive_experts(
        self, prefix: str
    ) -> dict[str, Endpoint]:  # uid -> endpoint
        ...

    async def first_k_active(
        self, prefixes: Sequence[str], k: int
    ) -> dict[str, bool]:
        """Which of the given uid prefixes have ≥1 alive expert (beam search)."""
        ...


class StaticExpertSource:
    """Fixed uid→endpoint table (single-host tests, no DHT; [BJ] config 2)."""

    def __init__(self, experts: dict[str, Endpoint]):
        self.experts = dict(experts)

    @staticmethod
    def _matches(uid: str, prefix: str) -> bool:
        # full-component match: prefix "ffn" owns "ffn.3" but not "ffn2.3"
        return uid == prefix or uid.startswith(prefix + UID_DELIMITER)

    async def get_alive_experts(self, prefix: str) -> dict[str, Endpoint]:
        return {
            uid: ep for uid, ep in self.experts.items() if self._matches(uid, prefix)
        }

    async def first_k_active(self, prefixes, k) -> dict[str, bool]:
        out = {}
        for p in prefixes:
            out[p] = any(self._matches(uid, p) for uid in self.experts)
        return out


def _top_union(scores: np.ndarray, width: int) -> np.ndarray:
    """Union over the batch of each sample's top-``width`` column indices."""
    width = min(width, scores.shape[1])
    return np.unique(np.argpartition(-scores, width - 1, axis=1)[:, :width])


async def beam_search_alive(
    source: "ExpertSource",
    uid_prefix: str,
    logits_per_dim: Sequence[np.ndarray],
    grid_size: Sequence[int],
    beam_size: int,
) -> dict[str, Endpoint]:
    """Find alive experts for a batch WITHOUT fetching the whole grid.

    True per-dimension prefix walk (the reference's ``first_k_active``
    contract, SURVEY.md §3.1): starting from each sample's top
    ``beam_size`` first-dimension indices, at every intermediate level ask
    the DHT which candidate prefixes are active (one batched
    ``first_k_active``), keep only active ones, extend them with the next
    dimension's per-sample top indices, and prune the union to
    ``4·beam_size`` by best-over-batch score.  Only the deepest prefix
    level (leaf rows, which hold at most ``grid_size[-1]`` subkey records
    each) fetches endpoint records.  Total DHT reads are therefore
    O(beam · dims) — independent of grid volume, unlike enumerating a
    4096-expert top-level record.

    If an entire level's candidates turn out dead, that level is retried
    ONCE with all extensions of the surviving parent beam (capped at the
    same ``4·beam_size`` budget) — a dead row diverts the walk instead of
    ending it, while the fetch bound stays O(beam · dims).  Beyond that
    cap the search is best-effort, exactly like the reference's bounded
    ``first_k_active`` scan.

    Returns uid → endpoint for the candidate set (callers re-score exactly).
    """
    n_dims = len(grid_size)
    width = beam_size
    union_cap = max(4 * beam_size, 8)

    def prefixes_of(coords_list: list[tuple[int, ...]]) -> list[str]:
        return [make_uid(uid_prefix, c) for c in coords_list]

    def prune(coords_list: list[tuple[int, ...]]) -> list[tuple[int, ...]]:
        if len(coords_list) <= union_cap:
            return coords_list
        best = score_experts(
            logits_per_dim, np.asarray(coords_list, dtype=np.int64)
        ).max(axis=0)
        keep = np.argsort(-best)[:union_cap]
        return [coords_list[i] for i in keep]

    def all_extensions(
        parent_beam: list[tuple[int, ...]], dim: int
    ) -> list[tuple[int, ...]]:
        """Every child of the parent beam along ``dim`` (root → whole dim 0)."""
        if not parent_beam:
            return [(i,) for i in range(grid_size[0])]
        return [p + (i,) for p in parent_beam for i in range(grid_size[dim])]

    def extend_top(
        beam: list[tuple[int, ...]], dim: int
    ) -> list[tuple[int, ...]]:
        """Union over the batch of per-sample top (prefix, next-index) pairs."""
        prev = np.asarray(beam, dtype=np.int64)  # [A, dim]
        base = score_experts(logits_per_dim, prev)  # [B, A]
        ext = base[:, :, None] + logits_per_dim[dim][:, None, :]  # [B, A, g]
        g = ext.shape[2]
        flat_idx = _top_union(ext.reshape(ext.shape[0], -1), width)
        return [tuple(prev[i // g]) + (int(i % g),) for i in flat_idx]

    async def active_subset(cands):
        prefixes = prefixes_of(cands)
        active = await source.first_k_active(prefixes, beam_size)
        return [c for c, p in zip(cands, prefixes) if active[p]]

    # depth-1 candidates: union over batch of per-sample top dim-0 indices
    cand = [(int(i),) for i in _top_union(logits_per_dim[0], width)]
    parent_beam: list[tuple[int, ...]] = []  # beam one level above cand

    # walk until cand are leaf-row prefixes (depth n_dims-1); every
    # intermediate level is pruned by an activity check first
    for depth in range(1, n_dims - 1):
        cand = prune(cand)
        alive_coords = await active_subset(cand)
        if not alive_coords:
            # the whole level looked dead: one capped retry over every
            # extension of the parent beam not already checked
            seen = set(cand)
            retry = prune(
                [c for c in all_extensions(parent_beam, depth - 1)
                 if c not in seen]
            )
            if retry:
                alive_coords = await active_subset(retry)
        if not alive_coords:
            return {}
        parent_beam = alive_coords
        cand = extend_top(alive_coords, depth)

    # cand are now leaf-row prefixes (each record holds ≤ grid_size[-1]
    # subkeys; for 1-D grids they are the full uids themselves —
    # DHT.get_alive_experts handles both)
    async def fetch(cands) -> dict[str, Endpoint]:
        records = await asyncio.gather(
            *(source.get_alive_experts(p) for p in prefixes_of(cands))
        )
        merged: dict[str, Endpoint] = {}
        for rec in records:
            merged.update(rec)
        return merged

    cand = prune(cand)
    alive = await fetch(cand)
    if not alive:
        # same one-shot capped reroute at the leaf level
        seen = set(cand)
        retry = prune(
            [c for c in all_extensions(parent_beam, n_dims - 2 if n_dims > 1 else 0)
             if c not in seen]
        )
        if retry:
            alive = await fetch(retry)
    valid = set(filter_valid_uids(alive, uid_prefix, grid_size))
    return {uid: ep for uid, ep in alive.items() if uid in valid}


class CachedAliveSet:
    """TTL cache over get_alive_experts — one discovery per window, not per
    batch (keeps routing off the dispatch hot path).

    ``swr`` (stale-while-revalidate, ISSUE 9): when the window expires,
    :meth:`get` serves the STALE set immediately and refreshes in a
    background loop task instead of blocking the dispatch on the
    discovery lookup.  Under churn a DHT lookup can stall behind
    dead-but-not-yet-evicted peers — with swr that cost never lands on
    the dispatch path, and the one-window staleness it trades for is
    exactly what the hedge/retry machinery already covers.  ON by
    default since ISSUE 11 (refreshes are cheap now: record cache +
    adaptive sub-second RPC timeouts); ``LAH_ALIVE_SWR=0`` or
    ``swr=False`` restores the blocking refresh — tests and chaos
    scenarios that reason about WHEN a kill becomes visible pin it.

    A ``force_refresh`` get always blocks on a fresh lookup, and asks a
    DHT-backed source to bypass its record cache too
    (``get_alive_experts_fresh``) — the authoritative read the dispatch
    retry path uses when a sole endpoint hard-fails."""

    def __init__(
        self,
        source: ExpertSource,
        prefix: str,
        ttl: float = 3.0,
        swr: Optional[bool] = None,
    ):
        self.source = source
        self.prefix = prefix
        self.ttl = ttl
        if swr is None:
            swr = os.environ.get("LAH_ALIVE_SWR", "1") != "0"
        self.swr = bool(swr)
        self._cached: Optional[dict[str, Endpoint]] = None
        self._stamp = 0.0
        self._refreshing: Optional[Any] = None  # in-flight background task
        self.stale_serves = 0
        self.refresh_failures = 0

    async def _fetch(self, fresh: bool = False) -> dict[str, Endpoint]:
        if fresh:
            fetch_fresh = getattr(self.source, "get_alive_experts_fresh", None)
            if fetch_fresh is not None:
                return await fetch_fresh(self.prefix)
        return await self.source.get_alive_experts(self.prefix)

    async def get(self, force_refresh: bool = False) -> dict[str, Endpoint]:
        now = _monotonic()
        stale = self._cached is None or now - self._stamp > self.ttl
        if not (force_refresh or stale):
            return self._cached
        if not self.swr or self._cached is None or force_refresh:
            # blocking refresh: first discovery (nothing to serve stale),
            # an explicit force, or swr disabled (the historical path).
            # Cancel any in-flight background refresh first: it started
            # EARLIER, so letting it complete after this authoritative
            # read could overwrite a fresher set with a staler one
            # (e.g. resurrecting a just-killed endpoint for a full TTL)
            if self._refreshing is not None and not self._refreshing.done():
                self._refreshing.cancel()
            self._refreshing = None
            self._cached = await self._fetch(fresh=force_refresh)
            self._stamp = _monotonic()
            return self._cached
        # stale-while-revalidate: hand back the stale set NOW; at most
        # one background refresh in flight (loop-confined state — this
        # coroutine and the task both run on the owning loop)
        if self._refreshing is None or self._refreshing.done():
            self._refreshing = asyncio.get_running_loop().create_task(
                self._refresh_bg(), name=f"alive-refresh-{self.prefix}"
            )
        self.stale_serves += 1
        return self._cached

    async def _refresh_bg(self) -> None:
        try:
            alive = await self._fetch()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # a failed background refresh keeps the stale set: routing
            # degrades gracefully, exactly like the load-feed reads
            self.refresh_failures += 1
            logger.debug("alive-set refresh for %s failed: %s: %s",
                         self.prefix, type(e).__name__, e)
            return
        self._cached = alive
        self._stamp = _monotonic()

    def peek_fresh(self) -> Optional[dict[str, Endpoint]]:
        """The cached alive set if still within TTL, else None — a pure
        sync read with no loop round-trip, so the fire half of a
        future-based dispatch only touches the client loop at all on the
        one-per-TTL-window refresh (a bounded control-plane lookup)."""
        if (
            self._cached is not None
            and _monotonic() - self._stamp <= self.ttl
        ):
            return self._cached
        return None


def score_experts(
    logits_per_dim: Sequence[np.ndarray], coords: np.ndarray
) -> np.ndarray:
    """Batched grid scores: sum of per-dimension gate logits.

    logits_per_dim: list over dims d of [batch, grid_d] arrays.
    coords: [n_experts, n_dims] integer grid coordinates.
    Returns [batch, n_experts].
    """
    scores = logits_per_dim[0][:, coords[:, 0]]
    for d in range(1, coords.shape[1]):
        scores = scores + logits_per_dim[d][:, coords[:, d]]
    return scores


def select_top_k(
    logits_per_dim: Sequence[np.ndarray],
    alive_uids: Sequence[str],
    k: int,
    bias: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-sample top-k over all alive experts (full enumeration).

    Exact and vectorized; fine up to ~10^4 alive experts per batch.  The
    DHT-backed beam search (M2/M4) replaces enumeration when the grid is
    large but only a fraction is alive or local.
    Returns (sel [batch, k] indices into alive_uids, coords [n, n_dims]).

    ``bias`` [len(alive_uids)] (optional): per-expert additive score
    adjustment applied to SELECTION only — the caller's combine weights
    still come from the clean gate scores (same selection-vs-weights
    split as router jitter).  Used for latency-aware routing.
    """
    n_dims = len(logits_per_dim)
    coords = np.asarray(
        [split_uid(uid, n_dims)[1] for uid in alive_uids], dtype=np.int64
    )
    scores = score_experts(logits_per_dim, coords)  # [B, E]
    if bias is not None:
        scores = scores + np.asarray(bias, scores.dtype)[None, :]
    n = scores.shape[1]
    k_eff = min(k, n)
    # argpartition then sort the head: O(E + k log k) per sample
    part = np.argpartition(-scores, k_eff - 1, axis=1)[:, :k_eff]
    order = np.take_along_axis(scores, part, axis=1).argsort(axis=1)[:, ::-1]
    sel = np.take_along_axis(part, order, axis=1)
    return sel, coords


# --------------------------------------------------------------------------
# latency-aware routing (ISSUE 8): predicted-completion-time cost model
# --------------------------------------------------------------------------

# Default selection-bias strength when latency-aware routing is enabled
# without an explicit weight (gate logits are O(1), so 5.0 makes a 100 ms
# predicted cost worth 0.5 logits — enough to flip near-ties, never enough
# to override a decisive gate preference).
DEFAULT_COST_WEIGHT = 5.0


class RoutingCostModel:
    """Scores alive experts by PREDICTED COMPLETION TIME and turns the
    prediction into a ``select_top_k(bias=...)`` penalty (cf. TA-MoE's
    topology-aware dispatch and MoETuner's placement-aware routing).

    Per endpoint, predicted cost (seconds) =

    - the pool's whole-exchange **RTT EMA** (network + peer queueing +
      compute — ``ConnectionPool.rtt_ema``), plus
    - **queue-depth cost**: the peer's DHT-advertised runtime queue depth
      (``load.<prefix>`` heartbeats, utils/telemetry.py) ×
      ``queue_cost_s`` per queued batch, plus
    - **estimated transfer time** of this dispatch's payload at the
      negotiated codec: encoded bytes / the pool's measured bytes-per-sec
      EMA (``bw_ema``; pools without a large-exchange measurement pay no
      transfer term rather than a guessed one).

    A uid's cost is the MINIMUM over its replica set (the dispatch will
    pick that cheapest replica), and endpoints with no signal at all cost
    0.0 — unmeasured peers stay attractive (exploration), exactly the old
    ``latency_weight`` semantics, so ``weight == latency_weight`` with no
    load feed and no bw measurement reproduces the historical bias
    bitwise.  ``weight == 0`` returns ``bias=None``: selection is then
    bitwise identical to the blind gate (the A/B contract).

    Placement/routing co-optimization (ISSUE 16): an optional
    ``link_getter`` feeds the swarm's published ``links.<prefix>`` RTT/
    bandwidth EMAs (utils/telemetry.py) in as a PRIOR for endpoints this
    process has never dialed — the same link-cost data the placement
    solver scores assignments on, so token routing and expert placement
    move on one view instead of fighting.  A local pool measurement
    always wins over the prior; with no getter the model is bitwise the
    pre-ISSUE-16 one.

    All lookups are plain dict/attribute reads on the calling host
    thread; the only I/O is the TTL-gated ``load_getter``/``link_getter``
    refresh (a bounded control-plane DHT read, mirroring the alive-set
    cache).
    """

    def __init__(
        self,
        weight: float = 0.0,
        *,
        registry=None,
        load_getter: Optional[Callable[[], dict]] = None,
        load_ttl: float = 3.0,
        queue_cost_s: Optional[float] = None,
        codec_ratio: float = 1.0,
        link_getter: Optional[Callable[[], dict]] = None,
        link_ttl: float = 10.0,
    ):
        self.weight = float(weight)
        self._registry = registry
        self._load_getter = load_getter
        self.load_ttl = load_ttl
        if queue_cost_s is None:
            try:
                queue_cost_s = float(
                    os.environ.get("LAH_ROUTING_QUEUE_COST_S", "0.005")
                )
            except ValueError:
                queue_cost_s = 0.005
        self.queue_cost_s = queue_cost_s
        # wire-bytes multiplier of the codec the dispatch will negotiate
        # (0.25 for the 8-bit codecs, 0.5 for bf16, 1.0 raw)
        self.codec_ratio = codec_ratio
        self._loads: dict = {}
        self._loads_stamp = 0.0
        self._link_getter = link_getter
        self.link_ttl = link_ttl
        self._links: dict = {}
        self._links_stamp = 0.0
        # observability: how many bias computations actually had signal
        self.bias_applied = 0
        self.load_refresh_failures = 0
        # co-optimization observability: predictions that fell back to a
        # swarm-published link prior (no local pool measurement yet)
        self.link_fallbacks = 0
        self.link_refresh_failures = 0

    def _pools(self):
        if self._registry is not None:
            return self._registry
        from learning_at_home_tpu_torch.client.rpc import pool_registry

        return pool_registry()

    def loads(self) -> dict:
        """endpoint-key ("host:port") → load record, TTL-refreshed via
        the getter (best-effort: a failed refresh keeps the stale map for
        one window and counts the failure)."""
        if self._load_getter is None:
            return self._loads
        now = _monotonic()
        if now - self._loads_stamp > self.load_ttl:
            self._loads_stamp = now  # stamp first: one refresh per window
            try:
                loads = self._load_getter()
                self._loads = loads if isinstance(loads, dict) else {}
            except Exception as e:
                self.load_refresh_failures += 1
                logger.debug("routing load refresh failed: %s: %s",
                             type(e).__name__, e)
        return self._loads

    def queue_depth(self, endpoint: Endpoint) -> Optional[float]:
        rec = self.loads().get(endpoint_key(endpoint))
        if isinstance(rec, dict):
            try:
                return float(rec.get("q"))
            except (TypeError, ValueError):
                return None
        return None

    def links(self) -> dict:
        """endpoint-key ("host:port") → ``{"rtt_s", "bw_bps"}`` from the
        swarm's published link records, TTL-refreshed like ``loads()``
        (stamp-first; a failed refresh keeps the stale map one window)."""
        if self._link_getter is None:
            return self._links
        now = _monotonic()
        if now - self._links_stamp > self.link_ttl:
            self._links_stamp = now
            try:
                links = self._link_getter()
                self._links = links if isinstance(links, dict) else {}
            except Exception as e:
                self.link_refresh_failures += 1
                logger.debug("routing link refresh failed: %s: %s",
                             type(e).__name__, e)
        return self._links

    def predicted_cost_s(
        self, endpoint: Endpoint, nbytes: int = 0
    ) -> Optional[float]:
        """Predicted completion time for one dispatch to ``endpoint``;
        None when there is NO signal (never contacted, no load record,
        no published link) — the caller treats that as cost 0
        (optimistic exploration)."""
        pool = self._pools().peek(endpoint)
        rtt = pool.rtt_ema if pool is not None else None
        bw = pool.bw_ema if pool is not None else None
        if rtt is None:
            # swarm link prior (ISSUE 16): other peers' measurements of
            # this endpoint, until the first local exchange lands
            link = self.links().get(endpoint_key(endpoint))
            if isinstance(link, dict):
                try:
                    rtt = float(link.get("rtt_s"))
                except (TypeError, ValueError):
                    rtt = None
                if rtt is not None:
                    self.link_fallbacks += 1
                    if bw is None:
                        lbw = link.get("bw_bps")
                        bw = float(lbw) if isinstance(
                            lbw, (int, float)
                        ) and lbw > 0 else None
        q = self.queue_depth(endpoint)
        transfer = None
        if nbytes > 0 and bw is not None and bw > 0:
            transfer = (nbytes * self.codec_ratio) / bw
        if rtt is None and q is None and transfer is None:
            return None
        return (
            (rtt or 0.0)
            + (q or 0.0) * self.queue_cost_s
            + (transfer or 0.0)
        )

    def order_replicas(
        self, replicas: ReplicaSet, nbytes: int = 0
    ) -> ReplicaSet:
        """Replica set sorted cheapest-first (the least-loaded pick; the
        second entry is the hedge backup).  Unmeasured replicas cost 0 —
        an unknown peer outranks a known-slow one — and exact ties break
        on the endpoint itself, so the order is deterministic."""
        if len(replicas) <= 1:
            return replicas
        return tuple(
            sorted(
                replicas,
                key=lambda ep: (self.predicted_cost_s(ep, nbytes) or 0.0, ep),
            )
        )

    @sanitizer.runs_on("host", site="routing.cost_bias")
    def bias(
        self,
        alive_uids: Sequence[str],
        replica_sets: dict,
        nbytes: int = 0,
    ) -> Optional[np.ndarray]:
        """The ``select_top_k`` bias vector: ``-weight × min-over-replica
        predicted cost`` per uid.  None when the weight is 0 (bias=None →
        selection bitwise identical to today's blind gate) or when no
        endpoint has any signal yet."""
        if not self.weight:
            return None
        bias = np.zeros(len(alive_uids), np.float32)
        any_signal = False
        for j, uid in enumerate(alive_uids):
            best = None
            for ep in replica_sets[uid]:
                cost = self.predicted_cost_s(ep, nbytes)
                if cost is not None and (best is None or cost < best):
                    best = cost
            if best is not None:
                bias[j] = -self.weight * best
                any_signal = True
        if not any_signal:
            return None
        self.bias_applied += 1
        return bias
