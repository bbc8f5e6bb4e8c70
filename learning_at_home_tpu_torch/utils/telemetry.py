"""Swarm telemetry rendezvous: publish + discover metrics endpoints via DHT.

The port's copy of ``learning_at_home_tpu/utils/telemetry.py``: the same
key families and values, so both packages' peers read each other's.

Every peer (expert server AND trainer) runs a :class:`MetricsHTTPServer`
(utils/metrics.py) and advertises it under the ``telemetry.<prefix>`` DHT
key family — subkey = peer id, value = ``[host, port, role]``, TTL'd like
expert heartbeats and averaging matchmaking records, so **record expiry
IS the dead-peer detector**.  ``tools/lah_top.py`` then needs only a DHT
bootstrap peer to find every live endpoint: no metrics endpoint is ever
passed on a CLI.

Key families (docs/PROTOCOL.md):

    telemetry.<prefix>        subkey=<peer_id>    -> [host, port, role]
    load.<prefix>             subkey="host:port"  -> {"q": queue depth,
                              "n": experts, "hot": {uid: depth EMA}}
    replicas.wanted.<prefix>  subkey=<uid>        -> [depth EMA, host, port]
    links.<prefix>            subkey=<src peer>   -> {"l": {"host:port":
                              [rtt_s, bw_bps|null]}}

``load.*`` is the server-side load heartbeat the client routing cost
model folds into expert selection: subkey is the RPC endpoint
so clients join it against alive-expert records without another lookup.
``replicas.wanted.*`` marks experts whose queue-depth EMA crossed the
hot threshold — the rebalancer (tools/lah_rebalance.py) reads it to
assign replicas to the least-loaded server.

``links.*`` is the swarm's measured link-cost map: each peer
that dials out (trainers, rebalancer, servers mid-handoff) piggybacks
its per-destination connection-pool RTT/bandwidth EMAs onto its
heartbeat.  The placement solver scores candidate expert assignments on
it and the client routing cost model uses it as a prior for endpoints
it has never dialed — placement and routing move on the same data.

``prefix`` scopes a swarm-wide view (default ``"swarm"``); running
several logical swarms over one DHT just means distinct prefixes —
the same scoping trick the averaging group keys use.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Any, Callable, Optional

from learning_at_home_tpu_torch.utils.asyncio_utils import BackgroundLoop
from learning_at_home_tpu_torch.utils.metrics import MetricsHTTPServer

logger = logging.getLogger(__name__)

Endpoint = tuple[str, int]

TELEMETRY_KEY_FAMILY = "telemetry"
DEFAULT_PREFIX = "swarm"


def telemetry_key(prefix: str = DEFAULT_PREFIX) -> str:
    return f"{TELEMETRY_KEY_FAMILY}.{prefix}"


LOAD_KEY_FAMILY = "load"
REPLICAS_WANTED_KEY_FAMILY = "replicas.wanted"


def load_key(prefix: str = DEFAULT_PREFIX) -> str:
    """Server load heartbeats: subkey = RPC ``host:port``, value a dict
    (``parse_load_value``).  Consumed by the client RoutingCostModel."""
    return f"{LOAD_KEY_FAMILY}.{prefix}"


def replicas_wanted_key(prefix: str = DEFAULT_PREFIX) -> str:
    """Hot-expert advertisements: subkey = expert uid, value
    ``[queue-depth EMA, host, port]`` of the overloaded hoster."""
    return f"{REPLICAS_WANTED_KEY_FAMILY}.{prefix}"


LINKS_KEY_FAMILY = "links"

# bounded fan-out per record: a peer advertises at most this many
# destination links (largest swarms would otherwise grow O(peers²)
# records); the measured ones sort first so the bound drops priors,
# never observations
MAX_ADVERTISED_LINKS = 16


def links_key(prefix: str = DEFAULT_PREFIX) -> str:
    """Measured link-cost heartbeats: subkey = publishing peer, value
    ``{"l": {"host:port": [rtt_s, bw_bps|null]}}`` (``parse_links_value``).
    Consumed by the placement solver and the routing cost model."""
    return f"{LINKS_KEY_FAMILY}.{prefix}"


def parse_links_value(value: Any) -> Optional[dict]:
    """Peer-supplied links record → ``{"host:port": {"rtt_s": float,
    "bw_bps": float | None}}``, or None when malformed.  Entries are
    best-effort: a garbage destination is dropped, the record survives
    (same tolerance as ``parse_load_value``'s ``hot`` map)."""
    if not isinstance(value, dict):
        return None
    raw = value.get("l")
    if not isinstance(raw, dict):
        return None
    out: dict[str, dict] = {}
    for dst, ent in raw.items():
        if not (isinstance(dst, str) and ":" in dst):
            continue
        if not isinstance(ent, (list, tuple)) or not ent:
            continue
        try:
            rtt = float(ent[0])
        except (TypeError, ValueError):
            continue
        if rtt != rtt or rtt < 0.0:  # NaN / negative: garbage
            continue
        bw = None
        if len(ent) > 1 and ent[1] is not None:
            try:
                bw = float(ent[1])
            except (TypeError, ValueError):
                bw = None
            if bw is not None and (bw != bw or bw <= 0.0):
                bw = None
        out[dst] = {"rtt_s": rtt, "bw_bps": bw}
    return out


def link_snapshot(max_links: int = MAX_ADVERTISED_LINKS) -> dict:
    """This process's measured per-destination link EMAs, in the wire
    form ``{"host:port": [rtt_s, bw_bps|null]}`` — read straight off the
    client connection-pool registry (every outbound RPC already folds
    its timing into ``rtt_ema``/``bw_ema``; publishing costs nothing
    new).  Unmeasured pools are skipped; at most ``max_links`` entries,
    cheapest-RTT first then endpoint for determinism."""
    from learning_at_home_tpu_torch.client.rpc import pool_registry

    rows = []
    for pool in pool_registry().pools():
        rtt = pool.rtt_ema
        if rtt is None:
            continue
        bw = pool.bw_ema
        key = f"{pool.endpoint[0]}:{pool.endpoint[1]}"
        rows.append((round(float(rtt), 6), key, bw))
    rows.sort()
    return {
        key: [rtt, round(float(bw), 1) if bw else None]
        for rtt, key, bw in rows[:max_links]
    }


def parse_load_value(value: Any) -> Optional[dict]:
    """Peer-supplied load record → ``{"q": float, "n": int, "hot":
    {uid: float}}``, or None when malformed.  ``hot`` is best-effort:
    non-numeric entries are dropped, the record survives."""
    if not isinstance(value, dict):
        return None
    try:
        q = float(value.get("q", 0.0))
        n = int(value.get("n", 0))
    except (TypeError, ValueError):
        return None
    hot = {}
    raw_hot = value.get("hot")
    if isinstance(raw_hot, dict):
        for uid, ema in raw_hot.items():
            if isinstance(uid, str):
                try:
                    hot[uid] = float(ema)
                except (TypeError, ValueError):
                    continue
    return {"q": q, "n": n, "hot": hot}


def parse_wanted_value(value: Any) -> Optional[dict]:
    """``[depth EMA, host, port]`` → {"depth", "endpoint"}, or None."""
    try:
        depth = float(value[0])
        host, port = value[1], int(value[2])
        if not isinstance(host, str):
            return None
        return {"depth": depth, "endpoint": (host, port)}
    except (TypeError, ValueError, IndexError, KeyError):
        return None


def parse_telemetry_value(value: Any) -> Optional[dict]:
    """Peer-supplied ``[host, port, role?]`` → {"endpoint", "role"}, or
    None when malformed (same tolerance as expert/averaging records)."""
    try:
        host, port = value[0], int(value[1])
        if not isinstance(host, str):
            return None
        role = value[2] if len(value) > 2 and isinstance(value[2], str) else "peer"
        return {"endpoint": (host, port), "role": role}
    except (TypeError, ValueError, IndexError, KeyError):
        return None


def discover_telemetry(dht, prefix: str = DEFAULT_PREFIX) -> dict[str, dict]:
    """Alive telemetry peers under the prefix:
    ``{peer_id: {"endpoint": (host, port), "role": str, "expires_at": float}}``.
    Expired records never appear (DHT reads drop them) — a peer missing
    from consecutive snapshots is dead or partitioned."""
    out: dict[str, dict] = {}
    for subkey, (value, expires_at) in dht.get_sync(
        telemetry_key(prefix)
    ).items():
        if not isinstance(subkey, str) or not subkey:
            continue
        parsed = parse_telemetry_value(value)
        if parsed is not None:
            parsed["expires_at"] = float(expires_at)
            out[subkey] = parsed
    return out


def fetch_json(
    endpoint: Endpoint, path: str = "/metrics.json", timeout: float = 3.0
) -> Optional[dict]:
    """GET a JSON document from a peer's metrics endpoint; None on any
    failure — telemetry readers must never crash on a dying peer."""
    url = f"http://{endpoint[0]}:{endpoint[1]}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode())
    except Exception:
        return None


def fetch_text(
    endpoint: Endpoint, path: str = "/metrics", timeout: float = 3.0
) -> Optional[str]:
    """GET a text document (Prometheus exposition) from a peer."""
    url = f"http://{endpoint[0]}:{endpoint[1]}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode()
    except Exception:
        return None


def fetch_trace_events(endpoint: Endpoint, timeout: float = 3.0) -> list:
    """A peer's Chrome trace_event list (empty when unreachable or when
    the peer runs with profiling off)."""
    doc = fetch_json(endpoint, "/trace", timeout)
    events = (doc or {}).get("traceEvents")
    return events if isinstance(events, list) else []


class TelemetryPublisher:
    """Metrics endpoint + DHT heartbeat for a peer that has no Server.

    Expert servers publish from server/server.py; a TRAINER process uses
    this: it owns a small background loop hosting the
    :class:`MetricsHTTPServer` and a daemon thread that re-declares
    ``telemetry.<prefix>`` every ``period`` seconds with TTL =
    ``2 × period`` — stop heartbeating (crash included) and the record
    expires, which is exactly how the swarm learns the peer died.

    ``host`` is both the bind address AND the address advertised in the
    DHT: the default loopback is only correct for single-box swarms —
    cross-machine deployments must pass this machine's swarm-reachable
    address (``train_lm.py --telemetry-host``), exactly like a Server's
    ``host``.
    """

    def __init__(
        self,
        dht,
        prefix: str = DEFAULT_PREFIX,
        role: str = "trainer",
        peer_id: Optional[str] = None,
        host: str = "127.0.0.1",
        period: float = 5.0,
        meta: Optional[dict] = None,
        extra_fn: Optional[Callable[[], dict]] = None,
    ):
        import uuid

        self.dht = dht
        self.prefix = prefix
        self.role = role
        self.period = period
        self.peer_id = peer_id or f"{role}-{uuid.uuid4().hex[:8]}"
        self._loop = BackgroundLoop(name="lah-telemetry")
        self.server = MetricsHTTPServer(
            meta={"role": role, "peer_id": self.peer_id, **(meta or {})},
            extra_fn=extra_fn,
        )
        try:
            self.port: int = self._loop.run(self.server.start(host), timeout=10)
        except BaseException:
            self._loop.shutdown()
            raise
        self.endpoint: Endpoint = (host, self.port)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _declare_once(self) -> None:
        try:
            self.dht.store_sync(
                telemetry_key(self.prefix),
                [self.endpoint[0], self.port, self.role],
                2 * self.period,
                subkey=self.peer_id,
            )
            # measured link EMAs: a trainer's connection
            # pools hold the src→server RTT/bw view the placement
            # solver needs most — piggyback it on the same heartbeat
            links = link_snapshot()
            if links:
                self.dht.store_sync(
                    links_key(self.prefix),
                    {"l": links},
                    2 * self.period,
                    subkey=self.peer_id,
                )
        except Exception:
            logger.exception("telemetry heartbeat failed for %s", self.peer_id)

    def start(self) -> "TelemetryPublisher":
        if self._thread is not None:
            return self
        self._declare_once()  # visible immediately, not one period later

        def heartbeat() -> None:
            while not self._stop.wait(self.period):
                self._declare_once()

        self._thread = threading.Thread(
            target=heartbeat, name="lah-telemetry-heartbeat", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period + 1)
            self._thread = None
        try:
            self._loop.loop.call_soon_threadsafe(self.server.close)
        except RuntimeError:
            pass
        self._loop.shutdown()
