"""Swarm telemetry: record keys and values, link snapshots, endpoint reads.

The port's copy of the JAX package's ``utils/telemetry.py`` as far as a
server's stats and the MoE client need it: the ``load`` and ``links``
key families and their value parsers, :func:`link_snapshot` (the
``stats`` RPC's links section) and :func:`fetch_json` (a metrics
endpoint's reader).  The ``telemetry`` and ``replicas.wanted`` families,
DHT discovery and the trainer-side ``TelemetryPublisher`` come with the
port's DHT.

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
model folds into expert selection (ISSUE 8): subkey is the RPC endpoint
so clients join it against alive-expert records without another lookup.
``replicas.wanted.*`` marks experts whose queue-depth EMA crossed the
hot threshold — the rebalancer (tools/lah_rebalance.py) reads it to
assign replicas to the least-loaded server.

``links.*`` (ISSUE 16) is the swarm's measured link-cost map: each peer
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
import urllib.request
from typing import Any, Optional


logger = logging.getLogger(__name__)

Endpoint = tuple[str, int]

DEFAULT_PREFIX = "swarm"

LOAD_KEY_FAMILY = "load"


def load_key(prefix: str = DEFAULT_PREFIX) -> str:
    """Server load heartbeats: subkey = RPC ``host:port``, value a dict
    (``parse_load_value``).  Consumed by the client RoutingCostModel."""
    return f"{LOAD_KEY_FAMILY}.{prefix}"


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
