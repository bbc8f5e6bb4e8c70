"""A client's cached alive set across a refresh whose lookups all fail,
in both packages, on the CPU.

The scenario, run the same way through the JAX package and the port: a
bootstrap DHT node and a holder node that declares four experts; a
client node that joins after the declaration (so its own storage holds
none of the records) resolves the full set through a ``CachedAliveSet``.
Then every lookup RPC of the client fails -- the two nodes that hold the
records are shut down, or every reply is dropped (each RPC waits out its
adaptive timeout) -- and the next refresh runs, with and without
stale-while-revalidate.  A third arm keeps both nodes up as the control.

What a failed refresh leaves in the cache is each package's ``{}``: the
DHT ``get`` returns the records it found (none) and the client's local
ones (none), and ``CachedAliveSet`` stores whatever its fetch returns.
The port does what the reference does; the chip script's
``hold_alive_sets`` keeps its swarm phases off this window.
"""

import asyncio
import time

import pytest

from learning_at_home_tpu.client import routing as jax_routing
from learning_at_home_tpu.dht import DHT as JaxDHT
from learning_at_home_tpu.dht.routing import DHTID as JaxDHTID
from learning_at_home_tpu_torch.client import routing
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.dht.routing import DHTID
from torch_gate_harness import bounded

PACKAGES = {
    "jax": (JaxDHT, jax_routing.CachedAliveSet, JaxDHTID),
    "port": (DHT, routing.CachedAliveSet, DHTID),
}
UIDS = [f"al.{i}" for i in range(4)]
ALIVE_TTL = 0.3
RECORD_CACHE_TTL = 0.1


def _drop_every_reply(dht) -> None:
    """Every RPC the client's DHT node sends waits out its timeout and
    fails, as when the peer's reply never comes."""
    protocol = dht.node.protocol

    async def dropped(endpoint, msg_type, meta):
        await asyncio.sleep(protocol.timeout_for(endpoint))
        raise asyncio.TimeoutError(f"{msg_type} reply from {endpoint} "
                                   "dropped")

    protocol._transport = dropped


def refresh_after(package: str, fault: str, swr: bool) -> dict:
    """The scenario of the module docstring through ``package``: what the
    refresh served and what the cache holds after it."""
    dht_cls, cache_cls, dhtid = PACKAGES[package]
    boot = dht_cls()
    holder = dht_cls(initial_peers=[boot.endpoint])
    client = None
    loop = asyncio.new_event_loop()
    try:
        assert holder.declare_experts_sync(UIDS, ("127.0.0.1", 31337),
                                           expiration=120.0)
        client = dht_cls(initial_peers=[boot.endpoint],
                         cache_ttl=RECORD_CACHE_TTL)
        assert client.node.storage.get(
            dhtid.from_key("al").to_bytes()) == {}
        cache = cache_cls(client, "al", ttl=ALIVE_TTL, swr=swr)
        full = loop.run_until_complete(cache.get())
        assert sorted(full) == UIDS
        if fault == "peers shut down":
            holder.shutdown()
            boot.shutdown()
            holder = boot = None
        elif fault == "replies dropped":
            _drop_every_reply(client)
        time.sleep(ALIVE_TTL + RECORD_CACHE_TTL + 0.1)

        async def refresh():
            t0 = time.monotonic()
            served = await cache.get()
            if cache._refreshing is not None:
                await cache._refreshing
            return served, time.monotonic() - t0

        served, seconds = loop.run_until_complete(refresh())
        return {"served": sorted(served), "held": sorted(cache._cached),
                "refresh_failures": cache.refresh_failures,
                "stale_serves": cache.stale_serves, "seconds": seconds}
    finally:
        loop.close()
        for dht in (client, holder, boot):
            if dht is not None:
                dht.shutdown()


@pytest.mark.parametrize("swr", [True, False], ids=["swr", "blocking"])
@pytest.mark.parametrize("fault", ["none", "peers shut down",
                                   "replies dropped"])
def test_a_refresh_whose_lookups_all_fail_holds_the_references_set(
        fault, swr):
    got = {pkg: bounded(60.0, refresh_after, pkg, fault, swr)
           for pkg in PACKAGES}
    want = {"served": UIDS if (swr or fault == "none") else [],
            "held": UIDS if fault == "none" else [],
            "refresh_failures": 0, "stale_serves": int(swr)}
    for pkg, outcome in got.items():
        assert {k: v for k, v in outcome.items() if k != "seconds"} == \
            want, (pkg, outcome)
        # the failed lookups end within their timeouts, not hang
        assert outcome["seconds"] < 10.0, (pkg, outcome)
