"""The port's Kademlia DHT against the JAX package's, on the CPU.

- The framework-free core held against the JAX package's on the same
  inputs: ``DHTID`` (sha1 ids, bit for bit), k-buckets, the routing table,
  ``random_id_in_range`` and the timed storage, each driven through one
  seeded sequence of operations on both sides.
- The JAX package's DHT cases (``tests/test_dht.py``) on port nodes:
  store/get across nodes, expiry as failure detection, the subkey merge,
  dead-peer eviction, the facade's declare and discover, the foreign-loop
  bridge, the record cache, the lookup strikes, the store RPC's bounds.
- Wire parity: the ``store_many`` frames a port node sends are the JAX
  node's byte for byte (same node id, table and records).
- A mixed DHT of 3 JAX and 3 port nodes is one swarm: each side reads the
  other's ``declare_experts`` through ``get_experts``,
  ``get_alive_experts`` and ``first_k_active``, and ``beam_search_alive``
  finds the same alive set from either side.

Every node and loop is shut down in the test that made it.
"""

import asyncio
import time

import numpy as np
import pytest

from learning_at_home_tpu.client.routing import (
    beam_search_alive as jax_beam_search_alive,
)
from learning_at_home_tpu.dht import DHT as JaxDHT
from learning_at_home_tpu.dht import DHTNode as JaxDHTNode
from learning_at_home_tpu.dht import routing as jax_routing
from learning_at_home_tpu.utils import serialization as jax_serialization
from learning_at_home_tpu.utils import timed_storage as jax_timed_storage
from learning_at_home_tpu_torch.client.routing import beam_search_alive
from learning_at_home_tpu_torch.dht import DHT, DHTNode, _RecordCache, uid_prefixes
from learning_at_home_tpu_torch.dht import routing as port_routing
from learning_at_home_tpu_torch.dht.protocol import DHTRecordStorage, PLAIN_SUBKEY
from learning_at_home_tpu_torch.dht.routing import DHTID, KBucket, RoutingTable
from learning_at_home_tpu_torch.utils import serialization as port_serialization
from learning_at_home_tpu_torch.utils import timed_storage as port_timed_storage
from learning_at_home_tpu_torch.utils.timed_storage import get_dht_time


def run(coro):
    return asyncio.run(coro)


# ---------------- the framework-free core against the JAX package's ----------------


def _seeded_ids(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(20), "big") for _ in range(n)]


def test_dhtid_bitwise_equal_to_jax():
    for key in ["ffn", "ffn0.3.7", "telemetry.swarm", b"\x00\xffraw", "é"]:
        a, b = DHTID.from_key(key), jax_routing.DHTID.from_key(key)
        assert int(a) == int(b) and a.to_bytes() == b.to_bytes()
    for x, y in zip(_seeded_ids(0, 16), _seeded_ids(1, 16)):
        a, b = DHTID(x), jax_routing.DHTID(x)
        assert a.xor_distance(y) == b.xor_distance(y)
        assert a.to_bytes() == b.to_bytes()
        assert DHTID.from_bytes(a.to_bytes()) == jax_routing.DHTID.from_bytes(
            b.to_bytes())


def test_kbucket_and_routing_table_equal_to_jax():
    ids = _seeded_ids(2, 200)
    own = ids[0]
    tables = [RoutingTable(DHTID(own), bucket_size=4),
              jax_routing.RoutingTable(jax_routing.DHTID(own), bucket_size=4)]
    rng = np.random.default_rng(3)
    for step, nid in enumerate(ids[1:]):
        for t, cls in zip(tables, (DHTID, jax_routing.DHTID)):
            t.add_or_update_node(cls(nid), ("h", step))
        if rng.random() < 0.2:  # remove a random known peer on both sides
            victim = ids[1 + rng.integers(step + 1)]
            for t, cls in zip(tables, (DHTID, jax_routing.DHTID)):
                t.remove_node(cls(victim))

    def view(t):
        return [(b.lower, b.upper, [(int(k), v) for k, v in b.peers.items()],
                 [(int(k), v) for k, v in b.replacement.items()])
                for b in t.buckets]

    assert view(tables[0]) == view(tables[1])
    assert len(tables[0]) == len(tables[1])
    for target in _seeded_ids(4, 8):
        got = [(int(n), ep) for n, ep in tables[0].nearest_neighbors(target, 6)]
        want = [(int(n), ep) for n, ep in tables[1].nearest_neighbors(target, 6)]
        assert got == want
    # a bucket's LRU order and replacement list, step by step
    buckets = [KBucket(0, 2**160, k=3), jax_routing.KBucket(0, 2**160, k=3)]
    for i in [5, 1, 9, 5, 7, 3, 1, 8]:
        res = [b.add_or_update(cls(i), ("h", i)) for b, cls in
               zip(buckets, (DHTID, jax_routing.DHTID))]
        assert res[0] == res[1]
    buckets[0].remove(DHTID(1))
    buckets[1].remove(jax_routing.DHTID(1))
    assert [int(k) for k in buckets[0].peers] == [int(k) for k in buckets[1].peers]
    assert int(buckets[0].oldest[0]) == int(buckets[1].oldest[0])


def test_random_id_in_range_equal_to_jax(monkeypatch):
    for mod in (port_routing, jax_routing):
        rng = np.random.default_rng(5)
        monkeypatch.setattr(mod, "_urandom", lambda n, rng=rng: rng.bytes(n))
    for lo, hi in [(0, 2**160), (2**100, 2**101), (17, 1000)]:
        a = port_routing.random_id_in_range(lo, hi)
        b = jax_routing.random_id_in_range(lo, hi)
        assert int(a) == int(b) and lo <= a < hi
    assert int(port_routing.DHTID.generate()) == int(jax_routing.DHTID.generate())


def test_timed_storage_equal_to_jax(monkeypatch):
    now = [100.0]
    for mod in (port_timed_storage, jax_timed_storage):
        monkeypatch.setattr(mod, "_time_source", lambda: now[0])
    stores = [port_timed_storage.TimedStorage(maxsize=3),
              jax_timed_storage.TimedStorage(maxsize=3)]
    rng = np.random.default_rng(6)
    for _ in range(60):
        op = rng.integers(4)
        key, exp = f"k{rng.integers(6)}", 100.0 + float(rng.integers(1, 20))
        if op == 0:
            out = [s.store(key, [key, exp], exp) for s in stores]
        elif op == 1:
            out = [s.get(key) for s in stores]
        elif op == 2:
            now[0] += float(rng.integers(0, 3))
            out = [sorted(s.items()) for s in stores]
        else:
            out = [(len(s), s.top(), key in s) for s in stores]
        assert out[0] == out[1]


def test_record_storage_subkeys(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(port_timed_storage, "get_dht_time", lambda: now[0])
    st = DHTRecordStorage()
    assert st.store(b"k", "a", 1, 110.0)
    assert st.store(b"k", "b", 2, 120.0)
    assert not st.store(b"k", "a", 0, 105.0)  # older expiration loses
    assert st.get(b"k") == {"a": (1, 110.0), "b": (2, 120.0)}
    now[0] = 115.0
    assert st.get(b"k") == {"b": (2, 120.0)}  # 'a' expired individually


def test_record_storage_bounded():
    st = DHTRecordStorage(maxsize=4, max_subkeys=3)
    exp = get_dht_time() + 30
    stored = [st.store(f"k{i}".encode(), PLAIN_SUBKEY, [i], exp)
              for i in range(10)]
    assert all(stored[:4])
    assert len(st) <= 4
    for i in range(10):
        st.store(b"one", f"sk{i}", [i], exp)
    assert len(st.get(b"one")) <= 3


def test_uid_prefixes():
    assert uid_prefixes("ffn.4.17") == ["ffn", "ffn.4"]
    assert uid_prefixes("expert.3") == ["expert"]


# ---------------- swarm tier on port nodes ----------------


async def make_swarm(n, **kwargs):
    first = await DHTNode.create(**kwargs)
    nodes = [first]
    for _ in range(n - 1):
        nodes.append(await DHTNode.create(initial_peers=[first.endpoint],
                                          **kwargs))
    return nodes


async def teardown(nodes):
    await asyncio.gather(*(n.shutdown() for n in nodes))


def test_swarm_store_get_across_nodes():
    async def main():
        nodes = await make_swarm(8, bucket_size=4)
        try:
            ok = await nodes[2].store("the-key", [1, 2, 3], get_dht_time() + 30)
            assert ok
            rec = await nodes[7].get("the-key")
            assert rec[PLAIN_SUBKEY][0] == [1, 2, 3]
            assert await nodes[5].get("missing-key") == {}
        finally:
            await teardown(nodes)

    run(main())


def test_swarm_expiration_is_failure_detection():
    async def main():
        nodes = await make_swarm(4, bucket_size=4)
        try:
            await nodes[0].store("ephemeral", "v", get_dht_time() + 0.5)
            assert (await nodes[3].get("ephemeral"))[PLAIN_SUBKEY][0] == "v"
            await asyncio.sleep(0.6)
            assert await nodes[3].get("ephemeral") == {}
        finally:
            await teardown(nodes)

    run(main())


def test_swarm_subkey_merge_from_different_writers():
    async def main():
        nodes = await make_swarm(5, bucket_size=4)
        try:
            exp = get_dht_time() + 30
            await nodes[1].store("ffn", ["hostA", 1], exp, subkey="ffn.0")
            await nodes[2].store("ffn", ["hostB", 2], exp, subkey="ffn.1")
            rec = await nodes[4].get("ffn")
            assert rec["ffn.0"][0] == ["hostA", 1]
            assert rec["ffn.1"][0] == ["hostB", 2]
        finally:
            await teardown(nodes)

    run(main())


def test_maintenance_evicts_dead_peer():
    async def main():
        a = await DHTNode.create(bucket_size=4, maintenance_period=None)
        b = await DHTNode.create(initial_peers=[a.endpoint], bucket_size=4,
                                 maintenance_period=None)
        c = await DHTNode.create(initial_peers=[a.endpoint], bucket_size=4,
                                 maintenance_period=None)
        try:
            assert len(b.routing_table) >= 2
            await c.shutdown()
            b.start_maintenance(period=0.3)
            deadline = asyncio.get_running_loop().time() + 10
            while asyncio.get_running_loop().time() < deadline:
                if b.routing_table.get_endpoint(c.node_id) is None:
                    break
                await asyncio.sleep(0.2)
            assert b.routing_table.get_endpoint(c.node_id) is None
            assert b.routing_table.get_endpoint(a.node_id) is not None
        finally:
            await teardown([a, b])

    run(main())


def test_store_many_equals_per_key_stores_on_the_wire():
    """The coalesced bundle lands the same records (values and
    expirations) as per-key stores, with fewer store RPCs."""

    async def main():
        nodes = await make_swarm(6, bucket_size=4)
        try:
            exp = get_dht_time() + 30
            batched = [(f"bk.{i}", f"s{j}", [i, j], exp)
                       for i in range(3) for j in range(2)]
            sent0 = nodes[1].protocol.rpcs_sent.get("store", 0)
            assert all(await nodes[1].store_many(batched))
            batched_rpcs = nodes[1].protocol.rpcs_sent.get("store", 0) - sent0
            sent0 = nodes[2].protocol.rpcs_sent.get("store", 0)
            for i in range(3):
                for j in range(2):
                    assert await nodes[2].store(f"pk.{i}", [i, j], exp,
                                                subkey=f"s{j}")
            per_key_rpcs = nodes[2].protocol.rpcs_sent.get("store", 0) - sent0
            for i in range(3):
                b = await nodes[5].get(f"bk.{i}")
                p = await nodes[5].get(f"pk.{i}")
                assert set(b) == set(p) == {"s0", "s1"}
                for j in range(2):
                    assert b[f"s{j}"] == p[f"s{j}"] == ([i, j], exp)
            assert batched_rpcs <= len(nodes) < per_key_rpcs
        finally:
            await teardown(nodes)

    run(main())


def test_store_rpc_rejects_absurd_keys():
    node = run(DHTNode.create(maintenance_period=None))
    try:
        meta = {
            "from": DHTID.generate().to_bytes(), "port": 1,
            "items": [
                [b"x" * 10_000, PLAIN_SUBKEY, [1], get_dht_time() + 30],
                [b"fine", "s" * 10_000, [1], get_dht_time() + 30],
                [b"fine", "ok", [1], get_dht_time() + 30],
            ],
        }
        reply = node.protocol._serve("store", meta, "127.0.0.1")
        assert reply["ok"]["ok"] is True
        assert sum(bool(v) for v in reply["ok"].values()) == 1
        assert reply["ok_list"] == [False, False, True]
        assert len(node.storage.get(b"fine")) == 1
    finally:
        run(node.shutdown())


def test_lookup_strikes():
    """Two-strike eviction needs a distinct, later lookup; one lookup never
    evicts; a strike leaves with its node."""
    node = DHTNode(node_id=DHTID(2**80))
    peer = DHTID(2**81)
    node.routing_table.add_or_update_node(peer, ("127.0.0.1", 1))
    wave = time.monotonic()
    node._record_lookup_timeout(peer, lookup_id=1, wave_started=wave)
    node._record_lookup_timeout(peer, lookup_id=2, wave_started=wave)
    assert node.routing_table.get_endpoint(peer) is not None
    node._record_lookup_timeout(peer, lookup_id=3,
                                wave_started=time.monotonic())
    assert node.routing_table.get_endpoint(peer) is None
    assert peer not in node._lookup_strikes

    node.routing_table.add_or_update_node(peer, ("127.0.0.1", 1))
    node._record_lookup_timeout(peer, 7, time.monotonic())
    node._record_lookup_timeout(peer, 7, time.monotonic())
    assert node.routing_table.get_endpoint(peer) is not None
    node.routing_table.remove_node(peer)
    assert peer not in node._lookup_strikes


# ---------------- the facade on port nodes ----------------


def test_dht_facade_declare_and_discover():
    dht1 = DHT()
    dht2 = DHT(initial_peers=[dht1.endpoint])
    try:
        n = dht1.declare_experts_sync(
            ["ffn.0.0", "ffn.0.1", "ffn.1.1"], ("10.0.0.1", 9000),
            expiration=30)
        assert n == 3
        eps = dht2.get_experts_sync(["ffn.0.1", "ffn.9.9"])
        assert eps == {"ffn.0.1": ("10.0.0.1", 9000), "ffn.9.9": None}
        alive = dht2._loop.run(dht2.get_alive_experts("ffn"))
        assert set(alive) == {"ffn.0.0", "ffn.0.1", "ffn.1.1"}
        active = dht2._loop.run(
            dht2.first_k_active(["ffn.0", "ffn.7", "ffn.1"], 2))
        assert active == {"ffn.0": True, "ffn.7": False, "ffn.1": True}
        # the sync store/get pair, the facade's generic records
        assert dht1.store_sync("plain", {"v": 1}, 30)
        assert dht2.get_sync("plain")[PLAIN_SUBKEY][0] == {"v": 1}
    finally:
        dht2.shutdown()
        dht1.shutdown()


def test_dht_facade_bridge_from_foreign_loop():
    dht = DHT()
    try:
        async def foreign():
            await dht.declare_experts(["e.0"], ("1.2.3.4", 5), expiration=10)
            await dht.store_many([("k", [1], 10, "a"), ("k", [2], 10, "b")])
            fresh = await dht.get_alive_experts_fresh("e")
            return await dht.get_experts(["e.0"]), fresh, await dht.get("k")

        experts, fresh, rec = asyncio.run(foreign())
        assert experts["e.0"] == ("1.2.3.4", 5)
        assert fresh == {"e.0": ("1.2.3.4", 5)}
        assert {sk: v for sk, (v, _) in rec.items()} == {"a": [1], "b": [2]}
    finally:
        dht.shutdown()


def test_record_cache_expiry_negative_caching_and_wire_key():
    cache = _RecordCache(ttl=30.0)
    now = get_dht_time()
    cache.put("k", {"soon": (1, now + 0.2), "later": (2, now + 30)})
    assert set(cache.get("k")) == {"soon", "later"}
    cache.put("gone", {"a": (1, now + 0.2)})
    time.sleep(0.25)
    assert set(cache.get("k")) == {"later"}  # 'soon' expired mid-window
    assert cache.get("gone") is None  # every record expired: a miss
    cache.put("ffn", {"x": (1, get_dht_time() + 30)})
    cache.invalidate(DHTID.from_key("ffn").to_bytes())  # the wire form
    assert cache.get("ffn") is None and cache.invalidations == 1
    short = _RecordCache(ttl=0.2)
    short.put("missing", {})
    assert short.get("missing") == {} and short.hits == 1
    time.sleep(0.25)
    assert short.get("missing") is None


def test_dht_cache_hits_bypass_and_invalidation():
    dht1 = DHT(cache_ttl=30.0)
    dht2 = DHT(initial_peers=[dht1.endpoint], cache_ttl=30.0)
    try:
        dht1.declare_experts_sync(["ffn.0.0"], ("10.0.0.1", 9000),
                                  expiration=30)
        first = dht2.get_sync("ffn.0.0")
        assert "@10.0.0.1:9000" in first
        sent = sum(dht2.node.protocol.rpcs_sent.values())
        assert dht2.get_sync("ffn.0.0") == first
        assert sum(dht2.node.protocol.rpcs_sent.values()) == sent
        assert dht2.get_sync("ffn.0.0", bypass_cache=True) == first
        assert sum(dht2.node.protocol.rpcs_sent.values()) > sent
        # an inbound store invalidates the cached prefix read
        assert set(dht2._loop.run(dht2._get_alive("ffn"))) == {"ffn.0.0"}
        dht1.declare_experts_sync(["ffn.0.1"], ("10.0.0.1", 9001),
                                  expiration=30)
        assert set(dht2._loop.run(dht2._get_alive("ffn"))) == {
            "ffn.0.0", "ffn.0.1"}
        # and so does this handle's own declare (read-your-writes)
        dht2.declare_experts_sync(["ffn.1.0"], ("10.0.0.2", 9000),
                                  expiration=30)
        assert set(dht2._loop.run(dht2._get_alive("ffn"))) == {
            "ffn.0.0", "ffn.0.1", "ffn.1.0"}
    finally:
        dht2.shutdown()
        dht1.shutdown()


# ---------------- wire parity with the JAX package ----------------


def _capturing_node(node_cls, id_cls, peers, serialization):
    """A node that sends nothing: its transport records each request's
    frame (packed by that package's serialization) and answers as a peer
    that knows nobody and stores everything."""
    node = node_cls(node_id=id_cls(2**159 + 12345), bucket_size=4)
    node.protocol.listen_port = 40000
    for nid, ep in peers:
        node.routing_table.add_or_update_node(id_cls(nid), ep)
    frames = []

    async def transport(endpoint, msg_type, meta):
        frames.append((endpoint, serialization.pack_message(msg_type,
                                                            meta=meta)))
        if msg_type == "store":
            return {"ok_list": [True] * len(meta["items"])}
        return {"peers": []}

    node.protocol._transport = transport
    return node, frames


def test_store_many_frames_equal_jax():
    peers = [(nid, ("127.0.0.1", 41000 + i))
             for i, nid in enumerate(_seeded_ids(7, 12))]
    exp = 1.9e9 + 0.25
    entries = [("ffn0", "ffn0.3.1@127.0.0.1:5000", ["127.0.0.1", 5000], exp),
               ("ffn0.3", "ffn0.3.1@127.0.0.1:5000", ["127.0.0.1", 5000], exp),
               ("ffn0.3.1", "@127.0.0.1:5000", ["127.0.0.1", 5000], exp),
               ("load.swarm", "127.0.0.1:5000",
                {"q": 0.0, "n": 3, "hot": {}}, exp + 1.5),
               ("telemetry.swarm", "server-127.0.0.1:5000",
                ["127.0.0.1", 5001, "server"], exp)]
    port_node, port_frames = _capturing_node(DHTNode, DHTID, peers,
                                             port_serialization)
    jax_node, jax_frames = _capturing_node(JaxDHTNode, jax_routing.DHTID,
                                           peers, jax_serialization)
    port_acks = run(port_node.store_many(entries))
    jax_acks = run(jax_node.store_many(entries))
    assert port_acks == jax_acks and all(port_acks)
    assert any(b"store" in f for _, f in port_frames)
    assert sorted(port_frames) == sorted(jax_frames)


# ---------------- a mixed DHT: 3 JAX nodes and 3 port nodes ----------------


@pytest.fixture
def mixed_dht():
    nodes = []
    try:
        for i in range(6):
            cls = JaxDHT if i % 2 == 0 else DHT
            peers = [nodes[-1].endpoint] if nodes else []
            nodes.append(cls(initial_peers=peers, cache_ttl=0.0))
        yield nodes
    finally:
        for n in reversed(nodes):
            n.shutdown()


def test_mixed_dht_is_one_swarm(mixed_dht):
    jax_a, port_a, jax_b, port_b, jax_c, port_c = mixed_dht
    port_uids = ["mx.0.0", "mx.0.1", "mx.2.3"]
    jax_uids = ["mx.1.0", "mx.1.2", "mx.3.3"]
    assert port_b.declare_experts_sync(port_uids, ("10.0.0.1", 9000), 30) == 3
    assert jax_b.declare_experts_sync(jax_uids, ("10.0.0.2", 9001), 30) == 3
    want = {**{u: ("10.0.0.1", 9000) for u in port_uids},
            **{u: ("10.0.0.2", 9001) for u in jax_uids}}
    for reader in (jax_a, port_a, jax_c, port_c):
        assert reader.get_experts_sync(["mx.0.1", "mx.1.2", "mx.9.9"]) == {
            "mx.0.1": ("10.0.0.1", 9000), "mx.1.2": ("10.0.0.2", 9001),
            "mx.9.9": None}
        assert reader._loop.run(reader.get_alive_experts("mx")) == want
        active = reader._loop.run(reader.first_k_active(
            ["mx.0", "mx.1", "mx.2", "mx.3", "mx.4"], 2))
        assert active == {"mx.0": True, "mx.1": True, "mx.2": True,
                          "mx.3": True, "mx.4": False}
    # beam search over a (5, 4) grid finds the same alive set from either
    # package's DHT, with either package's search
    rng = np.random.default_rng(8)
    logits = [rng.standard_normal((6, 5)), rng.standard_normal((6, 4))]
    found = [asyncio.run(search(src, "mx", logits, (5, 4), 4))
             for search in (beam_search_alive, jax_beam_search_alive)
             for src in (port_c, jax_c)]
    assert all(f == found[0] for f in found)
    assert found[0] and set(found[0]) <= set(want)
    assert {u: want[u] for u in found[0]} == found[0]
