"""Co-activation-aware expert placement.

The port's copy of ``learning_at_home_tpu/analysis/placement.py`` (no
framework inside): the same snapshot and seed give the same plan bytes.

A PURE cost model + solver: a serializable swarm *snapshot* goes in, a
deterministic *migration plan* comes out.  No DHT, no sockets, no clock
— a rebalancer builds snapshots from live telemetry and executes
plans over the `migrate` RPC; everything here is unit-testable offline
and byte-reproducible per seed.

Snapshot (every section is peer-supplied somewhere upstream, so every
section tolerates absence or garbage — malformed entries are skipped,
never raised on):

```
{
  "experts":     {uid: "host:port"},          # current home per expert
  "activations": {uid: count},                # per-expert dispatch counts
  "coact":       {"uidA|uidB": count},        # undirected pair counts
  "links":       {src: {dst: [rtt_s, bw_bps|null]}},  # measured link EMAs
  "sources":     {src: weight},               # dispatching clients
  "capacity":    {node: max_experts},         # optional per-node cap
  "bytes_per_dispatch": float,                # payload bytes per expert hop
}
```

Cost model (MoETuner-style; topology-aware in the
TA-MoE sense): a candidate assignment `uid -> node` is scored as the
expected per-window wire cost

    cost = Σ_pairs  coact[u,v] · link(node[u], node[v])
         + Σ_uids   act[u] · Σ_src w_src · link(src, node[u]) / Σ_src w

where `link(a, b)` is 0 for co-located endpoints and otherwise the
measured RTT EMA plus the transfer time of `bytes_per_dispatch` at the
measured bandwidth EMA (symmetrized; `DEFAULT_RTT_S` when unmeasured —
an optimistic prior, mirroring the routing cost model's exploration
default).  The first term rewards co-locating experts that fire
together (one node touched per dispatch instead of two); the second
pulls hot experts toward nodes the dispatching clients reach cheaply.

The solver is seeded greedy local search over two neighborhoods under
per-node capacity: single-expert moves, then pair swaps (exchanging two
experts' homes — occupancy-neutral, so always capacity-safe: the escape
hatch when every profitable single move is blocked by a full node).
Deterministic for a fixed (snapshot, seed) — ties break on sorted keys,
the visit order is `random.Random(seed)`.
"""

from __future__ import annotations

import json
import random
from typing import Optional

# unmeasured links score as a plausible same-region RTT: cheap enough
# that the solver still consolidates onto unmeasured nodes when the
# co-activation term dominates, never free (free would teleport every
# expert to whichever node lacks measurements)
DEFAULT_RTT_S = 0.02
DEFAULT_MAX_MOVES = 8
DEFAULT_MAX_ROUNDS = 6


def pair_key(a: str, b: str) -> str:
    """Canonical undirected co-activation pair key ("min|max")."""
    return f"{a}|{b}" if a <= b else f"{b}|{a}"


def _num(v) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    f = float(v)
    return f if f == f and f >= 0.0 else None  # NaN / negatives: garbage


def _link_entry(v) -> Optional[tuple]:
    """One links-map value -> (rtt_s, bw_bps|None); None when malformed.
    Accepts the wire list form ``[rtt, bw]`` and the parsed dict form
    ``{"rtt_s": .., "bw_bps": ..}``."""
    if isinstance(v, dict):
        v = [v.get("rtt_s"), v.get("bw_bps")]
    if not isinstance(v, (list, tuple)) or not v:
        return None
    rtt = _num(v[0])
    if rtt is None:
        return None
    bw = _num(v[1]) if len(v) > 1 else None
    return (rtt, bw if bw else None)


class _Model:
    """Normalized snapshot + incremental cost evaluation."""

    def __init__(self, snapshot: dict):
        snapshot = snapshot if isinstance(snapshot, dict) else {}
        experts = snapshot.get("experts")
        self.assign: dict = {}
        if isinstance(experts, dict):
            for uid, node in experts.items():
                if isinstance(uid, str) and isinstance(node, str) and node:
                    self.assign[uid] = node
        self.nodes = sorted(set(self.assign.values()))
        acts = snapshot.get("activations")
        self.act = {}
        if isinstance(acts, dict):
            for uid, n in acts.items():
                w = _num(n)
                if uid in self.assign and w:
                    self.act[uid] = w
        # undirected neighbor lists: uid -> [(other, weight)]
        self.neighbors: dict = {uid: [] for uid in self.assign}
        coact = snapshot.get("coact")
        if isinstance(coact, dict):
            for key, n in sorted(coact.items(), key=lambda kv: str(kv[0])):
                w = _num(n)
                if not (isinstance(key, str) and w):
                    continue
                a, _, b = key.partition("|")
                if a in self.assign and b in self.assign and a != b:
                    self.neighbors[a].append((b, w))
                    self.neighbors[b].append((a, w))
        self.bytes_per_dispatch = (
            _num(snapshot.get("bytes_per_dispatch")) or 0.0
        )
        # symmetrized measured links: (a, b) sorted -> (rtt, bw)
        self._links: dict = {}
        links = snapshot.get("links")
        if isinstance(links, dict):
            for src in sorted(links, key=str):
                dsts = links[src]
                if not (isinstance(src, str) and isinstance(dsts, dict)):
                    continue
                for dst in sorted(dsts, key=str):
                    ent = _link_entry(dsts[dst])
                    if not isinstance(dst, str) or ent is None:
                        continue
                    k = (src, dst) if src <= dst else (dst, src)
                    old = self._links.get(k)
                    # keep the cheaper measurement of the two directions
                    if old is None or ent[0] < old[0]:
                        self._links[k] = ent
        srcs = snapshot.get("sources")
        self.sources: dict = {}
        if isinstance(srcs, dict):
            for src, w in srcs.items():
                ww = _num(w)
                if isinstance(src, str) and ww:
                    self.sources[src] = ww
        self._src_total = sum(self.sources.values())
        caps = snapshot.get("capacity")
        self.capacity: dict = {}
        if isinstance(caps, dict):
            for node, c in caps.items():
                cc = _num(c)
                if isinstance(node, str) and cc is not None:
                    self.capacity[node] = int(cc)
        self.occupancy: dict = {n: 0 for n in self.nodes}
        for node in self.assign.values():
            self.occupancy[node] += 1

    def link_cost(self, a: str, b: str) -> float:
        """Seconds per dispatch hop between endpoints ``a`` and ``b``."""
        if a == b:
            return 0.0
        ent = self._links.get((a, b) if a <= b else (b, a))
        rtt, bw = ent if ent is not None else (DEFAULT_RTT_S, None)
        transfer = self.bytes_per_dispatch / bw if bw else 0.0
        return rtt + transfer

    def expert_cost(self, uid: str, node: str) -> float:
        """``uid``'s contribution to the total with ``uid`` at ``node``
        (others where self.assign puts them) — the unit of the solver's
        move deltas.  Pair terms are counted from ``uid``'s side only,
        so a move delta is exact (the other side's view shifts by the
        same amount)."""
        cost = 0.0
        for other, w in self.neighbors[uid]:
            cost += w * self.link_cost(node, self.assign[other])
        act = self.act.get(uid)
        if act and self._src_total:
            src_cost = sum(
                w * self.link_cost(src, node)
                for src, w in self.sources.items()
            )
            cost += act * src_cost / self._src_total
        return cost

    def total_cost(self) -> float:
        cost = 0.0
        for uid in sorted(self.assign):
            node = self.assign[uid]
            for other, w in self.neighbors[uid]:
                if uid < other:  # each undirected pair once
                    cost += w * self.link_cost(node, self.assign[other])
            act = self.act.get(uid)
            if act and self._src_total:
                cost += act * sum(
                    w * self.link_cost(src, node)
                    for src, w in self.sources.items()
                ) / self._src_total
        return cost


def placement_cost(snapshot: dict) -> float:
    """Score the snapshot's CURRENT assignment (pure; test surface)."""
    return _Model(snapshot).total_cost()


def solve(
    snapshot: dict,
    *,
    seed: int = 0,
    max_moves: int = DEFAULT_MAX_MOVES,
    max_rounds: int = DEFAULT_MAX_ROUNDS,
    neighborhoods: tuple = ("move", "swap"),
) -> dict:
    """Snapshot in, migration plan out.  Deterministic per (snapshot,
    seed); tolerant of malformed/empty sections (empty plan, never a
    raise).  Capacity: explicit per-node caps from the snapshot, else
    a balanced default of ceil(n_experts / n_nodes) + 1 slack.

    ``neighborhoods`` selects the local-search moves explored per round:
    ``"move"`` (single-expert relocation) and/or ``"swap"`` (pair
    exchange).  The default runs both; restricting to ``("move",)``
    exists for A/B evaluation — the macro-sim's placement stress pins
    that the swap neighborhood strictly improves clustered topologies
    where every profitable single move is capacity-blocked."""
    model = _Model(snapshot)
    uids = sorted(model.assign)
    plan = {
        "seed": int(seed),
        "cost_before": model.total_cost(),
        "cost_after": None,
        "moves": [],
    }
    if len(model.nodes) < 2 or not uids:
        plan["cost_after"] = plan["cost_before"]
        return plan
    default_cap = -(-len(uids) // len(model.nodes)) + 1
    cap = {
        n: model.capacity.get(n, default_cap) for n in model.nodes
    }
    initial = dict(model.assign)
    rng = random.Random(int(seed))
    moved: set = set()
    do_move = "move" in neighborhoods
    do_swap = "swap" in neighborhoods
    for _ in range(max_rounds):
        order = list(uids) if do_move else []
        rng.shuffle(order)
        improved = False
        for uid in order:
            # a capped plan must stay executable move-for-move: once
            # max_moves DISTINCT experts moved, only those may keep
            # improving (their latest destination wins)
            if len(moved) >= max_moves and uid not in moved:
                continue
            cur = model.assign[uid]
            here = model.expert_cost(uid, cur)
            best, best_cost = cur, here
            for node in model.nodes:
                if node == cur or model.occupancy[node] >= cap[node]:
                    continue
                cost = model.expert_cost(uid, node)
                if cost < best_cost - 1e-12:
                    best, best_cost = node, cost
            if best != cur:
                model.assign[uid] = best
                model.occupancy[cur] -= 1
                model.occupancy[best] += 1
                moved.add(uid)
                improved = True
        # pair-swap neighborhood: exchanging two experts' homes leaves
        # every node's occupancy unchanged, so a swap is capacity-safe
        # even between FULL nodes — the configurations single moves can
        # never reach under tight caps
        pairs = [
            (uids[i], uids[j])
            for i in range(len(uids))
            for j in range(i + 1, len(uids))
        ] if do_swap else []
        rng.shuffle(pairs)
        for u, v in pairs:
            nu, nv = model.assign[u], model.assign[v]
            if nu == nv:
                continue
            if len(moved | {u, v}) > max_moves:
                continue
            before = model.expert_cost(u, nu) + model.expert_cost(v, nv)
            model.assign[u], model.assign[v] = nv, nu
            after = model.expert_cost(u, nv) + model.expert_cost(v, nu)
            # when u,v co-activate their shared pair term sits in both
            # sums on both sides and links are symmetric, so it cancels
            # — the delta over everything else is exact
            if after < before - 1e-12:
                moved.update((u, v))
                improved = True
            else:
                model.assign[u], model.assign[v] = nu, nv
        if not improved:
            break
    moves = []
    for uid in sorted(moved):
        if model.assign[uid] == initial[uid]:
            continue  # round-tripped back home: not a move
        final = model.assign[uid]
        # gain: the total-cost delta of undoing this one move against
        # the FINAL assignment (exact for single moves, stable ordering)
        after = model.expert_cost(uid, final)
        model.assign[uid] = initial[uid]
        before = model.expert_cost(uid, initial[uid])
        model.assign[uid] = final
        moves.append({
            "uid": uid,
            "from": initial[uid],
            "to": final,
            "gain": round(before - after, 9),
        })
    moves.sort(key=lambda m: (-m["gain"], m["uid"]))
    plan["moves"] = moves
    plan["cost_after"] = model.total_cost()
    plan["cost_before"] = round(plan["cost_before"], 9)
    plan["cost_after"] = round(plan["cost_after"], 9)
    return plan


def plan_to_json(plan: dict) -> str:
    """Canonical serialization: sorted keys, no whitespace — the form
    two runs compare byte for byte."""
    return json.dumps(plan, sort_keys=True, separators=(",", ":"))
