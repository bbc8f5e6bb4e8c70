"""Elastic swarm lifecycle: graceful drain + live expert migration.

The source paper's swarm promises that peers come and go while training
continues, but a departing server used to just vanish — its experts died
with it.  This module is the control flow that turns "kill -9" into
"drain, hand off, rejoin" (ISSUE 9 / ROADMAP item 5):

- **drain** — the server flips to DRAINING: it stops heartbeating its
  experts (DHT record TTL expiry steers new dispatch away; hedged
  replica dispatch covers the stale window), keeps SERVING until the
  records it already published have expired, waits for in-flight batches
  to finish, then migrates every expert to a successor and exits.
- **handoff** — live migration of one expert's params AND optimizer
  state to a successor over the framed tensor wire (always the RAW wire
  — never a quantized codec: migration is bitwise or it failed).  The
  state pytree is flattened to leaves, split into bounded parts, and
  streamed as sequential ``handoff`` RPCs with a per-leaf crc32
  manifest; the successor installs the expert and declares the uid ONLY
  after re-reading the installed state and verifying every leaf's crc —
  a bitwise-verified install.  An interrupted handoff leaves the
  successor clean (sessions expire) and the drain falls back to a
  checkpoint save, from which a restarted server rejoins.

The port of ``learning_at_home_tpu/server/lifecycle.py``: the same
wire, validation and drain sequence.  A manifest's leaves are the
``jax.tree_util`` flatten of ``{"params", "opt_state"}`` (dict keys
sorted, adam's state ``(ScaleByAdamState(count, mu, nu), EmptyState())``
with ``count`` int32, bfloat16 as ml_dtypes'), read from the backend's
host snapshot, so a manifest from either package verifies in the other;
the receiver verifies the state re-read from the backend's device.

Thread model (docs/CONCURRENCY.md invariant 10): the whole drain
sequence — grace sleep, quiesce polling, state snapshots, handoff RPCs —
runs on ONE dedicated ``lah-drain`` host thread.  The serving loop's
only involvement is plain attribute reads (the lifecycle flag in the
heartbeat task) and the single-threaded handoff-session dict mutated
inside the ``handoff`` RPC handler; no new locks touch the serving loop.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import time
import uuid
import zlib
from typing import TYPE_CHECKING, Any, Optional, Sequence

import numpy as np

from learning_at_home_tpu_torch.tree import jax_tree_leaves, jax_tree_unflatten

if TYPE_CHECKING:
    from learning_at_home_tpu_torch.server.expert_backend import ExpertBackend
    from learning_at_home_tpu_torch.server.server import Server

logger = logging.getLogger(__name__)

Endpoint = tuple[str, int]


def _monotonic() -> float:
    """Clock seam — the lah-verify explorer replays drain/handoff
    sequences on a virtual clock (deterministic session-TTL expiry and
    quiesce deadlines across interleavings)."""
    return time.monotonic()


def _sleep(seconds: float) -> None:
    """Sleep seam — under the explorer, a drain 'sleep' is a scheduling
    point (advance the virtual clock, maybe switch actors), not a wall
    wait."""
    time.sleep(seconds)


# Machine-checked invariants (lah-verify shape: (name, what is
# asserted)); enforced by the explorer's lifecycle world against a real
# run_drain / HandoffReceiver driven through the seams above.
VERIFIED_INVARIANTS = (
    ("lifecycle.drain_no_abort",
     "a drain that quiesced in budget never retires an expert while the "
     "server still reports in-flight batches — draining waits, it never "
     "aborts work"),
    ("lifecycle.finish_drain_always",
     "_finish_drain runs on every drain path, success or failure — the "
     "server can never be wedged in DRAINING"),
    ("lifecycle.no_state_dropped",
     "every expert is handed off, checkpointed, or explicitly reported "
     "failed — no training state silently vanishes in a drain"),
    ("lifecycle.handoff_sessions_bounded",
     "the receiver never holds more than MAX_SESSIONS half-open "
     "sessions, and abandoned sessions are TTL-garbage-collected"),
    ("lifecycle.migrate_handoff_before_retire",
     "a live placement migration retires the source copy only after the "
     "successor acked a bitwise-verified install — the uid's hoster "
     "count never dips below its pre-move value"),
    ("lifecycle.migrate_failure_keeps_source",
     "a migration whose handoff failed leaves the source copy hosted "
     "and serving — a failed move degrades to no move, never to a lost "
     "expert or a dropped in-flight dispatch"),
)

# Lifecycle states a server advertises (stats RPC + telemetry extras;
# lah_top renders them).  DEAD is never self-reported — it is the
# observer-side verdict when a peer's telemetry record expired.
SERVING = "SERVING"
DRAINING = "DRAINING"
DRAINED = "DRAINED"

# One handoff part carries at most this many payload bytes (whole leaves
# are never split — a leaf larger than the cap travels alone in its own
# part; MAX_FRAME_BYTES is 1 GiB, so the cap is flow control, not a
# correctness bound).  Parts are sent SEQUENTIALLY — each awaited before
# the next — so receiver-side assembly needs no reordering and the
# transfer never floods the successor's serving loop.
HANDOFF_PART_BYTES = int(
    os.environ.get("LAH_HANDOFF_PART_BYTES", str(4 << 20))
)

# A half-assembled handoff session whose sender died is garbage-collected
# after this long (lazily, on the next handoff RPC — an idle server holds
# no timer for it).
HANDOFF_SESSION_TTL_S = float(
    os.environ.get("LAH_HANDOFF_SESSION_TTL_S", "60")
)


class HandoffError(RuntimeError):
    """A live migration failed (peer refused, transfer interrupted, or
    verification mismatched).  The drain falls back to checkpointing the
    expert so a restart can still recover it."""


# --------------------------------------------------------------------------
# state <-> wire: flatten, manifest, verify
# --------------------------------------------------------------------------


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def flatten_state(state: dict) -> tuple[list, list]:
    """``ExpertBackend.state_dict()`` → (leaves, manifest).

    Only ``params`` and ``opt_state`` travel as tensors (``update_count``
    rides in the RPC meta).  The manifest carries one
    ``{"shape", "dtype", "crc"}`` entry per leaf — the bitwise contract
    the successor verifies AFTER install, by re-reading its own installed
    state.  Leaf order is the deterministic ``jax.tree_util`` flatten of
    ``{"params", "opt_state"}``; both sides host the same expert zoo
    (the replica-recipe contract), so their tree structures agree — and
    any mismatch is caught leaf-by-leaf against the receiver's template.
    """
    leaves = [
        np.asarray(leaf)
        for leaf in jax_tree_leaves(
            {"params": state["params"], "opt_state": state["opt_state"]}
        )
    ]
    manifest = [
        {
            "shape": [int(d) for d in leaf.shape],
            "dtype": str(leaf.dtype),
            "crc": _leaf_crc(leaf),
        }
        for leaf in leaves
    ]
    return leaves, manifest


def split_parts(leaves: Sequence[np.ndarray], part_bytes: int) -> list[list[int]]:
    """Greedy leaf-index grouping: each part stays under ``part_bytes``
    unless a single leaf alone exceeds it.  Always at least one part —
    an expert with zero-size state still completes the RPC sequence."""
    parts: list[list[int]] = []
    current: list[int] = []
    current_bytes = 0
    for i, leaf in enumerate(leaves):
        n = int(leaf.nbytes)
        if current and current_bytes + n > part_bytes:
            parts.append(current)
            current, current_bytes = [], 0
        current.append(i)
        current_bytes += n
    parts.append(current)
    return parts


def verify_manifest(leaves: Sequence[np.ndarray], manifest: Sequence[dict]) -> bool:
    """True iff every leaf matches its manifest entry bitwise."""
    if len(leaves) != len(manifest):
        return False
    for leaf, entry in zip(leaves, manifest):
        if list(leaf.shape) != list(entry["shape"]):
            return False
        if str(leaf.dtype) != entry["dtype"]:
            return False
        if _leaf_crc(leaf) != entry["crc"]:
            return False
    return True


# --------------------------------------------------------------------------
# sender side (runs on the lah-drain host thread)
# --------------------------------------------------------------------------


def send_expert_handoff(
    successor: Endpoint,
    uid: str,
    state: dict,
    *,
    timeout: float = 60.0,
    part_bytes: Optional[int] = None,
) -> dict:
    """Stream one expert's state to ``successor`` and return the final
    reply meta.  Raises :class:`HandoffError` unless the successor
    reports a bitwise-verified install.

    Runs on a HOST thread (the drain thread): payloads are serialized
    here via ``WireTensors.prepare`` and only the ready buffers cross
    the ``lah-client`` loop (``rpc_prepared`` — the pack-once contract).
    The wire is the RAW v1/v2 tensor framing with no ``wire`` meta: a
    quantized codec would break the bitwise contract by construction.
    """
    from learning_at_home_tpu_torch.client.rpc import client_loop, pool_registry
    from learning_at_home_tpu_torch.utils.connection import RemoteCallError
    from learning_at_home_tpu_torch.utils.serialization import WireTensors

    part_bytes = HANDOFF_PART_BYTES if part_bytes is None else part_bytes
    leaves, manifest = flatten_state(state)
    parts = split_parts(leaves, part_bytes)
    session = uuid.uuid4().hex[:16]
    pool = pool_registry().get(tuple(successor))
    final_meta: dict = {}
    for part_idx, leaf_idxs in enumerate(parts):
        meta = {
            "uid": uid,
            "session": session,
            "part": part_idx,
            "n_parts": len(parts),
        }
        if part_idx == 0:
            # the manifest travels once, up front: the receiver can
            # reject a structurally impossible transfer before buffering
            # a single payload part
            meta["manifest"] = manifest
            meta["update_count"] = int(state.get("update_count", 0))
        wire = WireTensors.prepare([leaves[i] for i in leaf_idxs])
        try:
            _tensors, reply = client_loop().run(
                pool.rpc_prepared("handoff", wire, meta, timeout=timeout)
            )
        # asyncio.TimeoutError is NOT builtins.TimeoutError on 3.10 —
        # missing it here would skip the checkpoint fallback
        except (
            RemoteCallError, OSError, TimeoutError, asyncio.TimeoutError,
        ) as e:
            raise HandoffError(
                f"handoff of {uid} to {successor} failed at part "
                f"{part_idx + 1}/{len(parts)}: {type(e).__name__}: {e}"
            ) from e
        final_meta = reply if isinstance(reply, dict) else {}
    if not (final_meta.get("installed") and final_meta.get("verified")):
        raise HandoffError(
            f"handoff of {uid} to {successor}: successor did not report a "
            f"verified install (reply meta: {final_meta})"
        )
    return final_meta


def run_migration(
    server: "Server", uid: str, successor: Endpoint, *,
    timeout: float = 60.0,
) -> dict:
    """Move ONE serving expert to ``successor`` — the placement
    rebalancer's actuation primitive (ISSUE 16; the ``migrate`` RPC's
    background thread runs this).

    Ordering is run_drain's per-uid success path, without the drain:
    hand off first, retire the source copy only after the successor's
    bitwise-verified install acked.  The source keeps SERVING the uid
    through the whole transfer, so its hoster count never dips below
    the pre-move value and dispatches in flight complete on whichever
    copy holds them (VERIFIED_INVARIANTS: migrate_handoff_before_retire,
    migrate_failure_keeps_source — the lah-verify migration world
    explores exactly these interleavings).  A failed handoff raises
    :class:`HandoffError` with the source untouched: a failed move
    degrades to no move.

    The handed-off state is the source's live snapshot at send time;
    updates landing during the transfer stay on the source copy until
    retire — the same bounded-staleness window a drain's quiesce timeout
    accepts, and replica averaging reconverges it.
    """
    backend = server.experts.get(uid)
    if backend is None:
        raise ValueError(f"migrate: uid {uid!r} is not hosted here")
    try:
        send_expert_handoff(
            tuple(successor), uid, backend.state_dict(), timeout=timeout
        )
    except Exception:
        server.migration_failures += 1
        raise
    server._retire_expert(uid)
    server.migrations_out += 1
    logger.info("migrated %s -> %s:%s", uid, successor[0], successor[1])
    return {"uid": uid, "target": list(successor), "handed_off": True,
            "retired": True}


# --------------------------------------------------------------------------
# receiver side (serving loop; heavy work hops to worker threads)
# --------------------------------------------------------------------------


class _HandoffSession:
    __slots__ = (
        "uid", "n_parts", "manifest", "update_count", "leaves",
        "next_part", "created_at",
    )

    def __init__(self, uid: str, n_parts: int, manifest: list,
                 update_count: int):
        self.uid = uid
        self.n_parts = n_parts
        self.manifest = manifest
        self.update_count = update_count
        self.leaves: list = []
        self.next_part = 0
        self.created_at = _monotonic()


class HandoffReceiver:
    """Per-server assembly of inbound expert migrations.

    All session-dict mutation happens ON the serving loop (the
    ``handoff`` RPC handler), which is single-threaded — no lock, same
    contract as ``Server._replicas_installing``.  The expensive finalize
    (backend build, state load, crc re-verification) hops to a worker
    thread; only the pool start + DHT declare return to the loop.
    """

    MAX_SESSIONS = 16  # concurrent half-open migrations; more is abuse

    def __init__(self, server: "Server"):
        self.server = server
        self._sessions: dict[str, _HandoffSession] = {}
        self.received = 0       # verified installs
        self.rejected = 0       # refused / failed / mismatched transfers

    def _gc(self) -> None:
        now = _monotonic()
        for key in [
            k for k, s in self._sessions.items()
            if now - s.created_at > HANDOFF_SESSION_TTL_S
        ]:
            stale = self._sessions.pop(key)
            logger.warning(
                "handoff session for %s abandoned after %.0fs — sender "
                "died mid-transfer; dropping %d buffered leaves",
                stale.uid, now - stale.created_at, len(stale.leaves),
            )

    async def handle_part(self, meta: dict, tensors: Sequence) -> dict:
        """One ``handoff`` RPC.  Peer-supplied meta — validate
        structurally; any failure raises ``ValueError`` which the
        connection handler turns into an error reply (the sender's
        :class:`HandoffError` path)."""
        self._gc()
        srv = self.server
        if srv.lifecycle_state != SERVING:
            self.rejected += 1
            raise ValueError(
                f"server is {srv.lifecycle_state}: a draining server "
                "cannot accept expert migrations"
            )
        uid = meta.get("uid")
        session_id = meta.get("session")
        part = meta.get("part")
        n_parts = meta.get("n_parts")
        if not (isinstance(uid, str) and uid):
            raise ValueError("handoff needs a uid")
        if not (isinstance(session_id, str) and 0 < len(session_id) <= 64):
            raise ValueError("handoff needs a session id")
        if not (
            isinstance(part, int) and isinstance(n_parts, int)
            and 0 <= part < n_parts
        ):
            raise ValueError("handoff part indices are inconsistent")
        key = f"{uid}/{session_id}"
        if part == 0:
            manifest = meta.get("manifest")
            if not isinstance(manifest, list) or not all(
                isinstance(m, dict) for m in manifest
            ):
                raise ValueError("handoff part 0 must carry the manifest")
            if len(self._sessions) >= self.MAX_SESSIONS:
                self.rejected += 1
                raise ValueError("too many concurrent handoff sessions")
            if uid in srv._replicas_installing:
                self.rejected += 1
                raise ValueError(
                    f"an install for {uid} is already in flight"
                )
            self._sessions[key] = _HandoffSession(
                uid, n_parts, manifest,
                int(meta.get("update_count") or 0),
            )
        session = self._sessions.get(key)
        if session is None:
            raise ValueError(
                f"unknown handoff session for {uid} (expired or never "
                "opened with part 0)"
            )
        if part != session.next_part or n_parts != session.n_parts:
            del self._sessions[key]
            raise ValueError(
                f"handoff part {part} arrived out of order "
                f"(expected {session.next_part})"
            )
        session.leaves.extend(np.asarray(t) for t in tensors)
        session.next_part += 1
        if len(session.leaves) > len(session.manifest):
            del self._sessions[key]
            raise ValueError("handoff carries more leaves than its manifest")
        if session.next_part < session.n_parts:
            return {"uid": uid, "session": session_id, "part": part,
                    "ok": True}
        # final part: install + verify, then declare
        del self._sessions[key]
        return await self._finalize(session)

    async def _finalize(self, session: _HandoffSession) -> dict:
        srv = self.server
        uid = session.uid
        if len(session.leaves) != len(session.manifest):
            self.rejected += 1
            raise ValueError(
                f"handoff for {uid} delivered {len(session.leaves)} leaves, "
                f"manifest promises {len(session.manifest)}"
            )
        if uid in srv._replicas_installing:
            # a second session for the uid raced this finalize (its own
            # part-0 check predates our install window): refuse — two
            # concurrent installs would leak one session's started pools
            self.rejected += 1
            raise ValueError(f"an install for {uid} is already in flight")
        existing = srv.experts.get(uid)
        srv._replicas_installing.add(uid)
        try:
            backend, verified = await asyncio.to_thread(
                self._install_state, existing, session
            )
            if not verified:
                self.rejected += 1
                raise ValueError(
                    f"handoff for {uid}: installed state failed bitwise "
                    "verification against the sender's manifest"
                )
            if existing is None:
                # new expert: pools + immediate declare (the successor
                # declares the uid ONLY here, after verification)
                await srv._install_replica(uid, backend, replica=False)
            else:
                # the uid was already hosted (e.g. as a replica): the
                # migrated state — the most-trained copy — replaced it
                # in place; re-declare so the record is fresh
                await srv._declare_now(uid)
            srv.migrated_in.add(uid)
            self.received += 1
        finally:
            srv._replicas_installing.discard(uid)
        logger.info("handoff: installed migrated expert %s (verified)", uid)
        return {
            "uid": uid, "ok": True, "installed": True, "verified": True,
            "hosted": True,
        }

    def _install_state(
        self, existing: Optional["ExpertBackend"], session: _HandoffSession
    ) -> tuple["ExpertBackend", bool]:
        """Worker-thread half of finalize: build-or-reuse the backend,
        load the migrated leaves, and re-read the installed state to
        verify the manifest bitwise.  Shape/dtype validation runs
        against the receiver's OWN template (never trusting the wire).
        The re-read is ``state_dict()``: a host copy of the tensors the
        backend serves from, on its device."""
        srv = self.server
        backend = existing
        if backend is None:
            backend = srv._make_replica_backend(
                session.uid, allow_checkpoint=False
            )
        template = backend.state_template()
        structure = {"params": template["params"],
                     "opt_state": template["opt_state"]}
        t_leaves = jax_tree_leaves(structure)
        if len(t_leaves) != len(session.leaves):
            raise ValueError(
                f"migrated state for {session.uid} has "
                f"{len(session.leaves)} leaves; this server's zoo "
                f"template has {len(t_leaves)} — expert zoo mismatch"
            )
        for got, want in zip(session.leaves, t_leaves):
            if tuple(got.shape) != tuple(want.shape) or np.dtype(
                got.dtype
            ) != np.dtype(want.dtype):
                raise ValueError(
                    f"migrated leaf {got.shape}/{got.dtype} does not "
                    f"match template {want.shape}/{want.dtype} for "
                    f"{session.uid}"
                )
        tree = jax_tree_unflatten(structure, session.leaves)
        # the port's addition: a ReplicaSync round of this uid must not
        # write a group mean over the install, between install and
        # re-read, or over a rollback; the sync keeps running after the
        # window (a round that read the params before it is dropped)
        sync = srv._replica_syncs.get(session.uid)
        with sync.exclusive() if sync is not None else contextlib.nullcontext():
            # an EXISTING backend is live state: snapshot it first so a
            # failed verification can roll back — the bitwise-or-it-failed
            # contract must hold in the failure case too, not replace a
            # good replica with unverified bytes
            previous = existing.state_dict() if existing is not None else None
            backend.load_state_dict(
                {
                    "params": tree["params"],
                    "opt_state": tree["opt_state"],
                    "update_count": session.update_count,
                }
            )
            # bitwise verification of the INSTALLED state: re-read what
            # the backend will actually serve and check it against the
            # sender's manifest — a device_put round-trip that mangled a
            # single byte fails the transfer instead of silently serving
            # corrupt weights
            installed = backend.state_dict()
            leaves = [
                np.asarray(leaf)
                for leaf in jax_tree_leaves(
                    {"params": installed["params"],
                     "opt_state": installed["opt_state"]}
                )
            ]
            verified = verify_manifest(leaves, session.manifest)
            if not verified and previous is not None:
                backend.load_state_dict(previous)
                logger.warning(
                    "handoff for %s failed verification — existing state "
                    "rolled back", session.uid,
                )
        return backend, verified

    def stats(self) -> dict:
        return {
            "sessions_open": len(self._sessions),
            "received": self.received,
            "rejected": self.rejected,
        }


# --------------------------------------------------------------------------
# drain coordinator (runs on the lah-drain host thread)
# --------------------------------------------------------------------------


def pick_successor(server: "Server") -> Optional[Endpoint]:
    """Least-loaded peer from the ``load.<prefix>`` DHT heartbeats
    (queue depth, then hosted-expert count, then endpoint for
    determinism), excluding this server.  None when the swarm has no
    other advertised server — the drain then falls back to checkpoint."""
    if server.dht is None:
        return None
    from learning_at_home_tpu_torch.utils.telemetry import load_key, parse_load_value

    own = f"{server.endpoint[0]}:{server.endpoint[1]}"
    candidates = []
    try:
        records = server.dht.get_sync(load_key(server.telemetry_prefix))
    except Exception as e:
        logger.warning("successor discovery failed: %s: %s",
                       type(e).__name__, e)
        return None
    for subkey, entry in records.items():
        if not isinstance(subkey, str) or subkey == own:
            continue
        value = entry[0] if isinstance(entry, (tuple, list)) else entry
        load = parse_load_value(value)
        host, _, port = subkey.rpartition(":")
        if load is None or not port.isdigit() or not host:
            continue
        candidates.append(
            (load.get("q", 0.0), load.get("n", 0), (host, int(port)))
        )
    if not candidates:
        return None
    return min(candidates)[2]


def run_drain(
    server: "Server",
    *,
    successor: Optional[Endpoint] = None,
    grace: Optional[float] = None,
    quiesce_timeout: float = 30.0,
    handoff: bool = True,
    handoff_timeout: float = 60.0,
) -> dict:
    """The full graceful-drain sequence; returns a summary dict.

    1. flip to DRAINING — the heartbeat task stops re-declaring experts
       (telemetry keeps heartbeating so observers see the state);
    2. keep serving for ``grace`` seconds (default: the declared record
       TTL, ``2 x update_period``) so every record published before the
       flip expires and clients steer away;
    3. quiesce — poll until every task pool and the runtime queue are
       empty (bounded by ``quiesce_timeout``; a busy server drains its
       in-flight batches, it never aborts them);
    4. migrate every expert to the successor (explicit endpoint, or the
       least-loaded peer from the load heartbeats); failures fall back
       to a checkpoint save under ``server.replica_checkpoint_root``;
    5. flip to DRAINED and report.

    Runs on a host thread (asserted via the sanitizer in
    ``Server.drain``); never call on a server loop.
    """
    t0 = _monotonic()
    summary: dict[str, Any] = {
        "handed_off": [], "checkpointed": [], "failed": [],
        "successor": None,
    }
    handoff_bytes = 0
    already = server._begin_drain()
    if already:
        raise RuntimeError("server is already draining")
    # the periodic checkpointer must NOT run through the drain: a save
    # taken while _retire_expert shrinks self.experts would write a
    # partial (or empty) step as the newest COMPLETE checkpoint, which
    # a --resume relaunch would then restore over the real state.  The
    # drain's own fallback saves through save_checkpoint directly.
    if server.checkpoint_manager is not None:
        try:
            server.checkpoint_manager.stop()
        except Exception:
            logger.exception("drain: stopping the checkpointer failed")
    try:
        if grace is None:
            grace = 2.0 * server.update_period if server.dht is not None else 0.0
        if grace > 0:
            logger.info(
                "drain: serving through the %.1fs record-expiry grace "
                "window", grace,
            )
            _sleep(grace)
        quiesce_deadline = _monotonic() + max(0.0, quiesce_timeout)
        settled = 0
        while _monotonic() < quiesce_deadline:
            if server.pools_idle():
                settled += 1
                if settled >= 3:  # idle across consecutive polls, not a gap
                    break
            else:
                settled = 0
            _sleep(max(server.batch_timeout, 0.02))
        else:
            logger.warning(
                "drain: pools still busy after %.1fs quiesce budget — "
                "handing off anyway (late updates stay on this copy)",
                quiesce_timeout,
            )
        if handoff and server.experts:
            target = tuple(successor) if successor else pick_successor(server)
            summary["successor"] = list(target) if target else None
            if target is None:
                logger.warning(
                    "drain: no successor available — falling back to "
                    "checkpoint for all %d experts", len(server.experts),
                )
            else:
                t_handoff = _monotonic()
                for uid in sorted(server.experts):
                    backend = server.experts.get(uid)
                    if backend is None:
                        continue
                    # catch EVERYTHING per expert: one snapshot/retire
                    # failure must not abort the other migrations, and
                    # the checkpoint fallback below must still run for
                    # whatever did not make it across
                    try:
                        state = backend.state_dict()
                        send_expert_handoff(
                            target, uid, state, timeout=handoff_timeout,
                        )
                        summary["handed_off"].append(uid)
                        server._retire_expert(uid)
                        handoff_bytes += sum(
                            np.asarray(leaf).nbytes for leaf in
                            jax_tree_leaves([state["params"],
                                             state["opt_state"]]))
                    except HandoffError as e:
                        logger.warning("drain: %s", e)
                        summary["failed"].append(uid)
                    except Exception:
                        logger.exception(
                            "drain: handoff of %s failed unexpectedly", uid
                        )
                        summary["failed"].append(uid)
                # the port's addition: the handoffs' wall time and bytes
                summary["handoff_s"] = round(_monotonic() - t_handoff, 3)
                summary["handoff_bytes"] = handoff_bytes
        remaining = [
            uid for uid in sorted(server.experts)
            if uid not in summary["handed_off"]
        ]
        if remaining:
            root = server.replica_checkpoint_root
            if root:
                try:
                    step = server.save_checkpoint(root)
                    summary["checkpointed"] = remaining
                    summary["checkpoint_step"] = step
                except Exception:
                    logger.exception(
                        "drain: fallback checkpoint failed — %d experts "
                        "will restart from an older step (or the seed)",
                        len(remaining),
                    )
            else:
                logger.warning(
                    "drain: %d experts have no successor and no checkpoint "
                    "root — their training state dies with this process",
                    len(remaining),
                )
    finally:
        server._finish_drain()
    summary["duration_s"] = round(_monotonic() - t0, 3)
    logger.info(
        "drain complete in %.1fs: %d handed off, %d checkpointed, %d failed",
        summary["duration_s"], len(summary["handed_off"]),
        len(summary["checkpointed"]), len(summary["failed"]),
    )
    return summary
