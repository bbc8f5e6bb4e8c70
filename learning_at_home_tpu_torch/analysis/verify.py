"""lah-verify: deterministic interleaving model checker for the
post-PR-6 concurrent subsystems (ISSUE 14).

Where lah-lint (analysis/lint.py) checks what the SOURCE says, this
module checks what the CODE DOES: it drives the real
``gateway/scheduler.py`` continuous-batching loop and the real
``server/lifecycle.py`` drain/handoff flow through systematically
permuted operation orders on a virtual clock, asserting the declarative
invariants each module registers next to its code
(``VERIFIED_INVARIANTS`` in gateway/scheduler.py, models/kv_pages.py,
server/lifecycle.py — docs/CONCURRENCY.md lists them all).

Three design decisions keep this bounded and deterministic:

- **operation granularity** — the unit of interleaving is one scheduler
  phase (`_admit_pending`, `_prefill_chunks`, ...), one client action
  (submit / cancel / clock-jump), or one drain segment, run to
  completion on the calling thread.  No real threads run during
  exploration, so every schedule is exactly reproducible: the explored
  subsystems already serialize cross-thread interaction behind the
  ``gateway.streams`` lock / the single ``lah-drain`` thread, which is
  what makes phase-order the interesting nondeterminism.
- **DPOR-style pruning** — each op's shared-site footprint (the named
  sanitizer locks it acquires, learned live through
  :func:`sanitizer.set_lock_observer`) marks which op pairs can
  interact.  Two adjacent ops with disjoint footprints commute, so only
  one of their two orders is explored.  Unknown footprints (first
  encounter, or sanitizer disabled) are conservatively treated as
  conflicting — pruning can only shrink, never skip, the first
  exploration of an op pair.
- **replay, not snapshot** — schedules are executed from a freshly
  built world each time (state snapshotting of live schedulers is not a
  thing); the explorer enumerates schedules depth-first in an order
  fully determined by ``seed``, so the same seed always reports the
  same first failing interleaving with the same op trace.

Seeded-bug validation (:func:`seeded_bug_validation`) mechanically
re-introduces both PR-13 scheduler races — the stale prefill-snapshot
after a mid-pass preemption, and the mutual-preemption livelock an
exclude-the-raiser victim rule creates — and asserts the explorer finds
each one deterministically.  The gate (tools/collect_gate.py --verify)
fails when the merged tree trips any invariant OR when a seeded bug is
no longer found (the checker itself regressed).

CLI: ``python tools/lah_verify.py`` (see that module for flags).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Optional

from learning_at_home_tpu_torch.utils import sanitizer

# --------------------------------------------------------------------------
# generic explorer
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Violation:
    """One invariant failure on one explored schedule."""

    world: str
    invariant: str
    detail: str
    trace: tuple  # op labels in executed order, up to the failure
    schedule_index: int

    def __str__(self) -> str:
        return (
            f"[{self.world}] {self.invariant}: {self.detail}\n"
            f"    schedule #{self.schedule_index}: {' -> '.join(self.trace)}"
        )


@dataclasses.dataclass
class ExplorationResult:
    world: str
    schedules_run: int
    schedules_pruned: int
    violations: list

    @property
    def clean(self) -> bool:
        return not self.violations


class _FootprintObserver:
    """Accumulates the named locks the currently running op touches."""

    def __init__(self):
        self.current: Optional[set] = None

    def __call__(self, _event: str, name: str) -> None:
        if self.current is not None:
            self.current.add(name)


def _conflicts(a: Optional[frozenset], b: Optional[frozenset]) -> bool:
    """Unknown footprints (None) conservatively conflict."""
    if a is None or b is None:
        return True
    return bool(a & b)


def _schedule_stream(counts: list, order: list, footprints: dict):
    """Yield complete schedules (tuples of actor indices) depth-first.

    ``order`` (a seed-derived permutation of actor indices) fixes both
    the branch priority and therefore the full exploration order.
    Pruning: candidate actor ``b`` is skipped immediately after actor
    ``a``'s op when ``b`` has lower priority than ``a`` AND the two ops'
    footprints are disjoint — the swapped (equivalent) order is reached
    through the branch that schedules ``b`` first.  ``footprints`` is
    read live, so knowledge learned from earlier schedules prunes later
    ones.  Yields (schedule, pruned_count_delta)."""
    priority = {a: i for i, a in enumerate(order)}
    total = sum(counts)
    # stack entries: (ptrs tuple, prefix tuple, last (actor, op_idx) | None)
    stack = [(tuple([0] * len(counts)), (), None)]
    while stack:
        ptrs, prefix, last = stack.pop()
        if len(prefix) == total:
            yield prefix, 0
            continue
        pruned = 0
        children = []
        for a in order:
            if ptrs[a] >= counts[a]:
                continue
            if last is not None:
                la, lop = last
                if la != a and priority[a] < priority[la] and not _conflicts(
                    footprints.get((la, lop)),
                    footprints.get((a, ptrs[a])),
                ):
                    pruned += 1
                    continue
            nxt = list(ptrs)
            nxt[a] += 1
            children.append((tuple(nxt), prefix + (a,), (a, ptrs[a])))
        if pruned:
            yield None, pruned
        # reversed: the highest-priority child is popped (explored) first
        for child in reversed(children):
            stack.append(child)


def explore(
    world_factory: Callable[[], "object"],
    *,
    seed: int = 0,
    max_schedules: int = 200,
) -> ExplorationResult:
    """Run every (pruned) interleaving of the world's actor op
    sequences, up to ``max_schedules``, checking invariants after every
    op and once more at the end.  Stops at the first violating schedule
    — its trace is the reproducer."""
    probe = world_factory()
    counts = [len(ops) for ops in probe.actors()]
    name = probe.name
    probe_close = getattr(probe, "close", None)
    if probe_close is not None:
        probe_close()
    # actor priority: rotate by seed — deterministic for a given seed,
    # different seeds walk the schedule space in different orders
    n = len(counts)
    order = [(i + seed) % n for i in range(n)]
    footprints: dict = {}
    observer = _FootprintObserver()
    result = ExplorationResult(name, 0, 0, [])
    sanitizer.set_lock_observer(observer)
    try:
        for schedule, pruned in _schedule_stream(counts, order, footprints):
            result.schedules_pruned += pruned
            if schedule is None:
                continue
            if result.schedules_run >= max_schedules:
                break
            result.schedules_run += 1
            world = world_factory()
            actors = world.actors()
            ptrs = [0] * len(actors)
            trace: list = []
            try:
                for a in schedule:
                    label, fn = actors[a][ptrs[a]]
                    key = (a, ptrs[a])
                    ptrs[a] += 1
                    trace.append(label)
                    observer.current = set()
                    try:
                        fn()
                    finally:
                        fp = frozenset(observer.current)
                        observer.current = None
                        # Footprints are trustworthy ONLY while the
                        # sanitizer's tracked locks feed the observer
                        # (LAH_SANITIZE=1) — otherwise every op would
                        # look lock-free and hence spuriously commuting.
                        # They only ever grow (union across schedules):
                        # a lock touched on ANY path is part of the op's
                        # potential footprint.
                        if getattr(sanitizer, "_ENABLED", False):
                            prev = footprints.get(key)
                            footprints[key] = (
                                fp if prev is None else prev | fp
                            )
                    leaks = world.check()
                    if leaks:
                        result.violations.extend(
                            Violation(name, _leak_invariant(leak), leak,
                                      tuple(trace),
                                      result.schedules_run - 1)
                            for leak in leaks
                        )
                        break
                else:
                    for leak in world.final():
                        result.violations.append(
                            Violation(name, _leak_invariant(leak), leak,
                                      tuple(trace),
                                      result.schedules_run - 1)
                        )
            finally:
                close = getattr(world, "close", None)
                if close is not None:
                    close()
            if result.violations:
                break
    finally:
        sanitizer.clear_lock_observer()
    return result


def _leak_invariant(leak: str) -> str:
    """Audit strings lead with their invariant short-name ('slot_unique:
    ...'); map them onto the registered dotted names where possible."""
    head = leak.split(":", 1)[0].strip()
    for name, _desc, _mod in collect_invariants():
        if name.split(".", 1)[-1] == head:
            return name
    return head


# --------------------------------------------------------------------------
# invariant registry
# --------------------------------------------------------------------------


def collect_invariants() -> list:
    """Every (name, description, module) registered next to the code it
    describes — the table docs/CONCURRENCY.md 'Verified invariants'
    mirrors."""
    from learning_at_home_tpu_torch.gateway import scheduler as _sched
    from learning_at_home_tpu_torch.models import kv_pages as _kv
    from learning_at_home_tpu_torch.server import lifecycle as _lc

    out = []
    for mod in (_sched, _kv, _lc):
        for name, desc in getattr(mod, "VERIFIED_INVARIANTS", ()):
            out.append((name, desc, mod.__name__))
    return out


# --------------------------------------------------------------------------
# gateway world: the real SlotScheduler over a page-accurate fake decoder
# --------------------------------------------------------------------------


class _FakePagedDecoder:
    """Token-arithmetic stand-in for SwarmKVDecoder backed by a REAL
    :class:`PagedKVCache`: all slot/page bookkeeping is the production
    code path (alloc, map_shared, refcounts, prefix registry, release),
    only the trunk math is replaced by deterministic token arithmetic —
    exploration never touches a card (the pools are small CPU tensors).
    Mirrors the
    real decoder's contract exactly, including raising on a
    ``prefill_step`` against a slot that is not mid-prefill (the call
    pattern only a stale scheduler snapshot produces)."""

    supports_chunked_prefill = True

    def __init__(self, *, max_slots=2, seq_len=8, page_len=2,
                 num_pages=5, prefix_cache=False):
        import numpy as np
        import torch

        from learning_at_home_tpu_torch.models.kv_pages import PagedKVCache

        self.max_slots = int(max_slots)
        self.seq_len = int(seq_len)
        self.kv = PagedKVCache(
            n_layers=1, n_heads=1, head_dim=1, dtype=torch.float32,
            max_slots=max_slots, seq_len=seq_len, page_len=page_len,
            num_pages=num_pages, enable_prefix_cache=prefix_cache,
            device="cpu",
        )
        self._np = np
        self.pos = np.zeros(self.max_slots, np.int32)
        self.live = np.zeros(self.max_slots, bool)
        self.prefilling = np.zeros(self.max_slots, bool)
        self._prefill_prompt: list = [None] * self.max_slots
        self.stream_ids: list = [None] * self.max_slots
        self.prefills_total = 0
        self.prefill_chunks_total = 0
        self.decode_steps_total = 0
        self.verify_rounds_total = 0
        self.last_verify: list = []

    # slot bookkeeping — same shapes as SwarmKVDecoder
    def free_slots(self):
        return [
            i for i in range(self.max_slots)
            if not self.live[i] and not self.prefilling[i]
        ]

    def live_slots(self):
        return [(i, self.stream_ids[i]) for i in range(self.max_slots)
                if self.live[i]]

    def prefilling_slots(self):
        return [(i, self.stream_ids[i]) for i in range(self.max_slots)
                if self.prefilling[i]]

    def busy_slots(self):
        return [i for i in range(self.max_slots)
                if self.live[i] or self.prefilling[i]]

    def at_capacity(self, slot):
        return int(self.pos[slot]) >= self.seq_len

    def evict(self, slot):
        self.live[slot] = False
        self.prefilling[slot] = False
        self._prefill_prompt[slot] = None
        self.stream_ids[slot] = None
        self.pos[slot] = 0
        self.kv.release_slot(slot)

    def pages_needed(self, prompt_len, max_new_tokens=0):
        total = min(int(prompt_len) + int(max_new_tokens), self.seq_len)
        return self.kv.pages_needed(total)

    def free_page_headroom(self):
        active = int((self.live | self.prefilling).sum())
        return self.kv.pages_free() + self.kv.pages_reclaimable() - active

    def kv_stats(self):
        return self.kv.stats()

    def _tok(self, slot) -> int:
        # deterministic pseudo-token from the slot's position
        return int(self.pos[slot]) * 7 % 251

    def begin_prefill(self, slot, prompt_ids, stream_id=None,
                      sampling=None) -> int:
        if self.live[slot] or self.prefilling[slot]:
            raise ValueError(f"slot {slot} is occupied")
        prompt = [int(t) for t in prompt_ids]
        if not 0 < len(prompt) < self.seq_len:
            raise ValueError("bad prompt length")
        from learning_at_home_tpu_torch.models.kv_pages import PagePressure

        full, partial = self.kv.prefix_lookup(prompt)
        matched = 0
        try:
            for e in full:
                self.kv.map_shared(slot, e)
            matched = len(full) * self.kv.page_len
            if partial is not None:
                e, r = partial
                dst = self.kv.alloc_slot_page(slot)
                self.kv.copy_page_rows(e.page_id, dst, r)
                matched += r
        except PagePressure:
            self.kv.release_slot(slot)
            raise
        self.prefilling[slot] = True
        self._prefill_prompt[slot] = prompt
        self.pos[slot] = matched
        self.stream_ids[slot] = stream_id
        return matched

    def prefill_step(self, slot, max_tokens):
        if not self.prefilling[slot]:
            raise ValueError(f"slot {slot} is not mid-prefill")
        prompt = self._prefill_prompt[slot]
        p = len(prompt)
        start = int(self.pos[slot])
        c = min(int(max_tokens), p - start)
        pages = self.kv.pages_needed(start + c)
        while int(self.kv.alloc_count[slot]) < pages:
            self.kv.alloc_slot_page(slot)  # may raise PagePressure
        self.pos[slot] = start + c
        self.prefill_chunks_total += 1
        if start + c < p:
            return c, None
        self.kv.register_prefix(slot, prompt)
        self.live[slot] = True
        self.prefilling[slot] = False
        self._prefill_prompt[slot] = None
        self.prefills_total += 1
        return c, self._tok(slot)

    def ensure_decode_pages(self):
        from learning_at_home_tpu_torch.models.kv_pages import PagePressure

        lacking = []
        for s in range(self.max_slots):
            if not self.live[s] or self.at_capacity(s):
                continue
            logical = int(self.pos[s]) // self.kv.page_len
            while int(self.kv.alloc_count[s]) <= logical:
                try:
                    self.kv.alloc_slot_page(s)
                except PagePressure:
                    lacking.append(s)
                    break
        return lacking

    def decode_step(self):
        nxt = self._np.zeros(self.max_slots, self._np.int32)
        for s in range(self.max_slots):
            if self.live[s]:
                nxt[s] = self._tok(s)
                self.pos[s] += 1
        self.decode_steps_total += 1
        return nxt

    # speculative contract — same shapes as SwarmKVDecoder, the trunk
    # replaced by the _tok arithmetic.  The PagedKVCache underneath is
    # REAL, so ensure_lookahead_pages allocates genuine pool pages and
    # verify_step's rollback runs the production truncate_slot with its
    # inline kv.rollback_private_only check.

    def ensure_lookahead_pages(self, slot, k) -> int:
        from learning_at_home_tpu_torch.models.kv_pages import PagePressure

        pos = int(self.pos[slot])
        top = min(pos + int(k), self.seq_len - 1)
        want = top // self.kv.page_len
        while int(self.kv.alloc_count[slot]) <= want:
            try:
                self.kv.alloc_slot_page(slot)
            except PagePressure:
                break
        covered = int(self.kv.alloc_count[slot]) * self.kv.page_len - 1
        return max(0, min(int(k), covered - pos))

    def verify_step(self, proposals: dict) -> dict:
        if not proposals:
            return {}
        out: dict = {}
        self.last_verify = []
        for s in sorted(int(x) for x in proposals):
            if not self.live[s]:
                raise ValueError(f"slot {s} is not live")
            drafts = [int(t) for t in proposals[s]]
            pos = int(self.pos[s])
            if pos + len(drafts) > self.seq_len - 1:
                raise ValueError(
                    f"slot {s}: {len(drafts)} drafts at position {pos} "
                    f"exceed the cache ({self.seq_len} positions)"
                )
            want = (pos + len(drafts)) // self.kv.page_len
            if int(self.kv.alloc_count[s]) <= want:
                raise ValueError(
                    f"slot {s} has no KV page for its lookahead — "
                    "call ensure_lookahead_pages() first"
                )
            # row j's sample is exactly what decode_step would emit at
            # position pos+j under the token arithmetic
            samples = [
                (pos + j) * 7 % 251 for j in range(len(drafts) + 1)
            ]
            a = 0
            while a < len(drafts) and drafts[a] == samples[a]:
                a += 1
            tokens = samples[:a + 1]
            self.pos[s] = pos + a + 1
            self.kv.truncate_slot(s, int(self.pos[s]))
            out[s] = {
                "tokens": tokens, "accepted": a, "proposed": len(drafts)
            }
            self.last_verify.append({
                "slot": s, "stream_id": self.stream_ids[s],
                "drafts": drafts, "samples": samples,
                "accepted": a, "tokens": list(tokens),
            })
        self.verify_rounds_total += 1
        return out


class _FakeMixedDrafter:
    """Drafter for the speculative gateway world: proposes against the
    fake decoder's token arithmetic, deterministically mixing rounds of
    full acceptance with rounds that go wrong at every possible depth —
    so exploration drives accepted prefixes of 0..k and every verify
    round exercises both spec_prefix_accept and the truncate_slot
    rollback underneath."""

    def propose(self, context, k, sampling=None):
        # the fake decoder's invariant: pos = len(context) - 1, so the
        # sample verify row j emits is (pos + j) * 7 % 251
        pos = len(context) - 1
        correct = [(pos + j) * 7 % 251 for j in range(int(k))]
        wrong_at = len(context) % (int(k) + 1)  # varies per round
        return [
            t if j < wrong_at else (t + 1) % 251
            for j, t in enumerate(correct)
        ]


# ---- mechanically reverted PR-13 scheduler code (seeded bugs) ----
#
# Both functions reproduce gateway/scheduler.py as it stood BEFORE the
# PR-13 fixes, so seeded_bug_validation can assert the explorer still
# finds each race.  Keep them in sync with the merged code apart from
# the single reverted line each — drift here silently weakens the gate.


def _prefill_chunks_stale_snapshot(self, now):
    """PR-13 bug A revert: the under-lock staleness re-check is gone —
    the pass trusts its start-of-pass prefilling_slots() snapshot even
    after a mid-pass preemption evicted one of the snapshotted slots."""
    from learning_at_home_tpu_torch.models.kv_pages import PagePressure

    if not self.chunked:
        return False
    budget = self.prefill_chunk_tokens
    slots = self.decoder.prefilling_slots()
    if not slots:
        return False
    rot = self._prefill_rr % len(slots)
    slots = slots[rot:] + slots[:rot]
    self._prefill_rr += 1
    worked = False
    for slot, sid in slots:
        if budget <= 0:
            break
        with self._lock:
            st = self._streams.get(sid)
        if st is None:
            self.decoder.evict(slot)
            continue
        if st.cancelled:
            continue
        try:
            consumed, tok = self.decoder.prefill_step(slot, budget)
        except PagePressure:
            if not self._preempt_one(now):
                break
            continue
        except Exception as e:
            self._finish(st, now, error=f"{type(e).__name__}: {e}")
            continue
        budget -= consumed
        worked = True
        if tok is not None:
            self._stream_got_token(st, slot, tok, now)
    return worked


def _preempt_one_excluding(self, now, among=None, exclude=None):
    """PR-13 bug B revert: the pressure-raiser is excluded from the
    victim pool, so two mid-prefill streams can preempt each other
    forever (neither is ever the victim of its own pressure)."""
    with self._lock:
        if among is not None:
            pool = [st for st in among if not st.done]
        else:
            pool = [
                st for st in self._streams.values()
                if st.slot is not None and not st.done
            ]
        if exclude is not None:
            pool = [st for st in pool if st.sid != exclude.sid]
        decoding = [st for st in pool if not st.prefilling]
        candidates = decoding or pool
        if not candidates:
            return False
        victim = max(
            candidates,
            key=lambda st: st.first_token_at or st.submitted_at,
        )
    self.decoder.evict(victim.slot)
    with self._lock:
        victim.slot = None
        victim.prefilling = False
        self._pending.appendleft(victim.sid)
    self.preemptions_total += 1
    return True


def _prefill_chunks_exclude_raiser(self, now):
    """Companion to bug B: the merged _prefill_chunks except that page
    pressure preempts with the raiser excluded."""
    from learning_at_home_tpu_torch.models.kv_pages import PagePressure

    if not self.chunked:
        return False
    budget = self.prefill_chunk_tokens
    slots = self.decoder.prefilling_slots()
    if not slots:
        return False
    rot = self._prefill_rr % len(slots)
    slots = slots[rot:] + slots[:rot]
    self._prefill_rr += 1
    worked = False
    for slot, sid in slots:
        if budget <= 0:
            break
        with self._lock:
            st = self._streams.get(sid)
            stale = st is not None and (
                not st.prefilling or st.slot != slot
            )
        if st is None:
            self.decoder.evict(slot)
            continue
        if stale:
            continue
        if st.cancelled:
            continue
        try:
            consumed, tok = self.decoder.prefill_step(slot, budget)
        except PagePressure:
            if not _preempt_one_excluding(self, now, exclude=st):
                break
            continue
        except Exception as e:
            self._finish(st, now, error=f"{type(e).__name__}: {e}")
            continue
        budget -= consumed
        worked = True
        if tok is not None:
            self._stream_got_token(st, slot, tok, now)
    return worked


_LIVELOCK_PREEMPTIONS = 16
_DRAIN_ITERATIONS = 64


# The virtual clock the worlds patch over the scheduler/lifecycle
# _monotonic seams graduated into sim/clock.py (ISSUE 18): every read
# advances by ``step``, which exercises TTL/pacing branches for free.
from learning_at_home_tpu_torch.sim.clock import VirtualClock as _VirtualClock


class _GatewayWorld:
    """The real SlotScheduler (decode thread never started — its phases
    ARE the decode actor's ops) + client submit/cancel/shed ops."""

    name = "gateway"

    def __init__(self, *, seeded_bug: Optional[str] = None,
                 prefix_cache: bool = False, with_cancel: bool = False,
                 speculative: bool = False, iterations: int = 10):
        from learning_at_home_tpu_torch.gateway import scheduler as sched_mod
        from learning_at_home_tpu_torch.gateway.admission import (
            AdmissionController,
        )
        from learning_at_home_tpu_torch.gateway.scheduler import SlotScheduler

        if seeded_bug not in (None, "stale-prefill", "mutual-preemption"):
            raise ValueError(f"unknown seeded bug {seeded_bug!r}")
        self._sched_mod = sched_mod
        self._clock = _VirtualClock(step=0.001)
        self._saved_monotonic = sched_mod._monotonic
        sched_mod._monotonic = self._clock
        # the speculative world gets a deeper cache: under the 8/5 shape
        # every k=2 lookahead needs the slot's 4th page, which the pool
        # can never spare, so ensure_lookahead_pages would clamp every
        # draft to zero and verify rounds degrade to plain decode rows.
        # 12 positions / 8 pages let drafts through (mixed accept and
        # reject-with-rollback rounds) while two full-depth streams
        # still overcommit the pool (5+5 > 8), keeping the pressure,
        # preemption and clamp paths exercised.
        if speculative:
            self.name = "gateway-spec"
            decoder = _FakePagedDecoder(
                max_slots=2, seq_len=12, page_len=2, num_pages=8,
                prefix_cache=prefix_cache,
            )
        else:
            decoder = _FakePagedDecoder(
                max_slots=2, seq_len=8, page_len=2, num_pages=5,
                prefix_cache=prefix_cache,
            )
        self.sched = SlotScheduler(
            decoder, idle_wait_s=0.0, stream_ttl_s=1000.0,
            prefill_chunk_tokens=2,
            spec_k=2 if speculative else 0,
            drafter=_FakeMixedDrafter() if speculative else None,
        )
        self.admission = AdmissionController(self.sched, max_pending=2)
        if seeded_bug == "stale-prefill":
            self.sched._prefill_chunks = types.MethodType(
                _prefill_chunks_stale_snapshot, self.sched
            )
        elif seeded_bug == "mutual-preemption":
            self.sched._prefill_chunks = types.MethodType(
                _prefill_chunks_exclude_raiser, self.sched
            )
        self.with_cancel = with_cancel
        self.iterations = iterations
        self._sids: list = []
        self._shed_shape_leaks: list = []

    # -- ops --

    def _submit(self, n_prompt: int, max_new: int):
        def op():
            sid = self.sched.submit(list(range(17, 17 + n_prompt)), max_new)
            self._sids.append(sid)
        return op

    def _cancel_first(self):
        if self._sids:
            self.sched.cancel(self._sids[0])

    def _admission_probe(self):
        """Sheds must be well-formed result frames: a refusal ALWAYS
        carries a positive retry-after and a reason (PROTOCOL.md
        'Gateway RPC family')."""
        accepted, retry_after, reason = self.admission.admit(
            pages_needed=self.sched.decoder.pages_needed(6, 2)
        )
        if not accepted:
            if not (isinstance(retry_after, (int, float))
                    and retry_after > 0):
                self._shed_shape_leaks.append(
                    "shed_is_result_frame: shed reply carries no "
                    f"positive retry_after_s (got {retry_after!r})"
                )
            if not reason:
                self._shed_shape_leaks.append(
                    "shed_is_result_frame: shed reply carries no reason"
                )

    def actors(self) -> list:
        now = self._clock  # each phase samples the virtual clock
        # prompt 5 + max_new 4 against a 2-slot/4-page pool: both
        # streams overcommit the pool, so every schedule exercises page
        # pressure and preempt-and-recompute (empirically the smallest
        # shape where the PR-13 exclude-the-raiser revert livelocks
        # while the merged rule converges in ~6 preemptions)
        client = [
            ("client.submit_A", self._submit(5, 4)),
            ("client.submit_B", self._submit(5, 4)),
            ("client.shed_probe", self._admission_probe),
        ]
        if self.with_cancel:
            client.append(("client.cancel_A", self._cancel_first))
        decode = []
        for i in range(self.iterations):
            decode.extend([
                (f"gw.evict#{i}", lambda: self.sched._evict_cancelled(now())),
                (f"gw.admit#{i}", lambda: self.sched._admit_pending(now())),
                (f"gw.prefill#{i}",
                 lambda: self.sched._prefill_chunks(now())),
                (f"gw.decode#{i}", lambda: self.sched._decode_once(now())),
            ])
        decode.append(("gw.gc", lambda: self.sched._gc_streams(now())))
        return [client, decode]

    def check(self) -> list:
        leaks = list(self.sched.audit())
        leaks.extend(self._shed_shape_leaks)
        self._shed_shape_leaks = []
        if self.sched.preemptions_total >= _LIVELOCK_PREEMPTIONS:
            leaks.append(
                "preemption_livelock: "
                f"{self.sched.preemptions_total} preemptions without "
                "the workload finishing — mutual preemption never "
                "converges"
            )
        return leaks

    def final(self) -> list:
        # drain deterministically: keep iterating until idle so the
        # completion/quiesce checks do not depend on where the explored
        # schedule happened to stop
        leaks: list = []
        for _ in range(_DRAIN_ITERATIONS):
            leaks = self.check()
            if leaks:
                return leaks
            with self.sched._lock:
                open_work = self.sched._pending or any(
                    not st.done for st in self.sched._streams.values()
                )
            if not open_work:
                break
            self.sched._iteration()
        else:
            return [
                "scheduler_stuck: workload did not finish within "
                f"{_DRAIN_ITERATIONS} drain iterations "
                f"({self.sched.preemptions_total} preemptions)"
            ]
        leaks = list(self.sched.audit())
        if self.sched.streams_errored_total:
            leaks.append(
                "no_spurious_errors: "
                f"{self.sched.streams_errored_total} stream(s) errored "
                "in a workload sized to fit the pool"
            )
        kv = self.sched.decoder.kv
        held = sum(1 for _ in kv._entries)
        if kv.pages_used() != held:
            leaks.append(
                "quiesce_baseline: "
                f"{kv.pages_used()} pages in use at idle but only "
                f"{held} prefix-cache holds account for them"
            )
        return leaks

    def close(self) -> None:
        self._sched_mod._monotonic = self._saved_monotonic


def explore_gateway(*, seed: int = 0, max_schedules: int = 200,
                    seeded_bug: Optional[str] = None,
                    with_cancel: bool = False,
                    prefix_cache: bool = False,
                    speculative: bool = False) -> ExplorationResult:
    return explore(
        lambda: _GatewayWorld(
            seeded_bug=seeded_bug, with_cancel=with_cancel,
            prefix_cache=prefix_cache, speculative=speculative,
        ),
        seed=seed, max_schedules=max_schedules,
    )


# --------------------------------------------------------------------------
# lifecycle world: the real run_drain / HandoffReceiver on a virtual clock
# --------------------------------------------------------------------------


class _FakeBackend:
    def state_dict(self) -> dict:
        return {"params": {}, "opt_state": {}, "update_count": 0}


class _FakeDrainServer:
    """Just enough server surface for run_drain, with in-flight batch
    accounting the work ops mutate at the drain's interleave points."""

    def __init__(self, clock: _VirtualClock, n_experts: int = 2):
        from learning_at_home_tpu_torch.server import lifecycle as lc

        self._lc = lc
        self.lifecycle_state = lc.SERVING
        self.endpoint = ("127.0.0.1", 1)
        self.dht = None
        self.update_period = 0.1
        self.batch_timeout = 0.01
        self.checkpoint_manager = None
        self.replica_checkpoint_root = "mem://checkpoints"
        self.telemetry_prefix = "verify"
        self.experts = {f"e{i}": _FakeBackend() for i in range(n_experts)}
        self.clock = clock
        self.in_flight = 0
        self.retire_events: list = []  # (uid, in_flight, clock)
        self.finish_drain_calls = 0
        self.checkpoint_calls: list = []
        self._draining = False
        # mirror run_drain's settled logic: the drain may only proceed
        # past quiesce after 3 CONSECUTIVE idle polls (or budget expiry)
        self._idle_streak = 0
        self.quiesce_satisfied = False

    def pools_idle(self) -> bool:
        idle = self.in_flight == 0
        self._idle_streak = self._idle_streak + 1 if idle else 0
        if self._idle_streak >= 3:
            self.quiesce_satisfied = True
        return idle

    def _begin_drain(self) -> bool:
        if self._draining:
            return True
        self._draining = True
        self.lifecycle_state = self._lc.DRAINING
        return False

    def _finish_drain(self) -> None:
        self.finish_drain_calls += 1
        self.lifecycle_state = self._lc.DRAINED

    def _retire_expert(self, uid: str) -> None:
        self.retire_events.append((uid, self.in_flight, self.clock.now))
        self.experts.pop(uid, None)

    def save_checkpoint(self, root) -> int:
        self.checkpoint_calls.append((root, sorted(self.experts)))
        return 1


class _LifecycleWorld:
    """Bespoke placement exploration: the drain runs to completion each
    schedule, but every ``_sleep`` is an interleave point at which the
    schedule may inject work ops (batch start/finish) or a handoff
    failure — permuting WHEN concurrent work lands relative to the
    grace window, the quiesce polls and each per-expert handoff."""

    def __init__(self, placement: dict, fail_uids: frozenset):
        from learning_at_home_tpu_torch.server import lifecycle as lc

        self._lc = lc
        self.clock = _VirtualClock(step=0.0)  # advanced by _sleep only
        self._saved = (lc._monotonic, lc._sleep, lc.send_expert_handoff)
        self.server = _FakeDrainServer(self.clock)
        self.placement = placement  # work-op name -> interleave index
        self.fail_uids = fail_uids
        self.point = 0
        self.trace: list = []
        self.quiesce_budget_s = 1.0
        self.grace_s = 0.2

        def _virt_monotonic():
            return self.clock.now

        def _virt_sleep(seconds):
            self.clock.now += max(0.0, float(seconds))
            self._at_point()

        def _fake_handoff(successor, uid, state, **kw):
            self._at_point()
            if uid in self.fail_uids:
                raise lc.HandoffError(f"seeded handoff failure for {uid}")
            return {"installed": True, "verified": True}

        lc._monotonic = _virt_monotonic
        lc._sleep = _virt_sleep
        lc.send_expert_handoff = _fake_handoff

    def _at_point(self) -> None:
        for op, when in sorted(self.placement.items()):
            if when == self.point:
                if op.startswith("batch_start"):
                    self.server.in_flight += 1
                elif op.startswith("batch_end"):
                    self.server.in_flight = max(
                        0, self.server.in_flight - 1
                    )
                self.trace.append(f"{op}@{self.point}")
        self.point += 1

    def run(self) -> list:
        lc = self._lc
        leaks: list = []
        try:
            summary = lc.run_drain(
                self.server,
                successor=("127.0.0.1", 2),
                grace=self.grace_s,
                quiesce_timeout=self.quiesce_budget_s,
            )
        except Exception as e:
            leaks.append(
                "finish_drain_always: run_drain raised "
                f"{type(e).__name__}: {e}"
            )
            summary = None
        srv = self.server
        if srv.finish_drain_calls != 1:
            leaks.append(
                "finish_drain_always: _finish_drain ran "
                f"{srv.finish_drain_calls} times (expected exactly 1)"
            )
        # in-flight work at retire time is legal ONLY when the drain
        # earned the right to proceed: either quiesce settled (3
        # consecutive idle polls — later-arriving work is the stale
        # window replica dispatch covers) or the budget was exhausted
        # (small epsilon absorbs the 0.02s-step float accumulation)
        budget_edge = self.grace_s + self.quiesce_budget_s - 1e-6
        for uid, in_flight, at in srv.retire_events:
            if (in_flight > 0 and not srv.quiesce_satisfied
                    and at < budget_edge):
                leaks.append(
                    "drain_no_abort: expert "
                    f"{uid} retired at t={at:.2f}s with {in_flight} "
                    "in-flight batch(es), quiesce neither settled nor "
                    f"budget-exhausted ({budget_edge:.2f}s)"
                )
        if summary is not None:
            accounted = (
                set(summary["handed_off"]) | set(summary["checkpointed"])
            )
            all_uids = {f"e{i}" for i in range(2)}
            if accounted != all_uids:
                leaks.append(
                    "no_state_dropped: drain summary accounts for "
                    f"{sorted(accounted)} of {sorted(all_uids)}"
                )
            for uid in self.fail_uids:
                if uid not in summary["failed"]:
                    leaks.append(
                        "no_state_dropped: seeded handoff failure for "
                        f"{uid} is missing from summary['failed']"
                    )
        return leaks

    def close(self) -> None:
        lc = self._lc
        lc._monotonic, lc._sleep, lc.send_expert_handoff = self._saved


def explore_lifecycle(*, seed: int = 0,
                      max_schedules: int = 120) -> ExplorationResult:
    """Enumerate placements of concurrent work (one in-flight batch
    starting/finishing) and per-expert handoff failures across the
    drain's interleave points."""
    result = ExplorationResult("lifecycle", 0, 0, [])
    n_points = 8
    cases = []
    for start in range(n_points):
        for end in range(start, n_points + 4):
            for fail in (frozenset(), frozenset({"e0"})):
                cases.append(
                    ({"batch_start": start, "batch_end": end}, fail)
                )
    # seed rotates the deterministic case order (same seed, same first
    # failing placement)
    rot = seed % max(1, len(cases))
    cases = cases[rot:] + cases[:rot]
    for placement, fail in cases[:max_schedules]:
        result.schedules_run += 1
        world = _LifecycleWorld(placement, fail)
        try:
            leaks = world.run()
        finally:
            world.close()
        if leaks:
            result.violations.extend(
                Violation("lifecycle", _leak_invariant(leak), leak,
                          tuple(world.trace), result.schedules_run - 1)
                for leak in leaks
            )
            break
    return result


# --------------------------------------------------------------------------
# migration world: single-expert placement move vs concurrent dispatches
# --------------------------------------------------------------------------


class _MigrationWorld:
    """Drive the real ``lifecycle.run_migration`` against the fake drain
    server on a virtual clock.  The handoff transfer exposes interleave
    points (part boundaries) at which the schedule injects concurrent
    dispatch work; the seeded-failure axis flips the handoff outcome.
    Checks the two migrate invariants: retire strictly after the
    successor's verified install acked (hoster count never dips), and a
    failed handoff leaving the source hosted with its in-flight work
    intact."""

    def __init__(self, placement: dict, fail: bool):
        from learning_at_home_tpu_torch.server import lifecycle as lc

        self._lc = lc
        self.clock = _VirtualClock(step=0.0)
        self._saved = (lc._monotonic, lc._sleep, lc.send_expert_handoff)
        self.server = _FakeDrainServer(self.clock, n_experts=2)
        self.server.migrations_out = 0
        self.server.migration_failures = 0
        self.placement = placement  # work-op name -> interleave index
        self.fail = fail
        self.point = 0
        self.trace: list = []
        self.target_installed = False
        # (uid, target_installed_at_retire, in_flight_at_retire)
        self.retire_snapshots: list = []

        lc._monotonic = lambda: self.clock.now
        lc._sleep = self._virt_sleep

        def _fake_handoff(successor, uid, state, **kw):
            # three part boundaries mid-transfer, then the verified ack
            for _ in range(3):
                self._at_point()
            if self.fail:
                raise lc.HandoffError(
                    f"seeded migrate handoff failure for {uid}"
                )
            self.target_installed = True
            self._at_point()
            return {"installed": True, "verified": True}

        lc.send_expert_handoff = _fake_handoff

        real_retire = self.server._retire_expert

        def _observed_retire(uid):
            self.retire_snapshots.append(
                (uid, self.target_installed, self.server.in_flight)
            )
            real_retire(uid)

        self.server._retire_expert = _observed_retire

    def _virt_sleep(self, seconds) -> None:
        self.clock.now += max(0.0, float(seconds))
        self._at_point()

    def _at_point(self) -> None:
        for op, when in sorted(self.placement.items()):
            if when == self.point:
                if op.startswith("batch_start"):
                    self.server.in_flight += 1
                elif op.startswith("batch_end"):
                    self.server.in_flight = max(
                        0, self.server.in_flight - 1
                    )
                self.trace.append(f"{op}@{self.point}")
        self.point += 1

    def run(self) -> list:
        lc = self._lc
        srv = self.server
        leaks: list = []
        in_flight_before = srv.in_flight
        err = None
        try:
            lc.run_migration(srv, "e0", ("127.0.0.1", 2), timeout=5.0)
        except lc.HandoffError as e:
            err = e
        except Exception as e:
            leaks.append(
                "migrate_failure_keeps_source: run_migration raised "
                f"unexpected {type(e).__name__}: {e}"
            )
        # drain any trailing scheduled ops so a late batch_end lands
        for _ in range(12):
            self._at_point()
        if self.fail:
            if err is None:
                leaks.append(
                    "migrate_failure_keeps_source: seeded handoff "
                    "failure did not surface as HandoffError"
                )
            if "e0" not in srv.experts:
                leaks.append(
                    "migrate_failure_keeps_source: source copy of e0 "
                    "was lost after a failed handoff"
                )
            if self.retire_snapshots:
                leaks.append(
                    "migrate_failure_keeps_source: retire ran despite "
                    "the failed handoff"
                )
            if srv.migration_failures != 1 or srv.migrations_out != 0:
                leaks.append(
                    "migrate_failure_keeps_source: counters after a "
                    f"failed move: out={srv.migrations_out} "
                    f"failures={srv.migration_failures} (expected 0/1)"
                )
        else:
            if err is not None:
                leaks.append(
                    "migrate_handoff_before_retire: clean handoff "
                    f"raised {type(err).__name__}: {err}"
                )
            for uid, installed, _n in self.retire_snapshots:
                if not installed:
                    leaks.append(
                        "migrate_handoff_before_retire: expert "
                        f"{uid} retired before the successor acked a "
                        "verified install — the hoster count dipped "
                        "below its pre-move value"
                    )
            if "e0" in srv.experts:
                leaks.append(
                    "migrate_handoff_before_retire: e0 still hosted "
                    "after a successful migration (retire skipped)"
                )
            if srv.migrations_out != 1 or srv.migration_failures != 0:
                leaks.append(
                    "migrate_handoff_before_retire: counters after a "
                    f"clean move: out={srv.migrations_out} "
                    f"failures={srv.migration_failures} (expected 1/0)"
                )
        # either way: the bystander expert and in-flight accounting
        # survive the move — a migration never touches work it does not
        # own (dispatches complete on whichever copy holds them)
        if "e1" not in srv.experts:
            leaks.append(
                "migrate_failure_keeps_source: unrelated expert e1 "
                "disappeared during the migration"
            )
        # replay the schedule in its exact firing order (point asc,
        # op-name asc within a point, the max(0, ..) clamp included) —
        # the server's count must match: migrations neither drop nor
        # duplicate live dispatch accounting
        expect = in_flight_before
        for op, _when in sorted(self.placement.items(),
                                key=lambda kv: (kv[1], kv[0])):
            if op.startswith("batch_start"):
                expect += 1
            elif op.startswith("batch_end"):
                expect = max(0, expect - 1)
        if srv.in_flight != expect:
            leaks.append(
                "migrate_failure_keeps_source: in-flight dispatch "
                f"count drifted to {srv.in_flight} (expected {expect}) "
                "— a migration dropped or duplicated live work"
            )
        return leaks

    def close(self) -> None:
        lc = self._lc
        lc._monotonic, lc._sleep, lc.send_expert_handoff = self._saved


def explore_migration(*, seed: int = 0,
                      max_schedules: int = 120) -> ExplorationResult:
    """Enumerate placements of concurrent dispatch work across the
    migration's handoff part boundaries, crossed with the seeded
    handoff-failure axis."""
    result = ExplorationResult("migration", 0, 0, [])
    n_points = 6
    cases = []
    for start in range(n_points):
        for end in range(start, n_points + 3):
            for fail in (False, True):
                cases.append(
                    ({"batch_start": start, "batch_end": end}, fail)
                )
    rot = seed % max(1, len(cases))
    cases = cases[rot:] + cases[:rot]
    for placement, fail in cases[:max_schedules]:
        result.schedules_run += 1
        world = _MigrationWorld(placement, fail)
        try:
            leaks = world.run()
        finally:
            world.close()
        if leaks:
            result.violations.extend(
                Violation("migration", _leak_invariant(leak), leak,
                          tuple(world.trace), result.schedules_run - 1)
                for leak in leaks
            )
            break
    return result


# --------------------------------------------------------------------------
# handoff receiver world: session cap / out-of-order / TTL on the clock
# --------------------------------------------------------------------------


def check_handoff_receiver(*, seed: int = 0) -> ExplorationResult:
    """Drive the real HandoffReceiver.handle_part on a virtual clock and
    check the session-bound invariants.  One deterministic script — the
    receiver is single-threaded by contract (serving-loop owned), so the
    interesting axis is clock/arrival order, not thread interleaving."""
    import asyncio

    from learning_at_home_tpu_torch.server import lifecycle as lc

    result = ExplorationResult("handoff-receiver", 1, 0, [])
    clock = _VirtualClock(step=0.0)
    saved = lc._monotonic
    lc._monotonic = lambda: clock.now

    class _Srv:
        lifecycle_state = lc.SERVING
        _replicas_installing: set = set()
        experts: dict = {}

    recv = lc.HandoffReceiver(_Srv())
    loop = asyncio.new_event_loop()

    def part(uid, session, part_idx, n_parts=3, manifest=True):
        meta = {"uid": uid, "session": session, "part": part_idx,
                "n_parts": n_parts}
        if part_idx == 0 and manifest:
            meta["manifest"] = [{"shape": [1], "dtype": "float32",
                                 "crc": 0}] * 4
        return loop.run_until_complete(recv.handle_part(meta, []))

    def leak(msg):
        result.violations.append(
            Violation("handoff-receiver",
                      "lifecycle.handoff_sessions_bounded", msg, (),
                      0))

    try:
        # fill to the cap; the cap+1-th open must be refused
        for i in range(lc.HandoffReceiver.MAX_SESSIONS):
            part(f"u{i}", f"s{i}", 0)
        if len(recv._sessions) > lc.HandoffReceiver.MAX_SESSIONS:
            leak(f"{len(recv._sessions)} sessions open past MAX_SESSIONS")
        try:
            part("overflow", "sx", 0)
            leak("session past MAX_SESSIONS was accepted")
        except ValueError:
            pass
        # out-of-order part drops its session
        try:
            part("u0", "s0", 2)
            leak("out-of-order part was accepted")
        except ValueError:
            pass
        if "u0/s0" in recv._sessions:
            leak("out-of-order session survived its own protocol error")
        # TTL: everything else expires once the clock jumps, so a new
        # session opens where the cap refused one before
        clock.now += lc.HANDOFF_SESSION_TTL_S + 1
        part("fresh", "sf", 0)
        if len(recv._sessions) != 1:
            leak(
                f"{len(recv._sessions)} sessions survive a TTL expiry "
                "(expected only the fresh one)"
            )
    except Exception as e:  # a crash in the script is itself a finding
        leak(f"receiver script crashed: {type(e).__name__}: {e}")
    finally:
        loop.close()
        lc._monotonic = saved
    return result


# --------------------------------------------------------------------------
# top-level entry points
# --------------------------------------------------------------------------


def run_all(*, seed: int = 0, max_schedules: int = 200) -> dict:
    """Explore every world against the merged tree.  Returns a report
    dict; ``report["clean"]`` is the gate bit."""
    results = [
        explore_gateway(seed=seed, max_schedules=max_schedules),
        explore_gateway(seed=seed, max_schedules=max_schedules // 2,
                        with_cancel=True),
        explore_gateway(seed=seed, max_schedules=max_schedules // 2,
                        prefix_cache=True),
        explore_gateway(seed=seed, max_schedules=max_schedules // 2,
                        speculative=True),
        explore_lifecycle(seed=seed, max_schedules=max_schedules),
        explore_migration(seed=seed, max_schedules=max_schedules),
        check_handoff_receiver(seed=seed),
    ]
    violations = [v for r in results for v in r.violations]
    return {
        "seed": seed,
        "worlds": [
            {
                "world": r.world,
                "schedules_run": r.schedules_run,
                "schedules_pruned": r.schedules_pruned,
                "violations": len(r.violations),
            }
            for r in results
        ],
        "invariants_checked": len(collect_invariants()),
        "violations": [dataclasses.asdict(v) for v in violations],
        "clean": not violations,
    }


def seeded_bug_validation(*, seed: int = 0,
                          max_schedules: int = 200) -> dict:
    """Mechanically re-introduce both PR-13 scheduler races and assert
    the explorer re-finds them — deterministically (same seed, same
    failing interleaving).  A seeded bug the explorer misses means the
    CHECKER regressed; the gate fails on it."""
    a1 = explore_gateway(seed=seed, max_schedules=max_schedules,
                         seeded_bug="stale-prefill")
    a2 = explore_gateway(seed=seed, max_schedules=max_schedules,
                         seeded_bug="stale-prefill")
    b1 = explore_gateway(seed=seed, max_schedules=max_schedules,
                         seeded_bug="mutual-preemption")
    b2 = explore_gateway(seed=seed, max_schedules=max_schedules,
                         seeded_bug="mutual-preemption")

    def trace(r):
        return r.violations[0].trace if r.violations else None

    return {
        "seed": seed,
        "stale_prefill_found": bool(a1.violations),
        "stale_prefill_trace": list(trace(a1) or ()),
        "mutual_preemption_found": bool(b1.violations),
        "mutual_preemption_trace": list(trace(b1) or ()),
        "deterministic": (
            trace(a1) == trace(a2) and trace(b1) == trace(b2)
        ),
        "ok": bool(a1.violations) and bool(b1.violations)
        and trace(a1) == trace(a2) and trace(b1) == trace(b2),
    }
