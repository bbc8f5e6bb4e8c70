"""Paged KV-cache pool and content-addressed prefix cache, the JAX
package's ``models/kv_pages.py`` with torch pools on one device.

- one **physical pool** per layer, ``[num_pages, page_len, H, hd]``,
  allocated once (zeroed: the masked positions of a gathered view must
  hold finite values, or ``0 * NaN`` would reach the output);
- a per-slot int32 **page table** ``[max_slots, pages_per_slot]`` maps a
  stream's logical pages to physical pages (host numpy: the scheduler
  and admission read it); attention reads through
  :func:`~learning_at_home_tpu_torch.models.trunk.paged_one_query_attention`;
- physical page 0 is a reserved **scratch page**: unmapped page-table
  entries point at it and dead decode rows write their K/V into it.

On top sits a **content-addressed prefix cache**: after a prompt's
prefill, every page fully covered by the prompt is registered under a
chained content hash (page i's key hashes page i-1's key and page i's
token ids), a later prompt walking the same chain maps those pages
read-only and skips their prefill, and a partial match on the boundary
page is served copy-on-write into a private page.  A page with refcount
> 1 is immutable (:meth:`PagedKVCache.write_tokens` raises).

Ownership: single-threaded by contract -- the gateway's ``lah-gw-decode``
thread owns page tables, the free list and the prefix index; counters
are plain ints other threads may read.  The bookkeeping (free list,
refcounts, prefix index, ``audit``, ``stats``) is the JAX package's
line for line, so both packages reach the same state under the same
calls (``tests/test_torch_paged_kv.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from learning_at_home_tpu_torch.device import resolve_device

_ROOT = b"kv-prefix-root"


# Machine-checked invariants (lah-verify shape: (name, what is asserted)).
# ``kv.*`` rows are enforced by :meth:`PagedKVCache.audit`, run by the
# interleaving explorer after every explored step and by the scheduler's
# quiesce audit; the shared-write ban is asserted inline on every scatter.
VERIFIED_INVARIANTS = (
    ("kv.refcount_conservation",
     "every page's refcount equals its slot-table mappings plus its "
     "prefix-cache hold (plus the scratch pin for page 0)"),
    ("kv.pool_conservation",
     "free-list pages are unreferenced and unique; every non-free page "
     "is referenced — no page is both free and mapped, none leaks"),
    ("kv.scratch_pinned",
     "physical page 0 stays pinned at refcount 1: never allocated, "
     "never freed, never mapped as a slot's logical page"),
    ("kv.no_shared_page_writes",
     "a refcount>1 page is immutable — write_tokens raises on any "
     "write attempt (checked inline, copy-on-write discipline)"),
    ("kv.rollback_private_only",
     "a speculative rollback (truncate_slot) only ever frees PRIVATE "
     "lookahead pages — it raises on any prefix-cache-held or shared "
     "page (checked inline on every truncation)"),
)


class PagePressure(RuntimeError):
    """No free physical page and nothing reclaimable — the caller
    (scheduler/admission) decides whether to requeue, preempt or shed;
    this is backpressure, never a stream error by itself."""


@dataclasses.dataclass
class PrefixEntry:
    """One registered full page of some prompt's KV content."""

    key: bytes  # chained content hash: H(parent.key + tokens)
    parent: bytes  # _ROOT for page 0
    tokens: tuple  # the page_len token ids this page covers
    page_id: int  # physical page holding the K/V (refcount includes us)
    last_used: float = dataclasses.field(default_factory=time.monotonic)


class PagedKVCache:
    """Physical page pool + page tables + prefix index for one decoder."""

    def __init__(
        self,
        *,
        n_layers: int,
        n_heads: int,
        head_dim: int,
        dtype,
        max_slots: int,
        seq_len: int,
        page_len: int = 16,
        num_pages: Optional[int] = None,
        enable_prefix_cache: bool = True,
        device=None,
    ):
        if page_len < 1:
            raise ValueError("page_len must be >= 1")
        self.page_len = int(page_len)
        self.max_slots = int(max_slots)
        self.seq_len = int(seq_len)
        self.pages_per_slot = -(-self.seq_len // self.page_len)  # ceil
        self.padded_seq = self.pages_per_slot * self.page_len
        if num_pages is None:
            # dense-equivalent sizing (+1 for the scratch page): a
            # drop-in pool can always hold what the dense table held.
            # Memory-bound deployments pass fewer pages and lean on
            # admission/preemption.
            num_pages = self.max_slots * self.pages_per_slot + 1
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is scratch)")
        self.num_pages = int(num_pages)
        self.device = resolve_device(device)
        shape = (self.num_pages, self.page_len, n_heads, head_dim)
        self.k_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(n_layers)]
        self.v_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(n_layers)]
        self.page_table = np.zeros(
            (self.max_slots, self.pages_per_slot), np.int32
        )
        # logical pages present per slot (contiguous from 0)
        self.alloc_count = np.zeros(self.max_slots, np.int32)
        self.refcount = np.zeros(self.num_pages, np.int32)
        self.refcount[0] = 1  # scratch: never allocated, never freed
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self._entries: dict[bytes, PrefixEntry] = {}
        self._children: dict[bytes, dict[tuple, PrefixEntry]] = {}
        # counters (single-writer on the owning thread; cross-thread
        # reads are benign monitoring)
        self.prefix_hits_total = 0
        self.prefix_hit_tokens_total = 0
        self.prefix_partial_hits_total = 0
        self.prefix_lookups_total = 0
        self.cow_copies_total = 0
        self.pages_reclaimed_total = 0
        self.alloc_failures_total = 0
        self.rollback_pages_total = 0

    # ---- pool accounting ----

    def pages_total(self) -> int:
        return self.num_pages - 1

    def pages_free(self) -> int:
        return len(self._free)

    def pages_used(self) -> int:
        return self.pages_total() - len(self._free)

    def pages_reclaimable(self) -> int:
        """Pages held ONLY by the prefix cache (refcount 1 via their
        entry) — freeable on demand without touching any stream."""
        return sum(
            1 for e in self._entries.values()
            if int(self.refcount[e.page_id]) == 1
        )

    def pages_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_len)

    # ---- allocation / mapping (lah-gw-decode thread only) ----

    def _pop_free(self) -> int:
        if not self._free:
            self.reclaim(1)
        if not self._free:
            self.alloc_failures_total += 1
            raise PagePressure(
                f"no free KV pages ({self.pages_used()}/"
                f"{self.pages_total()} in use, 0 reclaimable)"
            )
        return self._free.pop()

    def alloc_slot_page(self, slot: int) -> int:
        """Allocate the slot's NEXT logical page privately."""
        logical = int(self.alloc_count[slot])
        if logical >= self.pages_per_slot:
            raise ValueError(f"slot {slot} already holds every logical page")
        pid = self._pop_free()
        self.refcount[pid] = 1
        self.page_table[slot, logical] = pid
        self.alloc_count[slot] = logical + 1
        return pid

    def map_shared(self, slot: int, entry: PrefixEntry) -> int:
        """Map a prefix-cache page read-only as the slot's next logical
        page (refcount guards it against writes and reclaim)."""
        logical = int(self.alloc_count[slot])
        self.refcount[entry.page_id] += 1
        self.page_table[slot, logical] = entry.page_id
        self.alloc_count[slot] = logical + 1
        entry.last_used = time.monotonic()
        return entry.page_id

    def release_slot(self, slot: int) -> None:
        for logical in range(int(self.alloc_count[slot])):
            self._decref(int(self.page_table[slot, logical]))
        self.page_table[slot, :] = 0
        self.alloc_count[slot] = 0

    def truncate_slot(self, slot: int, n_tokens: int) -> int:
        """Roll a slot's mapping back so it holds exactly the pages
        covering its first ``n_tokens`` positions; trailing logical
        pages return to the free list.  This is the speculative-decode
        rollback: lookahead pages mapped for rejected draft positions
        are released, everything covering committed tokens stays.

        Safety (kv.rollback_private_only, asserted inline): a truncated
        page is always a PRIVATE page — the new position count is at
        least ``prompt_len + 1``, so ``pages_needed(n_tokens)`` strictly
        exceeds the count of registered/shared full prompt pages and the
        truncation range can never reach a prefix-cache hold or a
        refcount>1 mapping.  Hitting one anyway is a refcounting bug,
        never a condition to paper over, so it raises."""
        keep = self.pages_needed(n_tokens)
        held = {e.page_id for e in self._entries.values()}
        released = 0
        for logical in range(int(self.alloc_count[slot]) - 1, keep - 1, -1):
            pid = int(self.page_table[slot, logical])
            if pid in held or int(self.refcount[pid]) != 1:
                raise AssertionError(
                    f"rollback would free non-private page {pid} (slot "
                    f"{slot} logical {logical}, refcount "
                    f"{int(self.refcount[pid])}) — speculative lookahead "
                    "pages must be private (kv.rollback_private_only)"
                )
            self._decref(pid)
            self.page_table[slot, logical] = 0
            self.alloc_count[slot] = logical
            released += 1
        self.rollback_pages_total += released
        return released

    def _decref(self, pid: int) -> None:
        if pid == 0:
            return
        self.refcount[pid] -= 1
        if self.refcount[pid] <= 0:
            self.refcount[pid] = 0
            self._free.append(pid)

    def reclaim(self, n_pages: int) -> int:
        """Evict up to ``n_pages`` LRU *leaf* prefix entries whose page
        nobody maps (refcount 1).  Leaf-first keeps every remaining
        entry reachable from the chain root; parents become leaves as
        their children go."""
        freed = 0
        while freed < n_pages:
            leaves = [
                e for e in self._entries.values()
                if not self._children.get(e.key)
                and int(self.refcount[e.page_id]) == 1
            ]
            if not leaves:
                break
            self._drop_entry(min(leaves, key=lambda e: e.last_used))
            freed += 1
        return freed

    def _drop_entry(self, e: PrefixEntry) -> None:
        del self._entries[e.key]
        kids = self._children.get(e.parent)
        if kids is not None:
            kids.pop(e.tokens, None)
            if not kids:
                del self._children[e.parent]
        self._decref(e.page_id)
        self.pages_reclaimed_total += 1

    # ---- the prefix index ----

    @staticmethod
    def _child_key(parent: bytes, tokens: tuple) -> bytes:
        h = hashlib.blake2b(parent, digest_size=16)
        h.update(np.asarray(tokens, np.int64).tobytes())
        return h.digest()

    def prefix_lookup(self, prompt: Sequence[int]):
        """(full_entries, partial) for a prompt: the chain of fully
        matching registered pages, plus at most one boundary page whose
        content *starts with* the remaining prompt tokens (served
        copy-on-write by the caller).  The match is capped at
        ``len(prompt) - 1``: the last prompt token is always prefilled
        so its logits (the first greedy token) exist."""
        full: list[PrefixEntry] = []
        partial: Optional[tuple[PrefixEntry, int]] = None
        if not self.enable_prefix_cache:
            return full, partial
        self.prefix_lookups_total += 1
        prompt = [int(t) for t in prompt]
        limit = len(prompt) - 1
        parent = _ROOT
        i = 0
        now = time.monotonic()
        while i + self.page_len <= limit:
            kids = self._children.get(parent)
            e = kids.get(tuple(prompt[i:i + self.page_len])) if kids else None
            if e is None:
                break
            e.last_used = now
            full.append(e)
            parent = e.key
            i += self.page_len
        r = limit - i
        if 0 < r < self.page_len:
            want = tuple(prompt[i:i + r])
            for toks, e in (self._children.get(parent) or {}).items():
                if toks[:r] == want:
                    e.last_used = now
                    partial = (e, r)
                    break
        return full, partial

    def register_prefix(self, slot: int, prompt: Sequence[int]) -> int:
        """After a prompt's prefill completes, adopt every full prompt
        page of ``slot`` into the prefix index (pages already mapped
        from the index are simply walked).  Returns entries added."""
        if not self.enable_prefix_cache:
            return 0
        prompt = [int(t) for t in prompt]
        parent = _ROOT
        added = 0
        now = time.monotonic()
        for logical in range(len(prompt) // self.page_len):
            i = logical * self.page_len
            toks = tuple(prompt[i:i + self.page_len])
            kids = self._children.setdefault(parent, {})
            e = kids.get(toks)
            if e is None:
                pid = int(self.page_table[slot, logical])
                if int(self.refcount[pid]) != 1 or pid == 0:
                    # shared without an entry can only mean the entry
                    # raced away (reclaim) — do not adopt a page we do
                    # not exclusively account for
                    break
                key = self._child_key(parent, toks)
                e = PrefixEntry(key, parent, toks, pid, now)
                kids[toks] = e
                self._entries[key] = e
                self.refcount[pid] += 1
                added += 1
            parent = e.key
        if not self._children.get(_ROOT):
            self._children.pop(_ROOT, None)
        return added

    # ---- K/V data plane ----

    def copy_page_rows(self, src_pid: int, dst_pid: int, n_rows: int) -> None:
        """Copy-on-write: clone the first ``n_rows`` K/V rows of a
        shared page into a private page the caller just allocated."""
        for layer in range(len(self.k_pools)):
            self.k_pools[layer][dst_pid, :n_rows] = \
                self.k_pools[layer][src_pid, :n_rows]
            self.v_pools[layer][dst_pid, :n_rows] = \
                self.v_pools[layer][src_pid, :n_rows]
        self.cow_copies_total += 1

    def write_tokens(self, layer: int, pids, rows, k, v) -> None:
        """Scatter K/V rows [n, H, hd] into (physical page, row)
        coordinates.  Shared pages are immutable -- writing one is a
        refcounting bug, never a race to paper over, so it raises.  Dead
        decode rows all write page 0, row 0: duplicate indices, so on the
        card which row lands there is unspecified, harmless because page
        0 is only ever read under the position mask."""
        pids = np.asarray(pids)
        bad = (self.refcount[pids] > 1) & (pids != 0)
        if bad.any():
            raise AssertionError(
                f"write to shared KV page(s) {np.unique(pids[bad])} — "
                "copy-on-write discipline violated"
            )
        index = (torch.from_numpy(pids.astype(np.int64)).to(self.device),
                 torch.from_numpy(np.asarray(rows, np.int64)).to(self.device))
        self.k_pools[layer].index_put_(index, k)
        self.v_pools[layer].index_put_(index, v)

    def audit(self) -> list[str]:
        """Check the ``kv.*`` rows of :data:`VERIFIED_INVARIANTS` against
        the live pool; returns violation strings (empty = clean).  Pure
        accounting — safe to call between any two operations on the
        owning thread (the explorer calls it after every step)."""
        leaks: list[str] = []
        expected = np.zeros(self.num_pages, np.int64)
        expected[0] = 1  # the scratch pin
        for slot in range(self.max_slots):
            for logical in range(int(self.alloc_count[slot])):
                pid = int(self.page_table[slot, logical])
                if pid == 0:
                    leaks.append(
                        f"scratch_pinned: slot {slot} logical {logical} "
                        "maps scratch page 0 as an allocated page"
                    )
                expected[pid] += 1
        for e in self._entries.values():
            expected[e.page_id] += 1
        for pid in range(self.num_pages):
            if int(self.refcount[pid]) != int(expected[pid]):
                leaks.append(
                    f"refcount_conservation: page {pid} refcount "
                    f"{int(self.refcount[pid])} but {int(expected[pid])} "
                    "references exist (slot mappings + prefix holds)"
                )
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            leaks.append(
                "pool_conservation: duplicate page(s) on the free list"
            )
        if 0 in free_set:
            leaks.append("scratch_pinned: scratch page 0 is on the free list")
        for pid in free_set - {0}:
            if int(expected[pid]) or int(self.refcount[pid]):
                leaks.append(
                    f"pool_conservation: free page {pid} is still "
                    "referenced or mapped"
                )
        for pid in range(1, self.num_pages):
            if pid not in free_set and int(self.refcount[pid]) == 0:
                leaks.append(
                    f"pool_conservation: page {pid} leaked — neither "
                    "free nor referenced"
                )
        return leaks

    def stats(self) -> dict:
        return {
            "kv_layout": "paged",
            "kv_page_len": self.page_len,
            "kv_pages_total": self.pages_total(),
            "kv_pages_used": self.pages_used(),
            "kv_pages_reclaimable": self.pages_reclaimable(),
            "prefix_cache": self.enable_prefix_cache,
            "prefix_entries": len(self._entries),
            "prefix_hits_total": self.prefix_hits_total,
            "prefix_hit_tokens_total": self.prefix_hit_tokens_total,
            "prefix_partial_hits_total": self.prefix_partial_hits_total,
            "prefix_lookups_total": self.prefix_lookups_total,
            "cow_copies_total": self.cow_copies_total,
            "pages_reclaimed_total": self.pages_reclaimed_total,
            "alloc_failures_total": self.alloc_failures_total,
            "rollback_pages_total": self.rollback_pages_total,
        }
