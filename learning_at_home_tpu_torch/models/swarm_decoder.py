"""Incremental (KV-cache) decoding for the swarm model, the JAX
package's ``models/swarm_decoder.py`` in torch: the decode core of the
serving gateway (``gateway/scheduler.py``).

Every FFN layer is a network fan-out
(``RemoteMixtureOfExperts.dispatch_async``), so a decode step runs
eagerly: the trunk in torch on the decoder's device (the CUDA card unless
the caller passes ``device="cpu"``), the MoE through a host dispatch.
The caches have static shapes, so streams join and leave a running batch
(continuous batching) without reallocating.  Two KV layouts share every
code path above the cache:

- ``kv_layout="dense"`` (default): a ``[max_slots, S, H, hd]`` slot table;
- ``kv_layout="paged"``: one ``[num_pages, page_len, H, hd]`` pool per
  layer with per-slot page tables (``models/kv_pages.py``): capacity
  bounded by tokens in flight, shared prompt prefixes mapped read-only,
  prefill in chunks interleaved with decode.  Decode gathers each row's
  view (:func:`~learning_at_home_tpu_torch.models.trunk.
  paged_one_query_attention`) and runs the dense layout's masked
  softmax, so both layouts give the same tokens.

- :meth:`prefill_into_slot` runs one stream's prompt forward into a free
  slot (paged: :meth:`begin_prefill` plus an unbounded
  :meth:`prefill_step`, the pair the gateway uses for chunked prefill);
- :meth:`decode_step` advances every live slot by one token in one
  [max_slots]-row trunk pass, per-slot positions riding as a
  ``[B,1,1,1]`` mask bound; dead rows compute values never read (paged:
  they write scratch page 0) and are kept out of the MoE fan-out;
- :meth:`verify_step` checks drafted tokens for many streams in one
  trunk pass (exact self-speculative decoding), rolling rejected
  lookahead pages back;
- :meth:`evict` frees a slot at once.

The MoE goes through a pluggable ``moe_dispatch`` hook (the gateway
injects ``ExpertCoalescer.dispatch``); it receives only live rows.  The
gate logits are computed on the decoder's device; the rows and logits
then go to the host, where the dispatch fires and the gate-weighted
combine runs (:func:`host_combine`), and the mixed rows come back: a
client and a server holding card tensors in one process must not meet on
the card (the client's tensors stay on the host), and the host combine
gives a row the same bits whatever rows share its dispatch.

Ownership: single-threaded by contract -- the gateway's ``lah-gw-decode``
thread owns a decoder and its page pool exclusively.

Decoding is deterministic for greedy and sampled streams alike: the
token at absolute index ``i`` is drawn under ``(stream_seed, i)``
(``models/sampling.py``), so recompute after preemption, coalescing,
prefill chunking and speculative verification reproduce the same tokens.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from learning_at_home_tpu_torch.convert import tensor_to_numpy
from learning_at_home_tpu_torch.device import resolve_device
from learning_at_home_tpu_torch.models.kv_pages import (
    PagedKVCache,
    PagePressure,
)
from learning_at_home_tpu_torch.models.sampling import (
    SamplingParams,
    sample_token,
)
from learning_at_home_tpu_torch.models.trunk import (
    attention_core,
    layer_norm,
    one_query_attention,
    output_projection,
    paged_one_query_attention,
    qkv_projections,
)
from learning_at_home_tpu_torch.tree import tree_map

logger = logging.getLogger(__name__)


def gate_on_host(moe, gate_params, x_rows: torch.Tensor):
    """Gate logits of ``x_rows`` on their device (the shared
    ``gate_logits``, training's math), then both as host arrays for the
    dispatch."""
    with torch.no_grad():
        logits = moe.gate_logits(gate_params, x_rows)
    return tensor_to_numpy(x_rows), tensor_to_numpy(logits)


def host_combine(moe, result, logits_np: np.ndarray) -> np.ndarray:
    """The gate-weighted mixture (``moe._combine``) of one joined
    dispatch ``(y, idx, mask, cid)``, on host tensors; returns the mixed
    rows as an array.  On the host a row's mixture does not depend on the
    other rows of its dispatch, so grouped and ungrouped dispatches give
    the same bits."""
    y, idx, mask, _cid = result
    with torch.no_grad():
        mixed = moe._combine(
            torch.from_numpy(np.asarray(y)),
            torch.from_numpy(np.asarray(idx).astype(np.int64)),
            torch.from_numpy(np.asarray(mask)),
            torch.from_numpy(np.asarray(logits_np)),
        )
    return mixed.numpy()


def default_moe_dispatch(layer, moe, gate_params, x_rows, row_streams):
    """One pack-once dispatch for all rows of one decode/prefill call:
    gate logits (the shared ``gate_logits``), fire, join, combine.
    ``row_streams`` is unused: this is the ungrouped baseline the
    coalescer is tested against."""
    x_np, logits_np = gate_on_host(moe, gate_params, x_rows)
    fut = moe.dispatch_async(x_np, logits_np, store_session=False)
    return host_combine(moe, fut.join(), logits_np)


def _ids(values, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.int64)).to(device)


class SwarmKVDecoder:
    """Slot-table KV-cache decoder over a ``SwarmDMoETransformerLM``.

    ``max_slots`` concurrent streams, each up to ``seq_len`` total
    positions (prompt + generated).  All tensors are allocated once at
    construction on ``device`` (None: the CUDA card), where the params
    are copied; stream churn mutates per-slot scalars and overwrites
    cache rows (dense) or remaps page tables (paged) in place.
    """

    def __init__(
        self,
        model,
        params,
        *,
        max_slots: int = 8,
        max_seq_len: Optional[int] = None,
        moe_dispatch: Optional[Callable] = None,
        kv_layout: str = "dense",
        page_len: int = 16,
        num_pages: Optional[int] = None,
        prefix_cache: bool = True,
        device=None,
    ):
        cfg = model.cfg
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}"
            )
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_slots = int(max_slots)
        self.seq_len = int(max_seq_len or cfg.seq_len)
        if self.seq_len > cfg.seq_len:
            raise ValueError(
                f"max_seq_len {self.seq_len} exceeds the model's position "
                f"table ({cfg.seq_len})"
            )
        hd = cfg.d_model // cfg.n_heads
        self.kv_layout = kv_layout
        if kv_layout == "paged":
            self.kv: Optional[PagedKVCache] = PagedKVCache(
                n_layers=cfg.n_layers,
                n_heads=cfg.n_heads,
                head_dim=hd,
                dtype=cfg.dtype,
                max_slots=self.max_slots,
                seq_len=self.seq_len,
                page_len=page_len,
                num_pages=num_pages,
                enable_prefix_cache=prefix_cache,
                device=self.device,
            )
            self.k_caches = self.v_caches = None
        else:
            self.kv = None
            shape = (self.max_slots, self.seq_len, cfg.n_heads, hd)
            self.k_caches = [
                torch.zeros(shape, dtype=cfg.dtype, device=self.device)
                for _ in range(cfg.n_layers)
            ]
            self.v_caches = [
                torch.zeros(shape, dtype=cfg.dtype, device=self.device)
                for _ in range(cfg.n_layers)
            ]
        # per-slot scalars (host side — only the owning thread touches them)
        self.pos = np.zeros(self.max_slots, np.int32)  # cached positions == t
        self.last_tok = np.zeros(self.max_slots, np.int32)
        self.live = np.zeros(self.max_slots, bool)
        # mid-prefill slots (paged chunked prefill only): hold pages and a
        # slot but are not yet decodable
        self.prefilling = np.zeros(self.max_slots, bool)
        self._prefill_prompt: list = [None] * self.max_slots
        self.stream_ids: list = [None] * self.max_slots
        # per-slot SamplingParams (None = greedy, the argmax fast path)
        self.sampling: list = [None] * self.max_slots
        self._moe_dispatch = moe_dispatch or default_moe_dispatch
        self.prefills_total = 0
        self.prefill_chunks_total = 0
        self.decode_steps_total = 0
        self.verify_rounds_total = 0
        # most recent verify_step outcome, one record per slot — the
        # scheduler audit recomputes longest-prefix acceptance from it
        # (scheduler.spec_prefix_accept)
        self.last_verify: list = []

    @staticmethod
    def _rows(y: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """The MoE hook's mixed rows (a host array) on ``like``'s device
        and dtype."""
        return torch.from_numpy(y).to(like.device, like.dtype)

    # ---- slot bookkeeping ----

    @property
    def supports_chunked_prefill(self) -> bool:
        return self.kv is not None

    def free_slots(self) -> list[int]:
        return [
            i for i in range(self.max_slots)
            if not self.live[i] and not self.prefilling[i]
        ]

    def live_slots(self) -> list[tuple[int, object]]:
        """(slot, stream_id) for every DECODING slot, slot order
        (mid-prefill slots are not yet decodable)."""
        return [
            (i, self.stream_ids[i])
            for i in range(self.max_slots)
            if self.live[i]
        ]

    def prefilling_slots(self) -> list[tuple[int, object]]:
        """(slot, stream_id) for every mid-prefill slot, slot order."""
        return [
            (i, self.stream_ids[i])
            for i in range(self.max_slots)
            if self.prefilling[i]
        ]

    def busy_slots(self) -> list[int]:
        """Slots live OR mid-prefill — the decoder-side ownership set the
        scheduler's :meth:`SlotScheduler.audit` reconciles against its
        stream table (slot-table leak freedom)."""
        return [
            int(s) for s in np.nonzero(self.live | self.prefilling)[0]
        ]

    def at_capacity(self, slot: int) -> bool:
        """True when the slot has no cache row left for another token."""
        return int(self.pos[slot]) >= self.seq_len

    def evict(self, slot: int) -> None:
        """Free a slot immediately (decoding OR mid-prefill).  Cache
        content is NOT zeroed: dense rows are overwritten by the next
        prefill and masked until then; paged pages go back to the free
        list (or stay resident for the prefix cache if registered)."""
        self.live[slot] = False
        self.prefilling[slot] = False
        self._prefill_prompt[slot] = None
        self.stream_ids[slot] = None
        self.sampling[slot] = None
        self.pos[slot] = 0
        if self.kv is not None:
            self.kv.release_slot(slot)

    # ---- paged capacity surface (read by scheduler/admission) ----

    def pages_needed(self, prompt_len: int, max_new_tokens: int = 0) -> int:
        """Physical pages a stream of this shape will occupy at peak
        (0 under the dense layout — admission falls back to slots)."""
        if self.kv is None:
            return 0
        total = min(int(prompt_len) + int(max_new_tokens), self.seq_len)
        return self.kv.pages_needed(total)

    def free_page_headroom(self) -> Optional[int]:
        """Free + reclaimable pages minus one-per-active-slot reserve
        (every live/prefilling stream may need one more page within a
        step).  None under the dense layout.  Read cross-thread by
        admission — plain-int reads, the same benign monitoring race as
        the live mask."""
        if self.kv is None:
            return None
        active = int((self.live | self.prefilling).sum())
        return (
            self.kv.pages_free() + self.kv.pages_reclaimable() - active
        )

    def kv_stats(self) -> dict:
        if self.kv is None:
            return {"kv_layout": "dense"}
        return self.kv.stats()

    # ---- prefill: one stream's prompt forward into a free slot ----

    def _check_prompt(self, slot: int, prompt_ids) -> np.ndarray:
        if self.live[slot] or self.prefilling[slot]:
            raise ValueError(f"slot {slot} is occupied")
        prompt = np.asarray(prompt_ids, np.int32)
        p = int(prompt.shape[0])
        if not 0 < p < self.seq_len:
            raise ValueError(
                f"prompt length {p} must be in [1, {self.seq_len - 1}] "
                "(one free position is needed to decode)"
            )
        return prompt

    @torch.no_grad()
    def prefill_into_slot(self, slot: int, prompt_ids, stream_id=None,
                          sampling: Optional[SamplingParams] = None) -> int:
        """Full forward over one prompt; K/V written into ``slot``;
        returns the first token (argmax, or the counter-keyed draw when
        ``sampling`` has temperature > 0).  The trunk math is exactly
        ``SwarmDMoETransformerLM.apply`` (trunk.py helpers), so a decoder
        parity test against a re-forward holds to numerical noise.
        Paged layout: one unbounded chunk through the chunked-prefill
        path (and the prefix cache still applies)."""
        if self.kv is not None:
            self.begin_prefill(
                slot, prompt_ids, stream_id=stream_id, sampling=sampling
            )
            tok = None
            while tok is None:
                _consumed, tok = self.prefill_step(slot, self.seq_len)
            return tok
        prompt = self._check_prompt(slot, prompt_ids)
        p = int(prompt.shape[0])
        cfg = self.model.cfg
        params = self.params
        x = (params["embed"][_ids(prompt, self.device)][None]
             + params["pos"][None, :p])
        for i, lp in enumerate(params["layers"]):
            h = layer_norm(lp["ln1"], x)
            q, k, v = qkv_projections(lp, h, cfg.n_heads)
            x = x + output_projection(lp, attention_core(q, k, v))
            self.k_caches[i][slot, :p] = k[0]
            self.v_caches[i][slot, :p] = v[0]
            moe_in = layer_norm(lp["ln2"], x).reshape(p, cfg.d_model)
            y = self._moe_dispatch(
                i, self.model.moes[i], lp["gate"], moe_in, [stream_id] * p
            )
            x = x + self._rows(y, x).reshape(1, p, cfg.d_model)
        x_last = layer_norm(params["ln_f"], x[:, -1])
        logits = x_last @ params["embed"].T
        # the first generated token sits at absolute index p — that is
        # its counter-RNG key position (greedy: plain argmax)
        tok = sample_token(logits[0], sampling, p)
        self.pos[slot] = p
        self.last_tok[slot] = tok
        self.live[slot] = True
        self.stream_ids[slot] = stream_id
        self.sampling[slot] = sampling
        self.prefills_total += 1
        return tok

    def begin_prefill(self, slot: int, prompt_ids, stream_id=None,
                      sampling: Optional[SamplingParams] = None) -> int:
        """Claim ``slot`` for a prompt under the paged layout and serve
        whatever the prefix cache already holds: fully matching pages
        are mapped read-only into the slot's page table, a partial match
        on the boundary page is copied into a fresh private page
        (copy-on-write — shared pages are never written).  Returns the
        number of prompt tokens whose prefill is skipped; the rest is
        computed by :meth:`prefill_step` calls.  Raises
        :class:`PagePressure` (slot left clean) if the boundary copy
        cannot get a page."""
        if self.kv is None:
            raise ValueError("begin_prefill requires kv_layout='paged'")
        prompt = self._check_prompt(slot, prompt_ids)
        prompt_list = [int(t) for t in prompt]
        full, partial = self.kv.prefix_lookup(prompt_list)
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
                self.kv.prefix_partial_hits_total += 1
        except PagePressure:
            self.kv.release_slot(slot)
            raise
        if matched:
            self.kv.prefix_hits_total += 1
            self.kv.prefix_hit_tokens_total += matched
        self.prefilling[slot] = True
        self._prefill_prompt[slot] = prompt_list
        self.pos[slot] = matched
        self.stream_ids[slot] = stream_id
        self.sampling[slot] = sampling
        return matched

    @torch.no_grad()
    def prefill_step(self, slot: int, max_tokens: int):
        """Advance ``slot``'s prefill by up to ``max_tokens`` prompt
        tokens in ONE trunk pass (multi-query attention over the paged
        cache; K/V are written before the gather so within-chunk
        causality holds).  Returns ``(consumed, first_token_or_None)``
        — the token is produced when the prompt completes, at which
        point the slot turns live and its full pages are registered in
        the prefix cache.  Raises :class:`PagePressure` if the chunk
        needs a page the pool cannot supply; already-written pages stay
        mapped, so the call is retryable (or the scheduler preempts)."""
        if self.kv is None:
            raise ValueError("prefill_step requires kv_layout='paged'")
        if not self.prefilling[slot]:
            raise ValueError(f"slot {slot} is not mid-prefill")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        prompt = self._prefill_prompt[slot]
        p = len(prompt)
        start = int(self.pos[slot])
        c = min(int(max_tokens), p - start)
        pages = self.kv.pages_needed(start + c)
        while int(self.kv.alloc_count[slot]) < pages:
            self.kv.alloc_slot_page(slot)  # may raise PagePressure
        cfg = self.model.cfg
        params = self.params
        chunk = prompt[start:start + c]
        positions = np.arange(start, start + c, dtype=np.int32)
        pids = self.kv.page_table[slot, positions // self.kv.page_len]
        rows = positions % self.kv.page_len
        pt_row = _ids(self.kv.page_table[slot:slot + 1], self.device)
        t_q = _ids(positions, self.device)[None, None, :, None]  # [1,1,C,1]
        x = (
            params["embed"][_ids(chunk, self.device)][None]
            + params["pos"][None, start:start + c]
        )
        sid = self.stream_ids[slot]
        for i, lp in enumerate(params["layers"]):
            h = layer_norm(lp["ln1"], x)
            q, k, v = qkv_projections(lp, h, cfg.n_heads)
            self.kv.write_tokens(i, pids, rows, k[0], v[0])
            x = x + paged_one_query_attention(
                lp, q, self.kv.k_pools[i], self.kv.v_pools[i], pt_row, t_q
            )
            moe_in = layer_norm(lp["ln2"], x).reshape(c, cfg.d_model)
            y = self._moe_dispatch(
                i, self.model.moes[i], lp["gate"], moe_in, [sid] * c
            )
            x = x + self._rows(y, x).reshape(1, c, cfg.d_model)
        self.pos[slot] = start + c
        self.prefill_chunks_total += 1
        if start + c < p:
            return c, None
        x_last = layer_norm(params["ln_f"], x[:, -1])
        logits = x_last @ params["embed"].T
        # key position p: the token produced by a p-token prompt sits at
        # absolute index p regardless of how the prefill was chunked
        tok = sample_token(logits[0], self.sampling[slot], p)
        self.kv.register_prefix(slot, prompt)
        self.last_tok[slot] = tok
        self.live[slot] = True
        self.prefilling[slot] = False
        self._prefill_prompt[slot] = None
        self.prefills_total += 1
        return c, tok

    def ensure_decode_pages(self) -> list[int]:
        """Map a physical page for every live slot's next decode
        position; returns the slots that could NOT get one after
        reclaim (page pressure) — the scheduler preempts those before
        calling :meth:`decode_step`.  No-op under the dense layout."""
        if self.kv is None:
            return []
        lacking = []
        for s in np.nonzero(self.live)[0]:
            s = int(s)
            if self.at_capacity(s):
                continue
            logical = int(self.pos[s]) // self.kv.page_len
            while int(self.kv.alloc_count[s]) <= logical:
                try:
                    self.kv.alloc_slot_page(s)
                except PagePressure:
                    lacking.append(s)
                    break
        return lacking

    # ---- decode: one token for every live slot in one batch ----

    @torch.no_grad()
    def decode_step(self) -> np.ndarray:
        """Advance every live slot by one token.  Returns the [max_slots]
        int32 next-token array — entries at dead slots are garbage.  The
        trunk runs at the static [max_slots] batch (dead rows compute on
        position-0 garbage, never read; under the paged layout their
        writes land in scratch page 0); the MoE fan-out sees only the
        live rows."""
        live_rows = np.nonzero(self.live)[0]
        if live_rows.size == 0:
            return np.zeros(self.max_slots, np.int32)
        if any(self.at_capacity(int(s)) for s in live_rows):
            raise ValueError("a live slot is at capacity — evict it first")
        cfg = self.model.cfg
        params = self.params
        b = self.max_slots
        t = np.where(self.live, self.pos, 0).astype(np.int32)
        t_j = _ids(t, self.device)
        if self.kv is not None:
            logical = np.minimum(
                t // self.kv.page_len, self.kv.pages_per_slot - 1
            )
            if (self.live & (self.kv.alloc_count <= logical)).any():
                raise ValueError(
                    "a live slot has no KV page for its decode position — "
                    "call ensure_decode_pages() first"
                )
            pids = np.where(
                self.live,
                self.kv.page_table[np.arange(b), logical],
                0,
            ).astype(np.int32)
            rows = np.where(self.live, t % self.kv.page_len, 0).astype(
                np.int32
            )
            pt = _ids(self.kv.page_table, self.device)
        rows_idx = torch.arange(b, device=self.device)
        x = (params["embed"][_ids(self.last_tok, self.device)]
             + params["pos"][t_j])
        x = x[:, None, :]  # [B, 1, d]
        live_j = _ids(live_rows, self.device)
        for i, lp in enumerate(params["layers"]):
            h = layer_norm(lp["ln1"], x)
            q, k, v = qkv_projections(lp, h, cfg.n_heads)
            if self.kv is not None:
                self.kv.write_tokens(i, pids, rows, k[:, 0], v[:, 0])
                x = x + paged_one_query_attention(
                    lp, q, self.kv.k_pools[i], self.kv.v_pools[i], pt,
                    t_j[:, None, None, None],
                )
            else:
                self.k_caches[i][rows_idx, t_j] = k[:, 0]
                self.v_caches[i][rows_idx, t_j] = v[:, 0]
                x = x + one_query_attention(
                    lp, q, self.k_caches[i], self.v_caches[i],
                    t_j[:, None, None, None],
                )
            moe_in = layer_norm(lp["ln2"], x).reshape(b, cfg.d_model)
            y_rows = self._moe_dispatch(
                i, self.model.moes[i], lp["gate"], moe_in[live_j],
                [self.stream_ids[int(r)] for r in live_rows],
            )
            moe_out = torch.zeros((b, cfg.d_model), dtype=x.dtype,
                                  device=self.device)
            moe_out[live_j] = self._rows(y_rows, x)
            x = x + moe_out[:, None, :]
        x = layer_norm(params["ln_f"], x)
        logits = x[:, 0] @ params["embed"].T
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        # sampled rows override their argmax entry per-row; greedy rows
        # keep the vectorized argmax value bitwise untouched.  A slot at
        # position ``pos`` decodes the token at absolute index pos+1 —
        # its counter-RNG key position.
        for s in live_rows:
            s = int(s)
            sp = self.sampling[s]
            if sp is not None and not sp.greedy:
                nxt[s] = sample_token(logits[s], sp, int(self.pos[s]) + 1)
        self.last_tok[self.live] = nxt[self.live]
        self.pos[self.live] += 1
        self.decode_steps_total += 1
        return nxt

    # ---- speculative decode: k drafted tokens per swarm round-trip ----

    def ensure_lookahead_pages(self, slot: int, k: int) -> int:
        """Map physical pages covering positions ``pos .. pos+k`` of a
        live slot (the rows a k-draft :meth:`verify_step` writes) and
        return the largest ``k' <= k`` actually covered — page pressure
        clamps the proposal instead of failing the round.  Extra pages
        kept for a clamped/rejected draft are returned to the pool by
        the rollback inside :meth:`verify_step`.  Under the dense layout
        every position is preallocated, so ``k`` comes straight back.
        The caller must already have secured the page for position
        ``pos`` itself (:meth:`ensure_decode_pages`)."""
        if self.kv is None:
            return int(k)
        pos = int(self.pos[slot])
        top = min(pos + int(k), self.seq_len - 1)
        want = top // self.kv.page_len  # logical page of the last row
        while int(self.kv.alloc_count[slot]) <= want:
            try:
                self.kv.alloc_slot_page(slot)
            except PagePressure:
                break
        covered = int(self.kv.alloc_count[slot]) * self.kv.page_len - 1
        return max(0, min(int(k), covered - pos))

    @torch.no_grad()
    def verify_step(self, proposals: dict) -> dict:
        """Advance every slot in ``proposals`` by 1..k+1 tokens in ONE
        trunk pass — the speculative replacement for :meth:`decode_step`.

        ``proposals`` maps slot -> drafted token list (possibly empty —
        an empty proposal is exactly a plain decode row).  For a slot at
        position ``pos`` with last token ``t`` and drafts ``d_0..d_{k-1}``
        the pass runs k+1 rows with inputs ``[t, d_0, .., d_{k-1}]`` at
        positions ``pos .. pos+k`` (K/V written before the gather, so
        within-pass causality holds exactly as in chunked prefill).  Row
        ``j`` yields the sample ``s_j`` the NON-speculative decoder
        would have produced at absolute index ``pos+j+1`` given the
        drafted context; acceptance is the longest prefix with
        ``d_j == s_j``, and the bonus sample past it is always valid
        because its row saw only accepted context — so the slot commits
        ``s_0..s_a`` (a = accepted count) and the output is
        token-identical to decoding one-by-one.  Rejected lookahead
        pages are rolled back via :meth:`PagedKVCache.truncate_slot`.

        All rows are live, so the MoE hook sees one flattened row batch
        per layer — k tokens per stream cost ONE coalesced expert
        fan-out per layer instead of k.

        Returns ``{slot: {"tokens": [..], "accepted": a, "proposed": k}}``.
        """
        if not proposals:
            return {}
        slots = sorted(int(s) for s in proposals)
        row_slot: list[int] = []
        row_tok: list[int] = []
        row_pos: list[int] = []
        for s in slots:
            if not self.live[s]:
                raise ValueError(f"slot {s} is not live")
            drafts = [int(t) for t in proposals[s]]
            pos = int(self.pos[s])
            if pos + len(drafts) > self.seq_len - 1:
                raise ValueError(
                    f"slot {s}: {len(drafts)} drafts at position {pos} "
                    f"exceed the cache ({self.seq_len} positions)"
                )
            if self.kv is not None:
                want = (pos + len(drafts)) // self.kv.page_len
                if int(self.kv.alloc_count[s]) <= want:
                    raise ValueError(
                        f"slot {s} has no KV page for its lookahead — "
                        "call ensure_lookahead_pages() first"
                    )
            for j, tok in enumerate([int(self.last_tok[s])] + drafts):
                row_slot.append(s)
                row_tok.append(tok)
                row_pos.append(pos + j)
        cfg = self.model.cfg
        params = self.params
        r = len(row_tok)
        row_slot_np = np.asarray(row_slot, np.int32)
        row_pos_np = np.asarray(row_pos, np.int32)
        pos_j = _ids(row_pos_np, self.device)
        if self.kv is not None:
            pids = self.kv.page_table[
                row_slot_np, row_pos_np // self.kv.page_len
            ].astype(np.int32)
            rows = (row_pos_np % self.kv.page_len).astype(np.int32)
            pt_rows = _ids(self.kv.page_table[row_slot_np], self.device)
        else:
            slot_j = _ids(row_slot_np, self.device)
        x = (
            params["embed"][_ids(row_tok, self.device)]
            + params["pos"][pos_j]
        )
        x = x[:, None, :]  # [R, 1, d]
        row_streams = [self.stream_ids[s] for s in row_slot]
        for i, lp in enumerate(params["layers"]):
            h = layer_norm(lp["ln1"], x)
            q, k, v = qkv_projections(lp, h, cfg.n_heads)
            if self.kv is not None:
                self.kv.write_tokens(i, pids, rows, k[:, 0], v[:, 0])
                x = x + paged_one_query_attention(
                    lp, q, self.kv.k_pools[i], self.kv.v_pools[i],
                    pt_rows, pos_j[:, None, None, None],
                )
            else:
                self.k_caches[i][slot_j, pos_j] = k[:, 0]
                self.v_caches[i][slot_j, pos_j] = v[:, 0]
                x = x + one_query_attention(
                    lp, q, self.k_caches[i][slot_j],
                    self.v_caches[i][slot_j],
                    pos_j[:, None, None, None],
                )
            moe_in = layer_norm(lp["ln2"], x).reshape(r, cfg.d_model)
            y_rows = self._moe_dispatch(
                i, self.model.moes[i], lp["gate"], moe_in, row_streams
            )
            x = x + self._rows(y_rows, x).reshape(r, 1, cfg.d_model)
        x = layer_norm(params["ln_f"], x)
        logits = x[:, 0] @ params["embed"].T
        out: dict = {}
        self.last_verify = []
        row = 0
        for s in slots:
            drafts = [int(t) for t in proposals[s]]
            pos = int(self.pos[s])
            sp = self.sampling[s]
            samples = [
                sample_token(logits[row + j], sp, pos + j + 1)
                for j in range(len(drafts) + 1)
            ]
            row += len(drafts) + 1
            a = 0
            while a < len(drafts) and drafts[a] == samples[a]:
                a += 1
            tokens = samples[:a + 1]  # accepted drafts + the bonus draw
            self.pos[s] = pos + a + 1
            self.last_tok[s] = tokens[-1]
            if self.kv is not None:
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

    # ---- convenience: closed-loop batch generation ----

    def generate(
        self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
        sampling: Optional[Sequence] = None,
    ) -> list[list[int]]:
        """Decode a fixed batch of prompts to completion (no mid-flight
        joins) — the ``generate_lm.py --swarm`` path and the parity
        tests.  Requires an empty decoder with ``len(prompts) <=
        max_slots``.  ``sampling`` is an optional per-prompt list of
        :class:`SamplingParams` (None entries = greedy)."""
        if len(prompts) > len(self.free_slots()):
            raise ValueError(
                f"{len(prompts)} prompts need {len(prompts)} free slots, "
                f"have {len(self.free_slots())}"
            )
        if sampling is None:
            sampling = [None] * len(prompts)
        slots = []
        outs: list[list[int]] = []
        for sid, prompt in enumerate(prompts):
            slot = self.free_slots()[0]
            tok = self.prefill_into_slot(
                slot, prompt, stream_id=sid, sampling=sampling[sid]
            )
            slots.append(slot)
            outs.append([tok])
        for _ in range(max_new_tokens - 1):
            active = [s for s in slots if self.live[s]]
            if not active:
                break
            lacking = self.ensure_decode_pages()
            if lacking:
                raise PagePressure(
                    f"slots {lacking} cannot get a decode page — the pool "
                    "is undersized for this closed-loop batch"
                )
            nxt = self.decode_step()
            for sid, slot in enumerate(slots):
                if self.live[slot]:
                    outs[sid].append(int(nxt[slot]))
                    if (
                        len(outs[sid]) >= max_new_tokens
                        or self.at_capacity(slot)
                    ):
                        self.evict(slot)
        for slot in slots:
            if self.live[slot]:
                self.evict(slot)
        return outs
