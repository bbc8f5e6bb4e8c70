"""Cross-user expert-set coalescing for the gateway's decode step.

At every decode step the swarm decoder hands the MoE hook one row per
live stream.  Without coalescing each stream would pay its own pack-once
dispatch — per-peer RPC overhead × streams × layers × tokens.  The
coalescer previews each row's routed top-k expert set
(``RemoteMixtureOfExperts.preview_expert_sets``) and groups streams whose
sets OVERLAP (task-aware grouping, arXiv:2606.01007): one dispatch per
group slices its rows from one wire-cast batch per expert, so a popular
expert serves many users in one RPC.

Correctness does not depend on grouping: each group's dispatch reruns the
full per-row selection over its own rows (selection is row-independent),
and the gate-weighted combine is row-wise — grouped and ungrouped
per-stream outputs are bitwise equal (tests/test_gateway.py).  Replica
choice inside each dispatch reuses the ``RoutingCostModel`` untouched.

Groups are fired BEFORE any is joined, so disjoint groups' RPCs overlap
on the wire exactly like the training fan-out.

The port's coalescer computes the gate logits where the decoder's rows
live (the card) and hands the dispatch host arrays; each group's
gate-weighted combine runs on the host (``swarm_decoder.host_combine``),
where a row's mixture does not depend on the other rows of its group.
"""

from __future__ import annotations

import logging

import numpy as np

from learning_at_home_tpu_torch.models.swarm_decoder import (
    gate_on_host,
    host_combine,
)

logger = logging.getLogger(__name__)


class ExpertCoalescer:
    """Stateful MoE-dispatch hook for :class:`SwarmKVDecoder`.

    ``coalesce=False`` degrades to one dispatch per stream — the
    ungrouped arm of the A/B and the bitwise-parity tests.  Counters are
    cumulative across calls; the gateway's metrics collector exports them
    as ``lah_gateway_*`` series (docs/OBSERVABILITY.md).
    """

    def __init__(self, coalesce: bool = True):
        self.coalesce = coalesce
        # serving-trace hook: ``fn(stream_id) -> trace | None``
        # — the gateway wires the scheduler's ``trace_of`` here so each
        # group dispatch's ``client.dispatch.{fire,join}`` spans nest
        # under the stream trace that anchored the group
        self.trace_lookup = None
        # one inc per fired group dispatch
        self.group_dispatches_total = 0
        # per-stream dispatches AVOIDED by grouping: Σ (group size - 1)
        self.coalesced_dispatches_total = 0
        self.rows_dispatched_total = 0
        self.preview_failures_total = 0

    def _group_trace(self, group):
        """First member stream's trace id (a coalesced dispatch serves
        many streams; the wire spans ride the anchoring member's trace)."""
        if self.trace_lookup is None:
            return None
        for s in group:
            trace = self.trace_lookup(s)
            if trace is not None:
                return trace
        return None

    # decoder hook signature: (layer, moe, gate_params, x_rows, row_streams)
    def dispatch(self, layer, moe, gate_params, x_rows, row_streams):
        x_np, logits_np = gate_on_host(moe, gate_params, x_rows)
        # stream -> its row indices, first-appearance order (prefill hands
        # many rows of one stream; decode hands one row per stream)
        stream_rows: dict = {}
        for r, s in enumerate(row_streams):
            stream_rows.setdefault(s, []).append(r)
        groups = self._group(moe, logits_np, stream_rows)
        # fire every group before joining any: disjoint groups' RPCs
        # overlap on the wire
        fired = []
        for group in groups:
            rows = np.asarray(
                sorted(r for s in group for r in stream_rows[s]), np.int64
            )
            fut = moe.dispatch_async(
                x_np[rows], logits_np[rows], store_session=False,
                trace=self._group_trace(group),
            )
            fired.append((rows, fut))
        out = np.zeros((x_np.shape[0], x_np.shape[1]), x_np.dtype)
        for rows, fut in fired:
            mixed = host_combine(moe, fut.join(), logits_np[rows])
            out[rows] = np.asarray(mixed, x_np.dtype)
        self.group_dispatches_total += len(groups)
        self.coalesced_dispatches_total += len(stream_rows) - len(groups)
        self.rows_dispatched_total += int(x_np.shape[0])
        return out

    def _group(self, moe, logits_np, stream_rows: dict) -> list[list]:
        """Partition streams into overlap groups (union-find keyed by
        expert uid).  Preview failures fall back to singleton groups —
        coalescing is an optimization, never a correctness dependency."""
        streams = list(stream_rows)
        if not self.coalesce or len(streams) <= 1:
            return [[s] for s in streams]
        try:
            row_sets = moe.preview_expert_sets(logits_np)
        except Exception as e:
            self.preview_failures_total += 1
            logger.warning(
                "expert-set preview failed (%s: %s) — dispatching ungrouped",
                type(e).__name__, e,
            )
            return [[s] for s in streams]
        parent = {s: s for s in streams}

        def find(s):
            while parent[s] != s:
                parent[s] = parent[parent[s]]
                s = parent[s]
            return s

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        expert_owner: dict = {}
        for s in streams:
            uids = set()
            for r in stream_rows[s]:
                uids |= row_sets[r]
            for uid in uids:
                if uid in expert_owner:
                    union(s, expert_owner[uid])
                else:
                    expert_owner[uid] = s
        grouped: dict = {}
        for s in streams:  # first-appearance order inside each group
            grouped.setdefault(find(s), []).append(s)
        return list(grouped.values())

    def stats(self) -> dict:
        return {
            "coalesce": self.coalesce,
            "group_dispatches_total": self.group_dispatches_total,
            "coalesced_dispatches_total": self.coalesced_dispatches_total,
            "rows_dispatched_total": self.rows_dispatched_total,
            "preview_failures_total": self.preview_failures_total,
        }
