"""Self-speculation drafters for the gateway decode loop, the JAX
package's ``models/drafter.py`` over torch tensors.

A drafter proposes up to ``k`` continuation tokens for one stream from
its committed context (prompt + delivered tokens).  Proposals are
guesses: :meth:`~learning_at_home_tpu_torch.models.swarm_decoder.
SwarmKVDecoder.verify_step` recomputes the token the non-speculative
decoder would produce at every drafted position and accepts only the
longest matching prefix, so a bad drafter costs round-trips, never
correctness.  Drafters hold no KV state: nothing to roll back.

- :class:`NGramDrafter` -- suffix-match lookup over the committed
  context: no compute, no expert traffic.
- :class:`TruncatedTrunkDrafter` -- a forward over the first
  ``draft_layers`` trunk layers with the MoE branch skipped (the local
  half of the shortcut wiring: host or card FLOPs, no network fan-out),
  sampling with the verifier's counter-based keys at the same positions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from learning_at_home_tpu_torch.models.sampling import (
    SamplingParams,
    sample_token,
)
from learning_at_home_tpu_torch.models.trunk import (
    attention_core,
    layer_norm,
    output_projection,
    qkv_projections,
)


class NGramDrafter:
    """Longest-suffix-match proposal over the committed context.

    Finds the longest suffix (up to ``max_suffix`` tokens) of the
    context that also occurs earlier, and proposes the tokens that
    followed an earlier occurrence — preferring the most recent
    occurrence with a FULL ``k``-token continuation.  The most recent
    match alone is not enough: in a period-``p`` output loop it sits
    ``p`` positions before the end, so copying only its continuation
    caps proposals at ``p`` tokens (a period-1 loop would never draft
    more than one), wasting the batched verify round-trip; scanning
    back to an occurrence with a full copy window proposes the whole
    ``k``-token loop continuation instead.  Returns ``[]`` when
    nothing matches — an empty proposal degrades to a plain decode
    step, so the fallback is always safe.
    """

    def __init__(self, max_suffix: int = 8):
        if max_suffix < 1:
            raise ValueError("max_suffix must be >= 1")
        self.max_suffix = int(max_suffix)

    def propose(
        self,
        context: Sequence[int],
        k: int,
        sampling: Optional[SamplingParams] = None,
    ) -> list[int]:
        ctx = [int(t) for t in context]
        n = len(ctx)
        if k < 1 or n < 2:
            return []
        for s in range(min(self.max_suffix, n - 1), 0, -1):
            suffix = ctx[-s:]
            best: list[int] = []
            # scan occurrences most-recent-first (exclude the suffix
            # itself); take the first with a full k-token continuation,
            # else the longest partial continuation seen
            for i in range(n - s - 1, -1, -1):
                if ctx[i:i + s] == suffix:
                    out = ctx[i + s:i + s + int(k)]
                    if len(out) >= int(k):
                        return out
                    if len(out) > len(best):
                        best = out
            if best:
                return best
        return []


class TruncatedTrunkDrafter:
    """Shallow attention-only self-drafter over the model's own weights.

    Runs ``k`` autoregressive passes over the last ``window`` context
    tokens through the first ``draft_layers`` layers (attention branch
    only — the MoE fan-out is skipped, which is the point) and projects
    through the shared ``ln_f``/embedding head.  Tokens are drawn by the
    same :func:`~learning_at_home_tpu_torch.models.sampling.sample_token`
    keyed at the same absolute positions the verifier will use.
    """

    def __init__(self, model, params, *, draft_layers: int = 1,
                 window: int = 32):
        cfg = model.cfg
        if not 1 <= draft_layers <= cfg.n_layers:
            raise ValueError(
                f"draft_layers must be in [1, {cfg.n_layers}], got "
                f"{draft_layers}"
            )
        if window < 1:
            raise ValueError("window must be >= 1")
        self.params = params
        self.n_heads = cfg.n_heads
        self.seq_len = int(cfg.seq_len)
        self.draft_layers = int(draft_layers)
        self.window = int(window)

    def propose(
        self,
        context: Sequence[int],
        k: int,
        sampling: Optional[SamplingParams] = None,
    ) -> list[int]:
        toks = [int(t) for t in context]
        if not toks or k < 1:
            return []
        params = self.params
        dev = params["embed"].device
        out: list[int] = []
        for _ in range(int(k)):
            if len(toks) >= self.seq_len:
                break  # the drafted position would be past the pos table
            start = max(0, len(toks) - self.window)
            ids = torch.tensor(toks[start:], dtype=torch.int64, device=dev)
            x = (
                params["embed"][ids][None]
                + params["pos"][None, start:len(toks)]
            )
            for lp in params["layers"][:self.draft_layers]:
                h = layer_norm(lp["ln1"], x)
                q, kk, v = qkv_projections(lp, h, self.n_heads)
                x = x + output_projection(lp, attention_core(q, kk, v))
                # MoE branch intentionally skipped: the ScMoE shortcut
                # reads the layer input, so attention-only IS the local
                # half — no expert round-trip in the draft path
            x_last = layer_norm(params["ln_f"], x[:, -1])
            logits = x_last @ params["embed"].T
            nxt = sample_token(logits[0], sampling, len(toks))
            out.append(nxt)
            toks.append(nxt)
        return out
