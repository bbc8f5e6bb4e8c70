"""Chaos injection: emulate WAN latency, stragglers, and failures locally.

The reference's experiment scripts inject latency and failures to emulate
commodity-internet churn (SURVEY.md §5.3d, [BJ] config 4).  Here chaos is
a server-side hook: every RPC reply can be delayed (base latency + jitter),
turned into a straggler (long delay — exercises the client's
``timeout_after_k_min`` grace path), or dropped (no reply — exercises the
RPC timeout path).  Deterministic under a seed so experiments reproduce.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Optional


@dataclasses.dataclass
class ChaosConfig:
    """All times in seconds; probabilities in [0, 1]."""

    base_latency: float = 0.0  # added to every reply
    jitter: float = 0.0  # uniform extra in [0, jitter]
    straggler_prob: float = 0.0  # chance of a long stall instead
    straggler_delay: float = 1.0
    drop_prob: float = 0.0  # chance the reply is never sent
    # emulated link bandwidth in bytes/sec (0 = unlimited): each reply is
    # additionally delayed by (request+reply bytes) / bandwidth.  Loopback
    # moves bytes at memcpy speed, so payload-size effects (and the value
    # of wire compression — client/moe.py ``wire_dtype``) are invisible
    # without this; ~12.5e6 (100 Mbit/s) models commodity WAN peers
    bandwidth_bps: float = 0.0
    # averaging data plane (the ``avg_part`` replies of the trainer-side
    # group all-reduce — averaging/handler.py): dropped frames exercise
    # the sender's per-part timeout → degraded-round path, delays model a
    # slow WAN peer without killing it.  Matchmaking control frames are
    # never chaos'd (experiments measure reduction fault tolerance, not
    # rendezvous flake).
    averaging_drop_prob: float = 0.0
    averaging_base_latency: float = 0.0
    averaging_jitter: float = 0.0
    seed: Optional[int] = None

    def make(self) -> "ChaosInjector":
        return ChaosInjector(self)


class ChaosInjector:
    def __init__(self, config: ChaosConfig):
        self.config = config
        self.rng = random.Random(config.seed)
        self.injected_delays = 0
        self.injected_stragglers = 0
        self.injected_drops = 0
        self.injected_averaging_drops = 0
        self.injected_averaging_delays = 0

    async def before_reply(self, nbytes: int = 0) -> bool:
        """Apply chaos; returns False if the reply must be dropped.
        ``nbytes``: request+reply payload size for the bandwidth model."""
        c = self.config
        if c.drop_prob and self.rng.random() < c.drop_prob:
            self.injected_drops += 1
            return False
        bw_delay = nbytes / c.bandwidth_bps if c.bandwidth_bps else 0.0
        if c.straggler_prob and self.rng.random() < c.straggler_prob:
            self.injected_stragglers += 1
            await asyncio.sleep(c.straggler_delay + bw_delay)
            return True
        delay = (
            c.base_latency
            + (self.rng.random() * c.jitter if c.jitter else 0.0)
            + bw_delay
        )
        if delay > 0:
            self.injected_delays += 1
            await asyncio.sleep(delay)
        return True

    async def before_averaging_reply(self, nbytes: int = 0) -> bool:
        """Chaos for averaging ``avg_part`` replies; returns False when
        the reply must be dropped (the sender sees a part timeout)."""
        c = self.config
        if c.averaging_drop_prob and self.rng.random() < c.averaging_drop_prob:
            self.injected_averaging_drops += 1
            return False
        delay = c.averaging_base_latency + (
            self.rng.random() * c.averaging_jitter if c.averaging_jitter
            else 0.0
        )
        if c.bandwidth_bps:
            delay += nbytes / c.bandwidth_bps
        if delay > 0:
            self.injected_averaging_delays += 1
            await asyncio.sleep(delay)
        return True
