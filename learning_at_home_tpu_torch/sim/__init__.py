"""Deterministic whole-system macro-simulator: the port's copy of the JAX
package's ``sim/``.

One process, one virtual clock, thousands of virtual expert servers +
gateways + DHT nodes running the port's REAL scheduler / admission /
routing / placement code against simulated network latency and
compute-time models.  Host-only: nothing here touches a device.

Modules:

- :mod:`~learning_at_home_tpu_torch.sim.clock` — the virtual clock, the
  seam patcher, and the virtual-time asyncio event loop;
- :mod:`~learning_at_home_tpu_torch.sim.trace` — arrival-trace segments
  (poisson / burst / diurnal) + scheduled churn events, shared with
  ``experiments/loadgen.py`` and ``experiments/dht_swarm_sim.py``;
- :mod:`~learning_at_home_tpu_torch.sim.net` — the in-process DHT
  delivery fabric;
- :mod:`~learning_at_home_tpu_torch.sim.serving` — virtual expert
  servers, gateways wrapping the real ``SlotScheduler``/
  ``AdmissionController``, and the telemetry mirror feeding the real
  routing cost model;
- :mod:`~learning_at_home_tpu_torch.sim.runner` — scenario orchestration
  and the ``python -m learning_at_home_tpu_torch.sim.runner`` CLI.
"""

from learning_at_home_tpu_torch.sim.clock import (  # noqa: F401
    VirtualClock,
    VirtualClockEventLoop,
    installed_clock,
)
from learning_at_home_tpu_torch.sim.trace import ChurnEvent, Trace, TraceSegment  # noqa: F401
