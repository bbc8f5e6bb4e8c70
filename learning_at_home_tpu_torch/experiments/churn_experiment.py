"""SLO-gated swarm churn harness: train against a swarm while servers
drain, crash, and rejoin -- and ASSERT the service floors held ([BJ]
config 4's churn).

The port of ``experiments/churn_experiment.py``: its flags, profiles,
SLO floors, JSON lines, report and exit codes, plus ``--device`` (the
servers' and the trainer's device; default: the CUDA card, without one it
raises).  Expert servers run as real separate processes (``python -m
learning_at_home_tpu_torch.server``), each writing its output to a log in
a fresh temporary directory.  On a fixed schedule a victim server is
taken down in one of two ways:

- **graceful** (``--graceful-frac``): SIGTERM to a ``--drain-on-term``
  server -- it stops heartbeating (DHT record expiry steers new dispatch
  away), finishes in-flight batches, migrates every expert's params +
  optimizer state to a successor over the ``handoff`` wire, and exits.
  The SLO contract: a graceful drain causes ZERO quorum failures.
- **hard** (the rest): SIGKILL -- the crash path.  Recovery is
  restart-from-checkpoint: every server snapshots its experts
  periodically and relaunches with ``--resume``, rejoining the DHT from
  its latest complete step.

The trainer keeps stepping through all of it with the k-of-n quorum.
After the run the harness checks the SLO floors -- training throughput
vs the churn-free warmup baseline, a dispatch-latency p99 ceiling, and
zero quorum failures inside graceful-drain windows -- and exits non-zero
on violation (``--no-slo-gate`` to observe without gating).  ``--report``
writes the machine-readable summary.

Examples:
  python -m learning_at_home_tpu_torch.experiments.churn_experiment \\
      --profile fast --report slo.json
  python -m learning_at_home_tpu_torch.experiments.churn_experiment \\
      --steps 60 --kill-every 10 --graceful-frac 0.5 --slo-p99-ms 2000
"""

import argparse
import json
import logging
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
logger = logging.getLogger(__name__)


# Profile presets: ``fast`` is the CI smoke; ``sustained`` is the
# production-churn-rate soak the acceptance criteria describe.  Explicit
# CLI flags ALWAYS win — profile-tunable args parse with a None sentinel
# (so passing a value that happens to equal the global default still
# sticks), the profile fills what stayed unset, and FALLBACKS below
# covers the rest.
PROFILES = {
    "fast": {
        # the floors are asserted on a shared noisy host, so the churn
        # span (steps between kills x pacing) must amortize each kill's
        # fixed disruption (a relaunch boots a whole server process)
        # with margin
        "steps": 60, "kill_every": 20, "dead_for": 6, "n_servers": 3,
        "experts_per_server": 2, "graceful_frac": 0.5, "ttl": 1.0,
        "max_down": 2, "step_interval": 0.75,
        "checkpoint_every": 3.0, "slo_p99_ms": 2500.0,
        "timeout_after_k_min": 0.1,
    },
    "sustained": {
        "steps": 150, "kill_every": 10, "dead_for": 8, "n_servers": 3,
        "experts_per_server": 2, "graceful_frac": 0.5, "ttl": 2.0,
        "max_down": 2, "step_interval": 0.25,
        "checkpoint_every": 5.0, "slo_p99_ms": 2000.0,
        "timeout_after_k_min": 0.25,
    },
}


# global defaults for the profile-tunable args (parser defaults are the
# None sentinel so "explicitly passed" is distinguishable)
FALLBACKS = {
    "steps": 40, "kill_every": 10, "dead_for": 8, "n_servers": 3,
    "experts_per_server": 2, "ttl": 2.0, "timeout_after_k_min": 0.25,
    "max_down": 1, "graceful_frac": 0.0,
    "step_interval": 0.0, "checkpoint_every": 0.0, "slo_p99_ms": 0.0,
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--profile", choices=sorted(PROFILES), default=None,
                   help="preset scenario; explicit flags override it")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--kill-every", type=int, default=None,
                   help="steps between kills (default 10)")
    p.add_argument("--dead-for", type=int, default=None,
                   help="steps a server stays dead (default 8)")
    p.add_argument("--n-servers", type=int, default=None)
    p.add_argument("--experts-per-server", type=int, default=None)
    p.add_argument("--hidden-dim", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--ttl", type=float, default=None,
                   help="expert record TTL (s, default 2.0)")
    p.add_argument("--timeout-after-k-min", type=float, default=None,
                   help="client straggler grace once k_min replies landed "
                        "(default 0.25)")
    # no --dht-rpc-timeout: the DHT's per-peer adaptive timeout
    # (clamped on each peer's RTT EMA) bounds how long a dead, not yet
    # evicted node can stall a lookup wave
    p.add_argument("--max-down", type=int, default=None,
                   help="max servers simultaneously dead-or-booting; kills "
                        "beyond this wait (an operator preserves capacity)")
    p.add_argument("--base-port", type=int, default=45160)
    p.add_argument("--graceful-frac", type=float, default=None,
                   help="fraction of kill events that are GRACEFUL drains "
                        "(SIGTERM to a --drain-on-term server: migrate "
                        "experts, then exit); the rest are SIGKILL "
                        "crashes.  The mix is DETERMINISTIC — event i is "
                        "graceful iff ceil((i+1)f) > ceil(if) — so a "
                        "given config always exercises both arms")
    p.add_argument("--step-interval", type=float, default=None,
                   help="pace the training loop to this many seconds per "
                        "step.  The SLO throughput ratio compares work "
                        "done per wall second; the loopback toy step is "
                        "sub-RTT (~50 ms), so without pacing a single "
                        "stale-record window dominates the ratio in a "
                        "way no real training step would see")
    p.add_argument("--checkpoint-every", type=float, default=None,
                   help="seconds between per-server checkpoints (0 = no "
                        "checkpointing; hard-killed servers then restart "
                        "from the seed instead of their latest step)")
    p.add_argument("--checkpoint-root", default=None,
                   help="root dir for per-server checkpoint trees "
                        "(default: a fresh temp dir)")
    p.add_argument("--wire-dtype", default=None,
                   choices=["bfloat16", "float16"],
                   help="compress activation/grad payloads on the wire")
    p.add_argument("--latency-weight", type=float, default=0.0,
                   help="debit expert selection by endpoint RTT EMA")
    p.add_argument("--routing-cost-weight", type=float, default=None,
                   help="latency-aware routing cost-model weight; "
                        "default falls back to --latency-weight")
    p.add_argument("--replicate-first", type=int, default=0,
                   help="host the hot expert churn.0 on the first N "
                        "servers (replica-kill scenario: the schedule's "
                        "first victim is churn.0's primary, so dispatches "
                        "must survive via the replica set + hedged "
                        "fallback; the summary reports hedge fires/wins)")
    p.add_argument("--averaging", action="store_true",
                   help="averaging-under-churn scenario: a companion "
                        "trainer peer averages gate params with this "
                        "process every --averaging-every steps, and each "
                        "server-kill event also takes the companion down "
                        "MID-ROUND — the summary reports the degraded-"
                        "round fraction alongside expert availability")
    p.add_argument("--averaging-every", type=int, default=5,
                   help="steps between averaging rounds")
    # ---- SLO gates ----
    p.add_argument("--slo-throughput-frac", type=float, default=0.8,
                   help="churn-phase training throughput must stay above "
                        "this fraction of the churn-free warmup baseline")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="churn-phase dispatch-latency p99 ceiling in ms "
                        "(0 = no ceiling unless a profile sets one)")
    p.add_argument("--no-slo-gate", action="store_true",
                   help="report SLO verdicts but always exit 0")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="write the machine-readable summary JSON here")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of the servers' experts and the "
                        "trainer (default: the CUDA card; 'cpu' to run on "
                        "the CPU)")
    args = p.parse_args(argv)
    # resolution order: explicit CLI value > profile > FALLBACKS — the
    # None parser defaults make "explicitly passed" unambiguous even
    # when the passed value equals a fallback
    if args.profile:
        for key, value in PROFILES[args.profile].items():
            if getattr(args, key) is None:
                setattr(args, key, value)
    for key, value in FALLBACKS.items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    return args


def percentile_ms(samples, q: float):
    import numpy as np

    return float(np.percentile(np.asarray(samples) * 1000, q)) if samples else None


def main(argv=None) -> int:
    args = parse_args(argv)

    import numpy as np
    import torch

    from learning_at_home_tpu_torch import optim
    from learning_at_home_tpu_torch import random as prng
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
    from learning_at_home_tpu_torch.device import resolve_device
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.tree import tree_map
    from learning_at_home_tpu_torch.utils.subproc import (
        SERVER_MODULE,
        clean_subprocess_env,
    )

    dev = resolve_device(args.device)
    n_experts = args.n_servers * args.experts_per_server
    bootstrap = DHT()
    env = clean_subprocess_env(REPO)
    log_dir = tempfile.mkdtemp(prefix="churn_logs_")
    ckpt_root = args.checkpoint_root
    if args.checkpoint_every > 0 and ckpt_root is None:
        ckpt_root = tempfile.mkdtemp(prefix="churn_ckpt_")

    def server_uids(v: int) -> set:
        base = v * args.experts_per_server
        uids = {f"churn.{i}" for i in range(base, base + args.experts_per_server)}
        if args.replicate_first and 0 < v < args.replicate_first:
            # replica-kill scenario: the first N servers ALL host the hot
            # expert churn.0 (crc32-uid seeding makes every copy start
            # from identical weights); killing its primary then costs one
            # hedge window, not availability
            uids.add("churn.0")
        return uids

    def launch_server(server_idx: int) -> subprocess.Popen:
        """One server process hosting a contiguous block of the grid
        (plus the hot expert's replica when --replicate-first covers it).
        Every launch passes ``--resume``: the first boot finds no
        checkpoint and starts fresh; a relaunch after a hard kill
        restarts from its latest complete step and rejoins the DHT —
        restart-from-checkpoint under churn."""
        log = open(os.path.join(log_dir, f"srv{server_idx}.log"), "ab")
        cmd = [
            sys.executable, "-m", SERVER_MODULE,
            "--expert-uids", ",".join(sorted(server_uids(server_idx))),
            "--expert-prefix", "churn",
            "--hidden-dim", str(args.hidden_dim),
            "--port", str(args.base_port + server_idx),
            "--initial-peers",
            f"{bootstrap.endpoint[0]}:{bootstrap.endpoint[1]}",
            "--update-period", str(args.ttl / 2),
            "--warmup", str(args.batch_size),
            "--optimizer", "adam", "--lr", "1e-3",
            "--seed", str(args.seed + 100 * server_idx),
            # graceful lifecycle: SIGTERM drains (expert migration to a
            # successor, checkpoint fallback), SIGKILL is the crash arm
            "--drain-on-term", "--drain-grace", str(args.ttl),
            "--device", str(dev),
        ]
        if ckpt_root is not None:
            cmd += [
                "--checkpoint-dir", os.path.join(ckpt_root, f"srv{server_idx}"),
                "--checkpoint-every", str(args.checkpoint_every),
                "--checkpoint-keep-last", "2",
                "--resume",
            ]
        try:
            return subprocess.Popen(
                cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
            )
        finally:
            log.close()  # Popen dup'd the fd; don't leak ours

    servers: dict[int, subprocess.Popen] = {}
    client_dht = None
    avg_main = avg_comp = comp_stop = None
    exit_code = 0
    try:  # EVERYTHING incl. launches/discovery: a setup failure or Ctrl-C
        # must never orphan spawned server processes
        for i in range(args.n_servers):
            servers[i] = launch_server(i)
        client_dht = DHT(initial_peers=[bootstrap.endpoint])

        def get_alive() -> set:
            return set(client_dht._loop.run(client_dht._get_alive("churn")))

        moe = RemoteMixtureOfExperts(
            in_features=args.hidden_dim,
            grid_size=(n_experts,),
            uid_prefix="churn",
            source=client_dht,
            k_best=min(4, n_experts),
            k_min=1,
            timeout_after_k_min=args.timeout_after_k_min,
            forward_timeout=20.0,
            backward_timeout=20.0,
            alive_ttl=args.ttl / 2,
            wire_dtype=args.wire_dtype,
            latency_weight=args.latency_weight,
            routing_cost_weight=args.routing_cost_weight,
            # stale-while-revalidate: discovery lookups (slow while dead
            # DHT peers await eviction) must never block the dispatch
            # path — one-window staleness is the hedges' job to cover
            alive_swr=True,
        )
        gate = moe.init_gate_params(prng.PRNGKey(args.seed).to(dev))
        opt = optim.adam(1e-2)
        opt_state = opt.init(gate)

        # averaging-under-churn: a companion peer with its own gate copy
        # keeps rendezvousing with this trainer; kill events also take
        # the companion down mid-round (degraded rounds, never hangs)
        if args.averaging:
            import threading

            from learning_at_home_tpu_torch.averaging import (
                AveragingConfig,
                AveragingFailed,
                DecentralizedAverager,
            )

            avg_cfg = AveragingConfig(
                prefix="averaging.churn", min_group_size=2,
                max_group_size=2, part_timeout=2.0, gather_timeout=2.0,
            )
            comp_stop = threading.Event()
            avg_main = DecentralizedAverager(
                client_dht, config=avg_cfg, peer_id="trainer-main"
            )
            avg_comp = DecentralizedAverager(
                client_dht, config=avg_cfg, peer_id="trainer-peer"
            )
            comp_gate = [tree_map(torch.clone, gate)]

            def companion_loop():
                while not comp_stop.is_set():
                    try:
                        averaged, info = avg_comp.step_round(
                            comp_gate[0], matchmaking_timeout=10.0
                        )
                        if info.get("died_after_match"):
                            # the armed ONE-round mid-round death was
                            # consumed this round; disarm only now (a
                            # kill event racing the round boundary must
                            # not be clobbered before it was observed)
                            avg_comp.debug_die_after_match = False
                        elif averaged is not None:
                            comp_gate[0] = averaged
                    except AveragingFailed:
                        pass
                    except Exception as e:
                        # churn teardown races are expected here
                        logger.debug("companion round skipped: %s: %s",
                                     type(e).__name__, e)
                    comp_stop.wait(0.1)

            threading.Thread(
                target=companion_loop, name="churn-avg-companion",
                daemon=True,
            ).start()

        # toy regression task: y = roll(x); trains gate + experts jointly
        rs = np.random.RandomState(args.seed)
        X = rs.randn(256, args.hidden_dim).astype(np.float32)
        Y = np.roll(X, 1, axis=1)

        deadline = time.time() + 180
        while time.time() < deadline:
            if len(get_alive()) == n_experts:
                break
            time.sleep(0.5)
        print(json.dumps({"event": "ready", "alive": len(get_alive())}), flush=True)

        def loss_fn(gate, x, y):
            return torch.mean((moe(x, gate) - y) ** 2)

        value_and_grad = optim.value_and_grad(loss_fn)

        dead_since: dict[int, int] = {}
        kill_kind: dict[int, str] = {}       # victim -> graceful|hard
        # a relaunched server counts as capacity again only when its experts
        # are declared AND a full TTL has passed since relaunch — by then any
        # records of the dying predecessor have expired, so the declarations
        # are the new process's own
        restarting: dict[int, float] = {}  # v -> relaunch wall time
        # graceful-drain vulnerability windows [t_sigterm, t_exit + ttl]:
        # the SLO contract is ZERO quorum failures inside them
        graceful_windows: list[list] = []
        open_graceful: dict[int, list] = {}  # victim -> its open window
        quorum_failures = 0
        failure_times: list[float] = []
        kills = {"graceful": 0, "hard": 0}
        relaunches = 0
        step_times: list[float] = []       # wall time at each step END
        warmup_end_idx = None              # dispatch count at first kill
        warmup_end_step = None
        victim = 0
        t_run0 = time.time()
        alive_uids: set = set()
        last_alive_t = 0.0
        for step in range(args.steps):
            # the alive snapshot is MONITORING, not training: throttle it
            # to ~1/s so its DHT lookups (slow while dead nodes linger in
            # routing tables) never shape the throughput SLO
            if time.time() - last_alive_t >= 1.0 or step == args.steps - 1:
                alive_uids = get_alive()
                last_alive_t = time.time()
            for v, t_relaunch in list(restarting.items()):
                if (
                    time.time() - t_relaunch > args.ttl
                    and server_uids(v) <= alive_uids
                ):
                    del restarting[v]
                    print(json.dumps({"event": "recovered", "server": v,
                                      "step": step}), flush=True)
            if args.kill_every and step > 0 and step % args.kill_every == 0:
                v = victim % args.n_servers
                down = set(dead_since) | set(restarting)
                if v not in down and len(down) < min(args.max_down, args.n_servers - 1):
                    # deterministic kind mix: exactly ceil(n*f) of the
                    # first n executed events are graceful, starting
                    # graceful — a fixed config exercises both arms
                    i = kills["graceful"] + kills["hard"]
                    graceful = math.ceil(
                        (i + 1) * args.graceful_frac
                    ) > math.ceil(i * args.graceful_frac)
                    if warmup_end_idx is None:
                        warmup_end_idx = len(moe.dispatch_times)
                        warmup_end_step = step
                    if graceful:
                        servers[v].terminate()  # --drain-on-term: drains
                        kill_kind[v] = "graceful"
                        kills["graceful"] += 1
                        window = [time.time(), None]
                        open_graceful[v] = window
                        graceful_windows.append(window)
                    else:
                        servers[v].kill()  # SIGKILL: the crash arm
                        kill_kind[v] = "hard"
                        kills["hard"] += 1
                    dead_since[v] = step
                    if avg_comp is not None:
                        # churn hits the averaging tier too: the
                        # companion dies mid-round on this kill event
                        avg_comp.debug_die_after_match = True
                    print(json.dumps({"event": "kill", "server": v,
                                      "step": step,
                                      "kind": kill_kind[v]}), flush=True)
                victim += 1
            for v, since in list(dead_since.items()):
                window = open_graceful.get(v)
                if window is not None and servers[v].poll() is not None:
                    # drained-and-exited: the stale-record window closes
                    # one TTL after exit
                    window[1] = time.time() + args.ttl
                    del open_graceful[v]
                if step - since >= args.dead_for:
                    # the kill went out dead_for steps ago; don't stall
                    # the trainer on a hung shutdown — force and move on
                    if servers[v].poll() is None:
                        servers[v].kill()
                    try:
                        servers[v].wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        continue  # un-reapable; retry next step
                    if v in open_graceful:  # drain never finished cleanly
                        open_graceful.pop(v)[1] = time.time() + args.ttl
                    servers[v] = launch_server(v)
                    relaunches += 1
                    del dead_since[v]
                    restarting[v] = time.time()
                    print(json.dumps({"event": "relaunched", "server": v,
                                      "step": step,
                                      "kind": kill_kind.get(v, "hard")}),
                          flush=True)

            idx = rs.randint(0, len(X), args.batch_size)
            x = torch.from_numpy(X[idx]).to(dev)
            y = torch.from_numpy(Y[idx]).to(dev)
            try:
                loss, grads = value_and_grad(gate, x, y)
                updates, opt_state = opt.update(grads, opt_state)
                gate = optim.applied_updates(gate, updates)
            except Exception as e:  # quorum failure: skip the batch, keep going
                quorum_failures += 1
                failure_times.append(time.time())
                print(json.dumps({"event": "quorum_failure", "step": step,
                                  "alive": sorted(get_alive()),  # at FAILURE time
                                  "error": str(e)[-160:]}), flush=True)
                time.sleep(max(0.25, args.step_interval))
                step_times.append(time.time())
                continue
            if args.step_interval:
                # model the fixed trunk-compute cadence of a real step
                # (see --step-interval help)
                time.sleep(args.step_interval)
            step_times.append(time.time())
            if (
                avg_main is not None
                and step > 0 and step % args.averaging_every == 0
            ):
                try:
                    averaged, avg_info = avg_main.step_round(
                        gate, matchmaking_timeout=8.0
                    )
                    if averaged is not None:
                        gate = averaged
                    if avg_info.get("degraded"):
                        print(json.dumps({"event": "averaging_degraded",
                                          "step": step}), flush=True)
                except Exception as e:  # matchmaking failure: keep training
                    print(json.dumps({"event": "averaging_skipped",
                                      "step": step,
                                      "error": str(e)[-120:]}), flush=True)
            if step % 5 == 0 or step == args.steps - 1:
                print(
                    json.dumps(
                        {
                            "step": step,
                            "loss": round(float(loss), 4),
                            "alive_experts": len(alive_uids),
                            "dead_servers": sorted(set(dead_since) | set(restarting)),
                            "quorum_failures": quorum_failures,
                        }
                    ),
                    flush=True,
                )

        # ---- SLO evaluation ----
        times = list(moe.dispatch_times)
        if warmup_end_idx is None:  # no kill ever fired
            warmup_end_idx = len(times)
            warmup_end_step = args.steps
        # steps 0..1 fold in first-call costs: the baseline starts after
        warm_lo = min(2, max(0, warmup_end_step - 1))
        baseline_sps = churn_sps = None
        if warmup_end_step > warm_lo and step_times:
            t_warm0 = step_times[warm_lo - 1] if warm_lo > 0 else t_run0
            baseline_span = step_times[warmup_end_step - 1] - t_warm0
            if baseline_span > 0:
                baseline_sps = (warmup_end_step - warm_lo) / baseline_span
        if warmup_end_step < len(step_times):
            churn_span = step_times[-1] - step_times[warmup_end_step - 1]
            if churn_span > 0:
                churn_sps = (len(step_times) - warmup_end_step) / churn_span
        throughput_ratio = (
            round(churn_sps / baseline_sps, 4)
            if baseline_sps and churn_sps else None
        )
        for window in graceful_windows:  # run ended mid-drain: close now
            if window[1] is None:
                window[1] = time.time() + args.ttl
        graceful_failures = sum(
            1 for t in failure_times
            if any(w[0] <= t <= w[1] for w in graceful_windows)
        )
        # dispatch_times is a bounded deque: on a long soak it wraps and
        # warmup_end_idx no longer marks the kill boundary — fall back to
        # the whole retained window (mostly churn-phase by then) and say
        # so, instead of silently gating on a misaligned slice
        wrapped = (
            moe.dispatch_times.maxlen is not None
            and len(times) >= moe.dispatch_times.maxlen
        )
        if wrapped:
            print(json.dumps({"event": "dispatch_window_wrapped",
                              "retained": len(times)}), flush=True)
        churn_samples = times if wrapped else times[warmup_end_idx:]
        churn_p99 = percentile_ms(churn_samples, 99)
        # the 5 slowest churn steps, for calibrating the profiles: which
        # steps ate the disruption, and how much (wall seconds each)
        durs = np.diff(np.asarray([t_run0] + step_times))
        slowest = sorted(
            (
                (round(float(d), 3), i)
                for i, d in enumerate(durs)
                if i >= (warmup_end_step or 0)
            ),
            reverse=True,
        )[:5]
        slo = {
            "throughput_floor": args.slo_throughput_frac,
            "throughput_ok": (
                throughput_ratio is None
                or throughput_ratio >= args.slo_throughput_frac
            ),
            "p99_ceiling_ms": args.slo_p99_ms or None,
            # a configured ceiling with NO samples to check is a failure,
            # never a vacuous pass (zero dispatches means nothing served)
            "p99_ok": (
                not args.slo_p99_ms
                or (churn_p99 is not None and churn_p99 <= args.slo_p99_ms)
            ),
            "graceful_zero_failures_ok": graceful_failures == 0,
        }
        slo["pass"] = all(
            v for k, v in slo.items() if k.endswith("_ok")
        )
        routing = moe.dispatch_stats()["routing"]
        summary = {
            "metric": "churn_slo_summary",
            "profile": args.profile,
            "steps": args.steps,
            "kills": kills,
            "relaunches": relaunches,
            "graceful_windows": len(graceful_windows),
            "quorum_failures": quorum_failures,
            "quorum_failures_during_graceful_drains": graceful_failures,
            "quorum_success_rate": round(1 - quorum_failures / args.steps, 4),
            "baseline_steps_per_s": (
                round(baseline_sps, 3) if baseline_sps else None
            ),
            "churn_steps_per_s": round(churn_sps, 3) if churn_sps else None,
            "throughput_ratio": throughput_ratio,
            "dispatch_p50_ms": percentile_ms(times, 50),
            "dispatch_p99_churn_ms": (
                round(churn_p99, 2) if churn_p99 is not None else None
            ),
            "samples_dropped": moe.samples_dropped,
            # hedged replica dispatch: under --replicate-first,
            # a killed primary should cost hedge windows, not quorums
            "hedge_fires": routing["hedge_fires"],
            "hedge_wins": routing["hedge_wins"],
            "routing_bias_applied": routing["bias_applied"],
            # stale-while-revalidate: dispatches served from a stale
            # alive set while a background refresh ran (the lookups the
            # dispatch path did NOT block on)
            "alive_stale_serves": moe.alive_cache.stale_serves,
            "alive_refresh_failures": moe.alive_cache.refresh_failures,
            "slowest_churn_steps": [
                {"step": i, "s": d} for d, i in slowest
            ],
            "slo": slo,
        }
        if avg_main is not None:
            s = avg_main.stats()
            summary["averaging_rounds"] = s["rounds"]
            summary["averaging_degraded_fraction"] = round(
                s["degraded_rounds"] / max(1, s["rounds"]), 4
            )
            summary["averaging_matchmaking_failures"] = (
                s["matchmaking_failures"]
            )
        print(json.dumps(summary), flush=True)
        if args.report:
            with open(args.report, "w") as f:
                json.dump(summary, f, indent=2)
        if not slo["pass"] and not args.no_slo_gate:
            print(json.dumps({"event": "slo_violation", "slo": slo}),
                  flush=True)
            exit_code = 1
    finally:
        if comp_stop is not None:
            comp_stop.set()
        for averager in (avg_main, avg_comp):
            if averager is not None:
                averager.shutdown()
        for proc in servers.values():
            # teardown must be prompt, not graceful: drains here would
            # serialize the exit behind n_servers grace windows
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in servers.values():
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
        if client_dht is not None:
            client_dht.shutdown()
        bootstrap.shutdown()
        reset_client_rpc()
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
