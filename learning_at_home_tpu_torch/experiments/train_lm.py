"""DMoE-Transformer LM training -- [BJ] config 3 (256-expert grid).

The port of ``experiments/train_lm.py``: its flags, JSON lines and exit
codes, plus ``--device`` (default: the CUDA card; without one it raises).

- ``--mode pod``   : the MoE layers' experts on the card, one train step a
  batch (bf16 compute on the card, f32 on the CPU, the JAX script's rule);
  ``--optimizer adamw`` or ``adafactor`` (optax's chain,
  ``optim.adafactor``), checkpoint and resume.  Launched on N ranks
  (``torchrun --nproc-per-node N -m
  learning_at_home_tpu_torch.experiments.train_lm --mode pod ...``) it
  runs on the JAX script's mesh ``{"data": dp, "expert": N // dp}`` (dp 2
  when N is even and > 2, else 1), over ``nccl`` on the cards or ``gloo``
  with ``--device cpu``; each rank trains on its rows of every batch and
  rank 0 prints.  Checkpoints on more than one rank are not ported yet.
- ``--mode swarm`` : the decentralized path -- this process starts N
  expert servers and a DHT swarm on localhost (in-process, or
  ``--subprocess-servers`` through ``python -m
  learning_at_home_tpu_torch.server``, or none with ``--initial-peers``),
  then trains a local trunk against DHT-discovered remote experts (async
  server-side adam).  ``--n-trainers N`` spawns N trainer processes of
  this module against one set of servers.

Data: ``--data /path/to/corpus.txt`` (or a .npy token file); without it a
synthetic Zipfian corpus (``models/data.py``).

Examples:
  python -m learning_at_home_tpu_torch.experiments.train_lm --mode pod \\
      --steps 200
  torchrun --nproc-per-node 4 -m \\
      learning_at_home_tpu_torch.experiments.train_lm --mode pod --steps 200
  python -m learning_at_home_tpu_torch.experiments.train_lm --mode swarm \\
      --experts-per-layer 16 --n-servers 2 --steps 50 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

MODULE = "learning_at_home_tpu_torch.experiments.train_lm"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the deadline for every expert to appear in the DHT: a card server's
# CUDA start and its experts' draws come before its first heartbeat
DISCOVERY_DEADLINE_S = 120.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["pod", "swarm"], default="pod")
    p.add_argument("--data", default=None, help="local corpus (.txt/.npy)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--num-experts", type=int, default=256, help="pod mode")
    p.add_argument("--experts-per-layer", type=int, default=16,
                   help="swarm mode")
    p.add_argument("--n-servers", type=int, default=2, help="swarm mode")
    p.add_argument("--subprocess-servers", action="store_true",
                   help="swarm mode: host experts in separate server "
                        "processes (the production topology)")
    p.add_argument("--base-port", type=int, default=0,
                   help="swarm mode: fixed base port for spawned expert "
                        "servers (server s binds base+s). Default 0 = each "
                        "server binds an ephemeral port and trainers "
                        "discover endpoints via the DHT")
    p.add_argument("--initial-peers", default=None,
                   help="swarm mode: comma-separated host:port DHT peers of "
                        "an existing swarm to join as a pure trainer (no "
                        "servers are spawned)")
    p.add_argument("--data-shard", default=None, metavar="I:N",
                   help="train on the I-th of N contiguous corpus shards "
                        "(disjoint data per trainer in multi-trainer runs)")
    p.add_argument("--n-trainers", type=int, default=1,
                   help="swarm mode: spawn this many independent trainer "
                        "processes (own trunk+gates, disjoint data shards) "
                        "against one shared expert swarm")
    p.add_argument("--pipeline", type=int, default=1,
                   help="swarm mode: concurrent micro-batch steps in flight "
                        "(PipelinedSwarmTrainer; 1 = sequential)")
    p.add_argument("--overlap", action="store_true",
                   help="swarm mode: the shortcut schedule (each layer's "
                        "expert fan-out flies while its attention "
                        "computes); loss curves compare only against "
                        "--overlap-serial")
    p.add_argument("--overlap-serial", action="store_true",
                   help="swarm mode: the shortcut architecture with the "
                        "serial schedule (join right after fire), the "
                        "bitwise A/B arm of --overlap")
    p.add_argument("--chaos-bandwidth", type=float, default=0.0,
                   help="swarm mode: emulated server link bandwidth in "
                        "bytes/sec (0 = unlimited)")
    p.add_argument("--chaos-latency", type=float, default=0.0,
                   help="swarm + --subprocess-servers: inject WAN-like "
                        "latency (s) on every server reply")
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--optimizer", choices=("adamw", "adafactor"),
                   default="adamw",
                   help="pod mode: adafactor (factored, ~no state) or adamw")
    p.add_argument("--param-dtype", choices=("f32", "bf16"), default="f32",
                   help="pod mode: parameter storage dtype (bf16 halves "
                        "memory)")
    p.add_argument("--router-jitter", type=float, default=0.0,
                   help="pod mode: multiplicative routing noise, "
                        "selection-only (0 = off)")
    p.add_argument("--aux-weight", type=float, default=1e-2,
                   help="pod mode: load-balance auxiliary loss weight")
    p.add_argument("--gating", choices=("topk", "expert_choice"),
                   default="topk",
                   help="pod mode: token-choice top-k (capacity drops) or "
                        "expert-choice (each expert picks top-C tokens)")
    p.add_argument("--averaging", action="store_true",
                   help="swarm mode: decentralized trunk/gate parameter "
                        "averaging across trainers; a final blocking round "
                        "runs after training, so co-scheduled trainers end "
                        "with identical trunks")
    p.add_argument("--averaging-every", type=int, default=10,
                   help="steps between averaging rounds")
    p.add_argument("--averaging-group-size", type=int, default=2,
                   help="minimum trainers per averaging round")
    p.add_argument("--averaging-timeout", type=float, default=30.0,
                   help="matchmaking budget per round (s); a round that "
                        "finds no group is skipped and counted")
    p.add_argument("--wire-dtype", default=None,
                   choices=["bfloat16", "float16"],
                   help="swarm mode: downcast activation/grad RPC payloads "
                        "on the wire (servers still compute in f32)")
    p.add_argument("--wire-codec", default=None,
                   choices=["none", "bf16", "f16", "u8", "blockq8"],
                   help="swarm mode: pin the wire codec for dispatch "
                        "payloads.  Default: adaptive per-pool escalation")
    p.add_argument("--latency-weight", type=float, default=0.0,
                   help="swarm mode: debit expert selection scores by this "
                        "x endpoint RTT EMA (s)")
    p.add_argument("--routing-cost-weight", type=float, default=None,
                   help="swarm mode: latency-aware routing cost model "
                        "weight; 0 = off; default: --latency-weight")
    p.add_argument("--telemetry-prefix", default="swarm",
                   help="swarm mode: advertise this trainer's metrics "
                        "endpoint under telemetry.<prefix> in the DHT")
    p.add_argument("--no-telemetry", action="store_true",
                   help="swarm mode: don't host/advertise a metrics "
                        "endpoint for this trainer")
    p.add_argument("--telemetry-host", default="127.0.0.1",
                   help="swarm mode: host the trainer's metrics endpoint "
                        "binds and advertises in the DHT")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-dir", default=None,
                   help="trainer-side checkpoints (pod and swarm modes)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="steps between checkpoints (0 = end of run only)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device of the model, the trainer and its "
                        "servers (default: the CUDA card; 'cpu' to run on "
                        "the CPU)")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.n_trainers > 1 and args.mode != "swarm":
        p.error("--n-trainers requires --mode swarm (pod mode is one "
                "trainer; concurrency there is the device)")
    if args.averaging and args.mode != "swarm":
        p.error("--averaging requires --mode swarm (pod mode's trunk is "
                "one program -- it cannot diverge)")
    if args.overlap and args.overlap_serial:
        p.error("--overlap and --overlap-serial are the two arms of one "
                "A/B -- pick one")
    if (args.overlap or args.overlap_serial) and args.mode != "swarm":
        p.error("--overlap[-serial] requires --mode swarm (pod mode has "
                "no remote dispatch to overlap)")
    if (args.overlap or args.overlap_serial) and args.pipeline > 1:
        p.error("--overlap[-serial] drives the sequential step; "
                "--pipeline overlap is a different axis (pick one)")
    return args


def _device(args):
    from learning_at_home_tpu_torch.device import resolve_device

    return resolve_device(args.device)


def _ids(a):
    """A batch's token array as a tensor (the step moves it)."""
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _pod_mesh(args, dev):
    """The JAX script's mesh over the job's ranks, or None for one rank
    (the single-device model).  Joins the job ``torchrun`` describes in
    the environment when no process group exists yet."""
    import torch
    import torch.distributed as dist

    from learning_at_home_tpu_torch.parallel.mesh import make_mesh, rank_device

    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        if dev.type != "cpu":
            torch.cuda.set_device(rank_device(args.device))
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
    n = dist.get_world_size()
    if n == 1:
        return None
    dp = 2 if n % 2 == 0 and n > 2 else 1
    # the rank's card (cuda:LOCAL_RANK) unless --device names one
    mesh = make_mesh({"data": dp, "expert": n // dp}, device=args.device)
    if args.batch_size % n:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by the "
            f"{n} batch shards of mesh {mesh.shape}"
        )
    if args.checkpoint_dir:
        raise SystemExit("--checkpoint-dir on more than one rank is not "
                         "ported yet (ROADMAP.md, queue 1)")
    return mesh


def run_pod(args) -> dict:
    """The pod-mode loop.  Returns ``{"losses": [...], "wall_s": [...]}``:
    the unrounded loss and the seconds since the first step at each
    logged step (the loss read waits for the step's work).  On a mesh
    every rank returns them and rank 0 prints."""
    import torch

    from learning_at_home_tpu_torch import optim
    from learning_at_home_tpu_torch import random as prng
    from learning_at_home_tpu_torch.models.data import (
        VOCAB_SIZE,
        LMBatcher,
        load_corpus,
    )
    from learning_at_home_tpu_torch.models.transformer import (
        DMoETransformerConfig,
        DMoETransformerLM,
    )

    dev = _device(args)
    mesh = _pod_mesh(args, dev)
    if mesh is not None:
        dev = mesh.device
    printing = mesh is None or mesh.rank == 0
    cfg = DMoETransformerConfig(
        vocab_size=VOCAB_SIZE,
        d_model=args.d_model,
        n_layers=args.n_layers,
        seq_len=args.seq_len,
        num_experts=args.num_experts,
        k=args.k,
        dtype=torch.bfloat16 if dev.type != "cpu" else torch.float32,
        param_dtype=(torch.bfloat16 if args.param_dtype == "bf16"
                     else torch.float32),
        router_jitter=args.router_jitter,
        aux_loss_weight=args.aux_weight,
        gating=args.gating,
    )
    model = DMoETransformerLM(cfg, device=dev, mesh=mesh)
    params = model.init_params(prng.PRNGKey(args.seed))
    optimizer = (optim.adafactor(args.lr, mesh=mesh,
                                 specs=model.param_specs(params))
                 if args.optimizer == "adafactor" else optim.adamw(args.lr))
    opt_state = model.init_opt_state(optimizer, params)
    step_fn = model.make_train_step(optimizer)

    ckpt = None
    start_step = 0
    if args.checkpoint_dir:
        from learning_at_home_tpu_torch.utils.checkpoint import (
            TrainCheckpointer,
        )

        ckpt = TrainCheckpointer(args.checkpoint_dir)
        if args.resume:
            restored = ckpt.restore_latest(params, opt_state)
            if restored is not None:
                start_step, params, opt_state = restored
                print(f"# resumed from step {start_step}", flush=True)

    tokens = load_corpus(args.data, seed=args.seed)
    batches = LMBatcher(tokens, args.batch_size, args.seq_len, seed=args.seed)
    batches.skip(start_step)  # resume continues the data order, no replay

    out = {"losses": [], "wall_s": []}
    t0 = time.perf_counter()
    for step, (ids, tgt) in zip(range(start_step, args.steps), batches):
        params, opt_state, loss, metrics = step_fn(
            params, opt_state, model.local_batch(_ids(ids)),
            model.local_batch(_ids(tgt)))
        if ckpt and args.checkpoint_every and \
                (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, params, opt_state)
        if step % args.log_every == 0 or step == args.steps - 1:
            value = float(loss)
            elapsed = time.perf_counter() - t0
            out["losses"].append(value)
            out["wall_s"].append(elapsed)
            tps = ((step + 1 - start_step) * args.batch_size * args.seq_len
                   / elapsed)
            if not printing:
                continue
            print(json.dumps({
                "step": step,
                "loss": round(value, 4),
                "ce": round(float(metrics["ce"]), 4),
                "dropped": round(float(metrics["dropped_fraction"]), 4),
                "tokens_per_sec": round(tps, 1),
            }), flush=True)
    if ckpt is not None:
        ckpt.save(args.steps, params, opt_state)
        print(f"# checkpointed final step {args.steps}", flush=True)
    return out


def _uids_for_server(args, s: int) -> list[str]:
    """Experts strided across servers: ffn{layer}.{i} for i = s (mod n)."""
    return [
        f"ffn{layer}.{i}"
        for layer in range(args.n_layers)
        for i in range(args.experts_per_layer)
        if i % args.n_servers == s
    ]


def _spawn_servers(args, bootstrap_endpoint):
    """Launch the expert-server subprocesses of a swarm (shared by the
    single-trainer --subprocess-servers path and the --n-trainers
    orchestrator); each runs on ``args.device``."""
    import subprocess

    from learning_at_home_tpu_torch.utils.subproc import (
        SERVER_MODULE,
        clean_subprocess_env,
    )

    env = clean_subprocess_env(REPO)
    procs = []
    for s in range(args.n_servers):
        uids = _uids_for_server(args, s)
        if not uids:
            continue  # more servers than experts: nothing to host
        procs.append(subprocess.Popen(
            [
                sys.executable, "-m", SERVER_MODULE,
                "--expert-uids", ",".join(uids),
                "--hidden-dim", str(args.d_model),
                # ephemeral by default: the DHT heartbeat publishes the
                # real endpoint, so nothing ever collides
                "--port",
                str(args.base_port + s) if args.base_port else "0",
                "--initial-peers",
                f"{bootstrap_endpoint[0]}:{bootstrap_endpoint[1]}",
                "--update-period", "5.0",
                "--optimizer", "adam", "--lr", str(args.lr),
                "--max-batch-size", "4096",
                *(["--device", args.device] if args.device else []),
            ]
            + (["--chaos-latency", str(args.chaos_latency)]
               if args.chaos_latency else [])
            + (["--chaos-bandwidth", str(args.chaos_bandwidth)]
               if args.chaos_bandwidth else []),
            env=env,
        ))
    return procs


def _wait_for_experts(client_dht, procs, n_layers: int, want: int,
                      deadline_s: float = DISCOVERY_DEADLINE_S) -> int:
    """Poll the DHT until ``want`` experts are alive (or the deadline
    passes), failing fast if a server subprocess dies during startup.
    Returns the number found."""
    deadline = time.time() + deadline_s
    found = 0
    while time.time() < deadline:
        for proc in procs:
            if proc.poll() is not None:
                raise SystemExit(
                    f"server process exited with {proc.returncode} during "
                    "startup (port in use? see its log)"
                )
        found = sum(
            len(client_dht._loop.run(client_dht._get_alive(f"ffn{layer}")))
            for layer in range(n_layers)
        )
        if found >= want:
            break
        time.sleep(0.25)
    return found


def _rpc_server_stats(client_dht, n_layers: int) -> dict | None:
    """Merged server-wide ``stats`` over every alive peer: ONE RPC per
    endpoint.  Returns ``{"update_count_total": int, "update_count":
    {uid: int}}`` or None -- telemetry must never kill a training loop."""
    try:
        import asyncio

        from learning_at_home_tpu_torch.client.rpc import (
            client_loop,
            pool_registry,
        )

        alive_all: dict = {}
        for layer in range(n_layers):
            alive_all.update(
                client_dht._loop.run(client_dht._get_alive(f"ffn{layer}"))
            )
        endpoints = {tuple(ep) for ep in alive_all.values()}
        registry = pool_registry()

        async def gather():
            async def one(ep):
                _, meta = await registry.get(ep).rpc("stats", (), {},
                                                     timeout=5.0)
                return meta

            return await asyncio.gather(
                *(one(ep) for ep in endpoints), return_exceptions=True
            )

        merged = {"update_count_total": 0, "update_count": {}}
        for meta in client_loop().run(gather()):
            if isinstance(meta, dict):
                merged["update_count_total"] += int(
                    meta.get("update_count_total", 0)
                )
                merged["update_count"].update(meta.get("update_count", {}))
        return merged
    except Exception:  # telemetry must never kill a training loop
        return None


def run_swarm(args) -> dict:
    """The swarm-mode trainer.  Returns ``{"losses": [...], "params":
    ...}``: every step's unrounded loss (the sequential loop) or the
    pipelined trainer's, and the final trunk and gate params."""
    import signal
    import zlib

    import numpy as np

    from learning_at_home_tpu_torch import optim
    from learning_at_home_tpu_torch import random as prng
    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.convert import tensor_to_numpy
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.models.data import (
        VOCAB_SIZE,
        LMBatcher,
        load_corpus,
    )
    from learning_at_home_tpu_torch.models.layers import make_expert
    from learning_at_home_tpu_torch.models.transformer_swarm import (
        SwarmDMoETransformerLM,
        SwarmTransformerConfig,
    )
    from learning_at_home_tpu_torch.server import ExpertBackend, Server
    from learning_at_home_tpu_torch.tree import jax_tree_leaves

    dev = _device(args)
    # SIGTERM (e.g. `timeout`) must run the finally-block below, or the
    # spawned server subprocesses outlive us and eat the host's cores
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    if args.pipeline > 1 and not args.subprocess_servers:
        print(
            "# WARNING: --pipeline > 1 with in-process servers shares this "
            "process's interpreter between the trainer's workers and the "
            "servers' loops; use --subprocess-servers (the production "
            "topology).", flush=True)
    grid = (args.experts_per_layer,)
    if args.initial_peers:
        # pure-trainer mode: join an existing swarm
        peers = [
            (host, int(port))
            for host, port in
            (e.rsplit(":", 1) for e in args.initial_peers.split(","))
        ]
        servers, dhts, procs = [], [], []
    elif args.subprocess_servers:
        bootstrap = DHT()
        peers = [bootstrap.endpoint]
        servers, dhts = [], [bootstrap]
        procs = _spawn_servers(args, bootstrap.endpoint)
    else:
        bootstrap = DHT()
        peers = [bootstrap.endpoint]
        servers, dhts, procs = [], [bootstrap], []
        for s in range(args.n_servers):
            uids = _uids_for_server(args, s)
            if not uids:
                continue
            experts = {}
            for uid in uids:
                # crc32 seeding: deterministic across runs AND identical
                # to the subprocess path (hash() is salted per interpreter)
                key = prng.PRNGKey(zlib.crc32(uid.encode()) & 0x7FFFFFFF)
                apply_fn, params = make_expert("ffn", args.d_model, key,
                                               device=dev)
                experts[uid] = ExpertBackend(
                    uid, apply_fn, params, optim.adam(args.lr),
                    max_batch_size=4096, device=dev)
            dht = DHT(initial_peers=[bootstrap.endpoint])
            dhts.append(dht)
            server = Server(experts, host="127.0.0.1", dht=dht,
                            update_period=5.0)
            server.run_in_background()
            servers.append(server)
    client_dht = DHT(initial_peers=peers)
    dhts.append(client_dht)

    want = args.n_layers * args.experts_per_layer
    found = _wait_for_experts(client_dht, procs, args.n_layers, want)
    print(f"# discovered {found}/{want} experts via DHT", flush=True)

    cfg = SwarmTransformerConfig(
        vocab_size=VOCAB_SIZE,
        d_model=args.d_model,
        n_layers=args.n_layers,
        seq_len=args.seq_len,
        grid_size=grid,
        k_best=args.k,
        wire_dtype=args.wire_dtype,
        wire_codec=args.wire_codec,
        latency_weight=args.latency_weight,
        routing_cost_weight=args.routing_cost_weight,
        telemetry_prefix=args.telemetry_prefix,
    )
    model = SwarmDMoETransformerLM(cfg, client_dht)
    params = model.init_params(prng.PRNGKey(args.seed), device=dev)
    optimizer = optim.adamw(args.lr)
    opt_state = optimizer.init(params)
    if args.overlap or args.overlap_serial:
        # the shortcut schedule: fire the expert fan-out, compute attention
        # while the RPCs fly, join late; the serial arm runs the same ops
        # joined at once, so the two arms' loss curves are bitwise equal
        step_fn = model.make_overlapped_train_step(
            optimizer, overlap=args.overlap)
        print(f"# shortcut schedule: "
              f"{'overlapped' if args.overlap else 'serial'}", flush=True)
    else:
        step_fn = model.make_train_step(optimizer)

    avg_session = None
    if args.averaging:
        from learning_at_home_tpu_torch.averaging import (
            AveragingConfig,
            AveragingSession,
            DecentralizedAverager,
        )

        averager = DecentralizedAverager(
            client_dht,
            config=AveragingConfig(
                prefix="averaging.trunk",
                min_group_size=args.averaging_group_size,
                matchmaking_timeout=args.averaging_timeout,
            ),
        )
        avg_session = AveragingSession(averager,
                                       every_steps=args.averaging_every)
        print(f"# averaging peer {averager.peer_id} on "
              f"{averager.endpoint[0]}:{averager.endpoint[1]}", flush=True)

    telemetry = None
    if not args.no_telemetry:
        from learning_at_home_tpu_torch.utils.telemetry import (
            TelemetryPublisher,
        )

        def _trainer_extra():
            extra = {"dispatch": model.moes[0].dispatch_stats()
                     if model.moes else {}}
            if avg_session is not None:
                extra["averaging"] = avg_session.averaging_stats()
            return extra

        try:
            telemetry = TelemetryPublisher(
                client_dht, prefix=args.telemetry_prefix, role="trainer",
                host=args.telemetry_host, extra_fn=_trainer_extra,
            ).start()
            print(f"# trainer metrics endpoint http://{telemetry.endpoint[0]}:"
                  f"{telemetry.port}/metrics (telemetry."
                  f"{args.telemetry_prefix})", flush=True)
        except Exception as e:  # telemetry must never kill training
            print(f"# telemetry endpoint failed to start: {e}", flush=True)
            telemetry = None

    # client-side recovery: the trainer's trunk+gate params resume from a
    # checkpoint; expert params recover via the servers' own checkpoints
    ckpt = start_step = None
    if args.checkpoint_dir:
        from learning_at_home_tpu_torch.utils.checkpoint import (
            TrainCheckpointer,
        )

        ckpt = TrainCheckpointer(args.checkpoint_dir)
        start_step = 0
        if args.resume:
            restored = ckpt.restore_latest(params, opt_state)
            if restored is not None:
                start_step, params, opt_state = restored
                print(f"# resumed trainer from step {start_step}", flush=True)

    tokens = load_corpus(args.data, seed=args.seed)
    if args.data_shard:
        i, n = (int(x) for x in args.data_shard.split(":"))
        if not 0 <= i < n:
            raise SystemExit(f"--data-shard {args.data_shard}: need 0 <= I < N")
        lo, hi = i * len(tokens) // n, (i + 1) * len(tokens) // n
        tokens = tokens[lo:hi]
        print(f"# data shard {i}:{n} -> tokens [{lo}:{hi})", flush=True)
    batches = LMBatcher(tokens, args.batch_size, args.seq_len, seed=args.seed)
    if start_step:
        batches.skip(start_step)  # continue the data order, no replay

    def dispatch_p50() -> float | None:
        times = list(model.moes[0].dispatch_times)
        return float(np.median(times) * 1000) if times else None

    def backward_rpcs() -> tuple[int, int]:
        """Cumulative (sent, acked) backward RPCs across all MoE layers;
        the servers' summed ``update_count`` is bounded by ``sent`` (a
        cancelled straggler still executes server-side)."""
        return (sum(m.backward_rpcs_sent for m in model.moes),
                sum(m.backward_rpcs_ok for m in model.moes))

    def server_update_total() -> int | None:
        """Total async optimizer steps applied across all experts:
        in-process servers read directly, others by one ``stats`` RPC a
        peer."""
        if servers:
            return sum(b.update_count for srv in servers
                       for b in srv.experts.values())
        stats = _rpc_server_stats(client_dht, args.n_layers)
        return stats["update_count_total"] if stats else None

    losses: list[float] = []
    try:
        if args.pipeline > 1:
            from learning_at_home_tpu_torch.client import PipelinedSwarmTrainer

            trainer = PipelinedSwarmTrainer(
                model, optimizer, params, opt_state, n_workers=args.pipeline)
            if avg_session is not None:
                # background rounds: snapshot under the apply lock, apply
                # the group delta atomically
                trainer.attach_averaging(avg_session)

            def on_log(entry):
                p50 = dispatch_p50()
                entry["dispatch_p50_ms"] = round(p50, 2) if p50 else None
                print(json.dumps(entry), flush=True)
                if (ckpt is not None and args.checkpoint_every
                        and entry["step"] % args.checkpoint_every == 0):
                    # consistent triple under the trainer's apply lock
                    p, o, done = trainer.snapshot()
                    ckpt.save((start_step or 0) + done, p, o)

            summary = trainer.train(
                batches, steps=args.steps - (start_step or 0),
                log_every=args.log_every, on_log=on_log,
                tokens_per_batch=args.batch_size * args.seq_len,
            )
            if avg_session is not None:
                # a background round may still be applying its delta
                avg_session.wait_idle()
            params, opt_state = trainer.params, trainer.opt_state
            losses = list(trainer.losses)
            p50 = dispatch_p50()
            sent, acked = backward_rpcs()
            summary_json = {
                "pipeline": args.pipeline,
                "tokens_per_sec": round(summary["tokens_per_sec"], 1),
                "final_loss": round(summary["final_loss"], 4),
                "dispatch_p50_ms": round(p50, 2) if p50 is not None else None,
                "server_updates": server_update_total(),
                "backward_rpcs_sent": sent,
                "backward_rpcs_ok": acked,
            }
            if avg_session is not None:
                summary_json["averaging"] = trainer.averaging_stats()
            print(json.dumps(summary_json), flush=True)
        else:
            t0 = time.perf_counter()
            for step, (ids, tgt) in zip(range(start_step or 0, args.steps),
                                        batches):
                params, opt_state, loss = step_fn(params, opt_state, ids, tgt)
                losses.append(float(loss))
                if (avg_session is not None
                        and (step + 1) % args.averaging_every == 0
                        and step + 1 < args.steps):  # the final round follows
                    # BLOCKING round between steps: co-scheduled trainers
                    # rendezvous at the same step and leave with the mean
                    params = avg_session.blocking_round(params)
                if (ckpt is not None and args.checkpoint_every
                        and (step + 1) % args.checkpoint_every == 0):
                    ckpt.save(step + 1, params, opt_state)
                if step % args.log_every == 0 or step == args.steps - 1:
                    elapsed = time.perf_counter() - t0
                    tps = ((step + 1 - (start_step or 0))
                           * args.batch_size * args.seq_len / elapsed)
                    p50 = dispatch_p50()
                    sent, acked = backward_rpcs()
                    print(json.dumps({
                        "step": step,
                        "loss": round(losses[-1], 4),
                        "tokens_per_sec": round(tps, 1),
                        "dispatch_p50_ms": round(p50, 2) if p50 else None,
                        "server_updates": server_update_total(),
                        "backward_rpcs_sent": sent,
                        "backward_rpcs_ok": acked,
                    }), flush=True)
        if avg_session is not None:
            # final blocking round: every participant ends with identical
            # trunk+gate parameters
            avg_session.wait_idle()
            params = avg_session.blocking_round(
                params, matchmaking_timeout=args.averaging_timeout * 2)
            print(json.dumps({"averaging": avg_session.averaging_stats()}),
                  flush=True)
            if args.checkpoint_dir:
                os.makedirs(args.checkpoint_dir, exist_ok=True)
                np.savez(
                    os.path.join(args.checkpoint_dir, "avg_final_params.npz"),
                    **{f"p{i}": tensor_to_numpy(leaf)
                       for i, leaf in enumerate(jax_tree_leaves(params))},
                )
        if ckpt is not None:
            ckpt.save(args.steps, params, opt_state)
            print(f"# checkpointed trainer at step {args.steps}", flush=True)
    finally:
        if telemetry is not None:
            telemetry.stop()
        if avg_session is not None:
            avg_session.shutdown()
        for server in servers:
            server.shutdown()
        for proc in procs:
            proc.terminate()
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except Exception:
                proc.kill()
                proc.wait(timeout=10)  # reap; no zombies
        for dht in dhts:
            dht.shutdown()
        reset_client_rpc()
    return {"losses": losses, "params": params}


def run_multi_trainer(args) -> dict:
    """Many independent trainers sharing one expert pool: spawn the expert
    servers ONCE, then ``--n-trainers`` trainer processes of this module,
    each with its own trunk+gate parameters, optimizer and contiguous
    corpus shard, all pushing batches through the same experts.

    Prints (and returns) one summary JSON with per-trainer loss curves and
    the client-vs-server ledger: ``server_updates_total`` must not exceed
    ``backward_rpcs_sent_total``."""
    import signal
    import subprocess
    import threading

    from learning_at_home_tpu_torch.client import reset_client_rpc
    from learning_at_home_tpu_torch.dht import DHT
    from learning_at_home_tpu_torch.utils.subproc import clean_subprocess_env

    _device(args)  # fail here, before any process starts, without a card
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args.initial_peers:
        raise SystemExit("--n-trainers spawns its own swarm; "
                         "drop --initial-peers")
    env = clean_subprocess_env(REPO)
    bootstrap = DHT()
    procs = _spawn_servers(args, bootstrap.endpoint)
    client_dht = DHT(initial_peers=[bootstrap.endpoint])
    trainers: list[subprocess.Popen] = []
    logs: list[list[dict]] = [[] for _ in range(args.n_trainers)]
    try:
        # all experts discoverable BEFORE any trainer starts
        want = args.n_layers * args.experts_per_layer
        found = _wait_for_experts(client_dht, procs, args.n_layers, want)
        print(f"# orchestrator: {found}/{want} experts alive", flush=True)

        peers_arg = f"{bootstrap.endpoint[0]}:{bootstrap.endpoint[1]}"
        base = [
            sys.executable, "-m", MODULE, "--mode", "swarm",
            "--initial-peers", peers_arg,
            "--steps", str(args.steps),
            "--batch-size", str(args.batch_size),
            "--seq-len", str(args.seq_len),
            "--d-model", str(args.d_model),
            "--n-layers", str(args.n_layers),
            "--experts-per-layer", str(args.experts_per_layer),
            "--n-servers", str(args.n_servers),
            "--k", str(args.k),
            "--lr", str(args.lr),
            "--log-every", str(args.log_every),
            "--pipeline", str(args.pipeline),
        ]
        if args.device:
            base += ["--device", args.device]
        if args.data:
            base += ["--data", args.data]
        if args.overlap:
            base += ["--overlap"]
        if args.overlap_serial:
            base += ["--overlap-serial"]
        if args.averaging:
            base += [
                "--averaging",
                "--averaging-every", str(args.averaging_every),
                "--averaging-group-size", str(args.averaging_group_size),
                "--averaging-timeout", str(args.averaging_timeout),
            ]
        if args.wire_dtype:
            base += ["--wire-dtype", args.wire_dtype]
        if args.wire_codec:
            base += ["--wire-codec", args.wire_codec]
        if args.latency_weight:
            base += ["--latency-weight", str(args.latency_weight)]
        if args.routing_cost_weight is not None:
            base += ["--routing-cost-weight", str(args.routing_cost_weight)]
        if args.checkpoint_every:
            base += ["--checkpoint-every", str(args.checkpoint_every)]
        for t in range(args.n_trainers):
            cmd = base + ["--seed", str(args.seed + t),
                          "--data-shard", f"{t}:{args.n_trainers}"]
            if args.checkpoint_dir:
                # each trainer owns its trunk/gate state: per-trainer dirs
                cmd += ["--checkpoint-dir",
                        os.path.join(args.checkpoint_dir, f"t{t}")]
                if args.resume:
                    cmd += ["--resume"]
            trainers.append(subprocess.Popen(
                cmd, env=env, text=True, stdout=subprocess.PIPE,
            ))  # stderr: this process's own

        def pump(t: int, proc: subprocess.Popen) -> None:
            for line in proc.stdout:
                line = line.rstrip("\n")
                print(f"[t{t}] {line}", flush=True)
                if line.startswith("{"):
                    try:
                        logs[t].append(json.loads(line))
                    except json.JSONDecodeError:
                        pass

        pumps = [threading.Thread(target=pump, args=(t, p), daemon=True)
                 for t, p in enumerate(trainers)]
        for th in pumps:
            th.start()
        rcs = [p.wait() for p in trainers]
        for th in pumps:
            th.join(timeout=10)
        if any(rc != 0 for rc in rcs):
            raise SystemExit(f"trainer exit codes {rcs}")

        stats = _rpc_server_stats(client_dht, args.n_layers)
        per_trainer = []
        for t, entries in enumerate(logs):
            losses = [e["loss"] for e in entries if "loss" in e]

            def last(key: str) -> int:
                return max((e[key] for e in entries
                            if e.get(key) is not None), default=0)

            avg_stats = [e["averaging"] for e in entries if "averaging" in e]
            per_trainer.append({
                "trainer": t,
                "first_loss": losses[0] if losses else None,
                "final_loss": losses[-1] if losses else None,
                "backward_rpcs_sent": last("backward_rpcs_sent"),
                "backward_rpcs_ok": last("backward_rpcs_ok"),
                "averaging_rounds": (
                    avg_stats[-1]["rounds"] if avg_stats else None),
                "averaging_degraded_rounds": (
                    avg_stats[-1]["degraded_rounds"] if avg_stats else None),
            })
        sent_total = sum(t["backward_rpcs_sent"] for t in per_trainer)
        ok_total = sum(t["backward_rpcs_ok"] for t in per_trainer)
        counts = list((stats or {}).get("update_count", {}).values())
        summary = {
            "n_trainers": args.n_trainers,
            "trainers": per_trainer,
            "backward_rpcs_sent_total": sent_total,
            "backward_rpcs_ok_total": ok_total,
            "server_updates_total":
                stats["update_count_total"] if stats else None,
            "experts_updated": sum(1 for c in counts if c > 0),
            "n_experts": len(counts),
        }
        print(json.dumps(summary), flush=True)
        return summary
    finally:
        for proc in trainers:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            proc.terminate()
        for proc in [*trainers, *procs]:
            try:
                proc.wait(timeout=30)
            except Exception:
                proc.kill()
                proc.wait(timeout=10)  # reap; no zombies
        client_dht.shutdown()
        bootstrap.shutdown()
        reset_client_rpc()


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "pod":
        return run_pod(args)
    if args.n_trainers > 1:
        return run_multi_trainer(args)
    return run_swarm(args)


if __name__ == "__main__":
    main()
