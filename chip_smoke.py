#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases, each of which asserts (none catches its own failure):

1. device   -- a CUDA card; prints its name and power limit (nvidia-smi).
2. build    -- compiles every kernel library of
               ``learning_at_home_tpu_torch/csrc`` for sm_90a into
               ``build/kernels/`` (one nvcc each, all at once) and prints
               ptxas's registers, static shared memory, spills, warnings
               and notes (C7512: wgmma serialised) per kernel, and the
               warp-specialised kernels' dynamic shared memory (K1-K3 with
               their grid, K2 and K3 with their cluster size).
3. kernels  -- each kernel against its plain PyTorch version on the card,
               at the main paths' shapes and at smaller ones (K5 also at
               S = 8193, one row past a tile, and its backward at
               [2832, 256, 8, 64]; K1-K3 also at a ragged n and
               V = 64 * odd), within the stated tolerances; the K5
               backward at [4, 8192, 8, 64] and K2, K3 at flagship-train's
               shape launched twice must give the same bits; K4 (token dispatch)
               bit for bit on ragged cases (f32 rows of d = 100, one
               token, every slot empty, every slot full).
4. small    -- a tiny f32 model on the card against the same model on the
               CPU (the CPU path is the one the tests hold against the JAX
               package): logits and greedy tokens; then one train step of
               a tiny bf16 fused-CE model, the card running K1-K3 and the
               CPU their plain versions: loss and gradients.
5. serving  -- ``flagship-8k`` (the 256-expert DMoE-Transformer at
               seq_len 8192, random weights from a seed) serves 2 prompts
               of 4096 tokens with 32 greedy new tokens through
               ``generate(use_cache=True)``; the kernel counts must show
               the path went through the flash kernel; the prefill logits
               must match the same model with plain attention.  The
               prefill's MoE dispatch plans are kept for phase 10.
6. training -- ``flagship-train`` (the same model at seq_len 256 with the
               single-chip training recipe: bf16 params, remat "full",
               per-layer tuple layout, fused CE, fused Adafactor 1e-3,
               batch 176) takes one warm-up step and TRAIN_STEPS timed
               steps on one fixed batch through ``make_train_step``; the
               loss must be finite and fall, each CE kernel must launch
               once per step and the flash kernels as in phase 7 (the
               ``auto`` rule picks them at every length); the fused loss
               and embedding gradient must match the chunked CE's on one
               batch, and flash attention must match plain attention as
               in phase 7.
7. long-context training -- ``flagship-8k-train`` (the same recipe at
               seq_len 8192, batch 4: the ``auto`` rule picks the flash
               kernels, forward and backward) the same way; each step must
               launch the flash forward 8 times (4 layers and their remat
               recompute), the dkv and dq kernels 4 times each and K1-K3
               once each; on one batch of 8192 tokens (1 row; 32 rows
               in phase 6) the loss and every
               gradient leaf must agree with plain attention on the same
               weights, with each path routing by itself and with the
               plain path replaying the flash path's routing (the
               routing choices that differ are counted per layer), and
               no leaf's gradient may be all zeros.
8. balanced training -- ``flagship-train-balanced``: ``flagship-train``
               with the balanced-routing recipe of bench.py (router jitter
               0.1, aux-loss weight 5e-2): the first step's dropped
               fraction must be below the same weights' without jitter,
               and remat's recompute must route every token as the forward
               did; BALANCE_STEPS untimed steps, then TRAIN_STEPS timed
               ones with ``flagship-train``'s launches per step; the
               dropped fraction of every step is printed; each layer's
               jitter noise drawn on the card must equal the CPU's bit for
               bit.
9. short runs -- ``flagship-train`` with expert-choice gating and with
               remat "dots": a warm-up step and SHORT_STEPS timed steps
               each, the loss must fall; expert choice prints its
               uncovered fraction; "dots" must give "full"'s loss and
               gradients on one batch bit for bit and prints the memory of
               both.
10. token dispatch -- K4's path: ``dispatch_tokens_auto(use_kernel=True)``
               on the dispatch plans the flagship's MoE layers made in
               phases 5, 6, 7 and 8 (the balanced run's after its balance
               steps); each output must equal the plain version's bit for
               bit.
11. swarm    -- ``swarm-ffn4-h1024`` ([BJ] config 2): a port expert
               server on the card (4 ``ffn`` experts at hidden 1024, the
               port of ``optax.adam(1e-3)``, max batch 1024, warmed up)
               behind loopback RPC, and the port's
               ``RemoteMixtureOfExperts`` (grid (4,), top-2, k_min 1)
               with gate params and 256 x 1024 f32 inputs on the card.
               First, against a CPU copy of the same server and client on
               the same weights, SWARM_CHECK_STEPS steps from a fresh
               state, every reply awaited: one forward's output and one
               backward's x and gate gradients, and the experts' params
               after the steps (at the tight limit where every step's
               gradient is well above the two sides' difference, since
               adam's first step is ~lr * sign(g)).  Then, from the fresh
               state again, the main path: SWARM_TRAIN_STEPS steps of a
               fixed synthetic regression (gate trained by the client's
               adam) must lower the loss, SWARM_LATENCY_CALLS more are the
               timed window, and update_count must equal the backward
               RPCs; a span breakdown and the card's busy share under
               ``torch.profiler``; one step over the bf16 wire within
               bf16's tolerance of the f32 wire's.  Prints the forward
               and backward latency (p50, p95), rows/s, the Runtime's
               queue/stack/device/materialize time per job and the
               params' device.  No kernel of the kernels line is on this
               path (0 launches).
12. timings -- CUDA-event medians of each kernel, its plain version and
               the PyTorch call computing the same function (SDPA for the
               attention forward; for K1-K3, the attention backward and
               K4, which no single call computes, a yardstick: the cuBLAS
               products of each CE kernel unfused -- ``x @ head`` for K1,
               then ``@ head^T`` for K2 or ``x^T @`` for K3 --, SDPA's
               backward of dq, dk and dv together, and ``index_select``
               of the same rows),
               each with its share of its bound (bound / time), K5 at
               the serving prefill's, flagship-8k-train's and perfbench's
               seq-256 cell's shapes; and the
               router-jitter noise of one layer drawn without its cache.
13. swarm LM -- ``swarm-dmoe-2l-256e-d512`` ([BJ] config 3 at the
               config-3 width: d 512, 8 heads, seq 256, byte vocabulary,
               grid (16, 16), top-2, every timeout and quorum setting at
               the config's defaults; its 4 layers cut to 2) through the DHT: a
               bootstrap DHT node here, one expert server process a layer
               started through ``python -m learning_at_home_tpu_torch.server``
               on the card (256 ``ffn`` experts at hidden 512 each, adam
               3e-4, max batch 4096), and the trainer here on the card with
               its own DHT node as the expert source.  All 512 experts
               must be alive in the DHT before a deadline, and each MoE
               layer holds the set it then resolves (``hold_alive_sets``:
               the servers neither join nor leave); then warm-up
               steps until the step time settles (SWARM_LM_SETTLE) and
               SWARM_LM_TIMED timed steps of ``make_train_step``
               (adamw 3e-4, 8 x 256 tokens of the synthetic corpus a
               step), SWARM_LM_OVERLAP_STEPS steps of
               ``make_overlapped_train_step`` in each schedule, and
               SWARM_LM_PIPELINED_STEPS of ``PipelinedSwarmTrainer`` with
               two workers.  The loss must fall; backward RPCs acked <= the
               servers' summed update_count <= sent (their stats RPC); a
               server process that exits fails the phase with its output.
               After the steps, ``python -m learning_at_home_tpu_torch.
               tools.lah_top --once --json`` joined through the
               bootstrap node must show one row per server process (its
               RPC endpoint) with a non-zero expert update count on each.
               Prints, beside the card's name and power limit, the step
               time and tokens/s, layer 0's dispatch p50, the replies each
               layer's quorum dropped, the trainer's and each server's
               peak card memory and the trainer's busy share over
               SWARM_LM_PROFILE_STEPS profiled steps.  Then card against
               CPU: twin swarms of 2 layers, grid (4,), d 64 (server
               processes and trainer on the card; the same on the CPU;
               crc32-seeded experts) give step 1's loss and every trunk
               and gate gradient within 2e-4 + 2e-4 |ref|, and a paged KV
               decoder on each (page_len 5) the same greedy tokens, the
               logits behind each first token within the same bar.  No
               kernel of the kernels line is on this path (0 launches).

14. elastic -- ``swarm-elastic-d512``: config 3's width (d 512, 8 heads,
               seq 256, byte vocabulary, grid (16, 16), top-2, 256 ``ffn``
               experts at hidden 512, adam 3e-4) cut to ONE MoE layer, all
               on the card: a bootstrap DHT node; server A through the
               CLI hosting layer 0's 256 experts (asyncio transport, a
               checkpoint dir); servers B (``--transport native``) and C
               booted empty (replica hosts); two trainers here, each with
               its own DHT node.  Asserts, in order: (1) averaging -- the
               trainers (``PipelinedSwarmTrainer.attach_averaging``) take
               ELASTIC_AVG_STEPS steps at once, each session's
               ``notify_step`` starts a background round, and after it
               each trainer's params on the card are the mean of the two
               snapshots within ELASTIC_AVG_ULPS ulp (the delta's
               roundings); ``averaging_stats`` shows a group of 2; (2)
               replicas -- the 8 experts A updated most go to B and C by
               the ``replica`` RPC with sync (A, their hoster, syncs
               none), the DHT shows all three hosters, one backward moves
               B's copy of each off C's, and the next ``ReplicaSync``
               round leaves B's and C's copies the same bits (the servers'
               parameter crcs), off the init, while each keeps its own
               optimizer state (update counts 1 and 0; A's unchanged);
               (3) migration -- one uid moves A -> B by the ``migrate``
               RPC, B verifies its installed state against A's manifest;
               (4) drain -- a ``drain`` RPC to A (successor B, grace 1 s)
               while a trainer keeps stepping: A reaches DRAINED, every
               expert handed off and verified (none checkpointed), B's
               update counts continue A's, every step completes (the
               replies the quorum dropped are printed); (5) card against
               CPU -- a fresh expert of each uid set drawn on the card
               gives the manifest crcs of the one drawn on the CPU (the
               init repair's 2-ulp bar, met bit for bit).  Prints the
               averaging round's time and bytes, the replica sync round
               time, the handoff's MB/s and ms per expert, the drain's
               wall time, step times before, during and after the drain,
               B's pump frames, each server's peak card memory and one
               expert's init time at hidden 512.  No kernel of the
               kernels line is on this path (0 launches).

15. gateway  -- ``gateway swarm-dmoe-2l-256e-d512``: config 3 served from
               phase 13's two server processes and its trained params,
               before they stop, through a port ``Gateway`` on the card (8
               slots, the paged KV layout at page_len 16, the prefix
               cache, coalescing, prefill in chunks of 16 tokens; the
               wire pinned to f32, every expert reply awaited, each
               layer holding the alive set it resolves first).  16
               streams, twice the slots, submitted at once through a
               ``GatewayClient``: prompts of 32-128 bytes of the synthetic
               corpus, every other one sharing a 64-byte prefix, 32 new
               tokens each, 12 greedy and 4 sampled (temperature 0.8,
               top-p 0.9, top-k 40, a seed each).  Asserts: one row
               through a card server alone and in batches of 2-16 and
               259 rows has the same output bits; every
               stream's tokens equal a bare dense decoder's with
               ungrouped dispatches (paged against dense, coalesced
               against solo); a second gateway with spec_k 4 (the n-gram
               drafter) and unchunked prefill gives the same tokens for
               every stream; two greedy streams' first 4 tokens equal the
               re-forward argmax chain through ``model.apply``; the
               scheduler's and the pool's audits are empty; dispatches
               were coalesced and the prefix cache hit.  Prints, beside
               the card's name and
               power limit, TTFT and inter-token p50/p95, tokens/s, the
               experts called a decode step, group dispatches and the
               dispatches coalescing avoided, prefix-hit tokens, peak
               pages, speculative acceptance, the peak card memory and
               the card's busy share over the second gateway's decode
               loop (under ``torch.profiler``).  No kernel of the kernels
               line is on this path (0 launches).

16. experiment drivers -- the twins of the JAX package's experiment
               scripts through their own CLIs on the card (``main(argv)``
               in this process where the launch counters are read, a
               process of its own where the twin spawns processes):
               (a) ``train_lm --mode pod`` at [BJ] config 3's widths (d
               512, 4 layers, 256 experts, byte vocabulary) at seq 8192,
               batch 4, bf16 params, optax's Adafactor chain, 4 steps:
               finite losses and the flash forward, dkv and dq kernels 4
               times each a step (no remat); prints tokens/s, the step
               time, peak memory, and the chain's update time beside the
               fused Adafactor's on the last step's gradients; (b)
               ``generate_lm --no-checkpoint`` at the same widths, seq
               8192, a 4096-byte prompt of the synthetic corpus,
               ``--bench 64`` (and once with 1 new token): 4 flash
               launches a generate (phase 5's); prints prefill ms and
               decode ms/token; (c) ``train_lm --mode swarm
               --subprocess-servers`` at config 3 cut to 2 layers (256
               experts a layer on 2 server processes, seq 256, batch 8, 4
               steps, ``OMP_NUM_THREADS`` = cores / 4): 512/512 experts
               discovered, finite losses, backward RPCs acked <= the
               servers' updates <= sent, no server left after the run; (d)
               the loadgen twin's ``run_load`` against a gateway on phase
               13's servers (phase 15's configuration) at Poisson 2
               requests/s for 15 s: ``check_floors`` empty; prints TTFT and
               ITL p50/p99; (e) ``churn_experiment --profile fast`` on card
               servers: exit 0 under its SLO gate; prints the throughput
               ratio, p99, kills and relaunches; (f) ``benchmark_throughput
               --num-experts 16 --hidden-dim 1024 --clients 16 --requests
               50 --backward``: samples/s, latency p50/p99; (g)
               ``mnist_expert --hidden-dim 1024 --steps 100``: the loss
               falls; steps/s and updates applied.

17. mesh     -- the pod tier on meshes of ranks (``parallel/``), the
               flagship at full width ((a) at full depth, (b) and (c)
               with its 4 layers cut to 2, MESH_PAIR): (a) one NCCL rank, mesh
               {"data": 1, "expert": 1}: its loss and every gradient leaf
               bit for bit the single-device model's (``mesh=None``) on
               the same weights and batch, then MESH_STEPS steps of
               ``flagship-8k-train`` with phase 7's launches a step; (b)
               two gloo ranks sharing the card (``parallel/launch.RankGroup``,
               card tensors staged through pinned host buffers), mesh
               {"expert": 2}: each rank draws the global tree once and
               its slices through the mesh model's init_params (bit for
               bit the global tree's); at seq MESH_CHECK_SEQ with capacity
               factor E/k (no drops) the loss and gradient slices against
               one device in f32 (MESH_LOSS_RTOL, MESH_GRAD_RTOL), then in
               the recipe's bf16 with the routing choices that differ
               counted and replayed (phase 7's limits); then MESH_STEPS
               steps of ``flagship-8k-train`` (2 rows a rank): finite
               falling losses and phase 7's launches a layer on each
               rank (the pair's processes start while (a) runs); (c) the
               same ranks, before (b)'s steps, on {"expert": 1, "seq": 2}:
               the zigzag ring at seq 8192 in f32 against plain attention
               on one device that routes its tokens in the zigzag order
               (the same tokens drop), within MESH_SEQ_LOSS_RTOL and
               MESH_GRAD_RTOL.  Each rank resets and reads its own launch
               counters; the kernels line sums (a)'s and (b)'s.  Phase 3
               holds the kernels at (b)'s shapes (MESH_ATTN, MESH_CE,
               MESH_CHECK_CE).

18. checkpoints -- sharded train state on a mesh, through the CLIs a
               user types: (a) ``train_lm --mode pod`` at phase 16 (a)'s
               widths (config 3: d 512, 256 experts, seq 8192, its 4
               layers cut to 2 (CKPT_LAYERS),
               bf16 params, optax's Adafactor chain, batch 4) on two gloo
               ranks sharing the card, mesh {"data": 1, "expert": 2}, 2
               rows a rank, 4 steps with ``--checkpoint-every 2`` (each
               rank writes its slices, rank 0 the marker after a
               barrier); a second job in fresh processes ``--resume``s
               from a root holding only step 2 and runs steps 3-4: its
               losses must be the first job's bit for bit, and each rank
               must launch the flash forward, dkv and dq kernels 2 times a
               step (K1-K3 0: train_lm takes the chunked CE, as the JAX
               script does); prints the bytes a save writes, save and
               restore seconds and MB/s, step times, peak memory; (b) step
               2 restored onto one device (no mesh), every leaf cut to
               each rank's slice equal to what that rank saved (digests of
               the bytes), then ``generate_lm --checkpoint-dir`` decodes 16
               greedy tokens for 2 prompts of 4096 bytes from that step
               onto the single-device model: 2 flash launches (the
               prefill); (c) ``decode_gap_eval`` at its own widths on
               {"expert": 2} (two gloo ranks on the card), --steps cut to
               CKPT_GAP_STEPS: both ranks the same report, the JAX
               script's keys, finite CEs; (d) on the host, beside (c)
               and (b):
               ``dht_swarm_sim --sizes 128 --experts 64 --churn-rounds 2
               --lookups 150 --check`` passes its floors, and ``sim.runner
               --nodes 200 ... --check`` prints the JAX runner's report
               byte for byte (its sha256) with its verdict.

19. operator tools -- the tools of ``learning_at_home_tpu_torch/tools``
               and ``experiments/build_corpus``, each a process started
               with the others: (a) ``lah_lint --json`` over the port: 0
               unsuppressed findings; ``schema.extract`` over the port (in
               this process): WIRE_HANDLERS handler (family, module, op)
               entries, none unresolved; (b) ``lah_verify --smoke
               --seeded-bugs --json``: no violation, both seeded races
               found, deterministically; (c) a worker with the port's
               sanitizer armed runs ``lah_fuzz --smoke`` (the expert and
               gateway hosts on the card; the averaging and DHT hosts on
               the host), then ``--smoke --device cpu`` of the expert and
               gateway families: each family >= 220 frames, no crash,
               hang, sanitizer violation or leaked thread, the card
               server's device printed, and every frame's outcome class
               (error reply, result, close) on the card the CPU host's;
               (d) ``lah_rebalance --plan`` on PLACEMENT_FIXTURE in two
               processes: the same bytes, moves, a lower cost; (e)
               ``build_corpus`` twice: the same sha256, non-zero bytes
               (the whole script starts both runs with phase 18, on the
               host beside it: they are the phase's longest tool).
               Prints each tool's seconds and the fuzz frames a second.
               No kernel of the kernels line is on this path (0
               launches, this process's and the fuzz worker's).

20. pre-test gate -- the port's ``tools/collect_gate.py`` on the card, in
               a worker process with the port's sanitizer armed
               (``LAH_SANITIZE=1``): (a) its orphan guard, a leak check
               on phases 11-19 (no port server process may outlive
               them); (b) its collection stage: where the JAX package
               cannot import (jax, flax or optax missing), the
               torch-only port test files under ``--noconftest``; (c)
               GATE_SMOKES, the gate's smokes whose servers, decoder or
               model sit on the card, on GATE_DEVICE: client path (both
               wire protocols), averaging (trees on the card), codec
               (``u8`` and ``blockq8`` must cut the wire /4.00 and /3.87,
               gradient cosine >= 0.99), telemetry (``lah_top`` through
               the DHT), replication (the hedge after a primary kill),
               overlap (card server processes; the trainer on the host
               CPU, where its attention is the work the window hides),
               lifecycle (a drain, bitwise), gateway (card server
               processes and decoder, coalescing and prefix hits) and the
               SLO trace; each marker asserted and the servers' device
               printed (in-process: their experts'; server processes:
               their ``stats`` RPC's card peak bytes, present only for
               card experts).  Not rerun here: the gate's stages 0-0.8
               are phase 19's (a)-(d) with the same tools and arguments;
               its DHT sim, macro-sim and SLO churn smokes are phases 18
               (d) and 16 (e) with the same tools.  Prints each step's
               seconds and lines (the codec ratios, the overlap A/B, the
               gateway's fired and per-stream dispatches and prefix
               hits).  No kernel of the kernels line is on this path (0
               launches, this process's and the gate worker's).

21. profiling tools -- the step profiler and the roofline, in this
               process: (a) ``experiments/profile_step`` with the bench
               recipe (PROFILE_A: batch 176, the per-layer tuple, the
               fused Adafactor, ``--trace``; bf16 params on the card, the
               chunked CE, K5 at seq 256) prints its JSON
               line with ``mfu`` and ``hbm_peak_gb``; its trace (3 steps
               under ``utils/profiling.device_trace``) must parse and
               hold CUDA kernel events; its refusal estimate is printed
               beside the measured peak (a finding, not a check); (b)
               the same with ``--remat-policy dots`` (PROFILE_B); (c)
               PROFILE_REFUSED, whose estimate exceeds 0.75 of the
               card's memory, must exit 2 with the card's allocated
               bytes unchanged; (d) ``tools/roofline`` on the card's
               constants with (a)'s ``step_ms`` as its anchor prints its
               lines.  Of the kernels line only K5 is on this path: each
               step of (a) and (b) launches its forward 8 times (4 layers
               and their remat recompute), dkv and dq 4 times each.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card or
without the repository's package beside it.

``python3 chip_smoke.py --kernels-only [flash|ce]`` runs phases 1-3 and
phase 12's timings of K5 and K1-K3 (or of one family; no model path, no
kernels line): a kernel change's quick check and its times.
``python3 chip_smoke.py --swarm-lm-only`` runs phases 1, 13 and 15 (no
kernel is built, no kernels line); ``--elastic-only`` runs phases 1 and 14;
``--gateway-only`` runs phase 1, phase 13's servers (no training) and
phase 15 on key-seeded params, then the twins' check;
``--experiments-only`` runs phases 1, 2 and 16 ((d) on phase 13's servers
and key-seeded params; no kernels line); ``--mesh-only`` runs phases 1, 2
and 17 (no kernels line); ``--ckpt-only`` runs phases 1, 2 and 18 (no
kernels line); ``--tools-only`` runs phases 1 and 19 (no kernel is built,
no kernels line); ``--gate-only`` runs phases 1 and 20 (no kernel is
built, no kernels line); ``--profile-only`` runs phases 1 and 21 (K5
is built at first use; no kernels line).
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import gc
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from learning_at_home_tpu_torch import optim
from learning_at_home_tpu_torch import random as prng
from learning_at_home_tpu_torch.averaging import (
    AveragingConfig,
    AveragingSession,
    DecentralizedAverager,
)
from learning_at_home_tpu_torch.client.moe import RemoteMixtureOfExperts
from learning_at_home_tpu_torch.client.routing import StaticExpertSource
from learning_at_home_tpu_torch.client import PipelinedSwarmTrainer
from learning_at_home_tpu_torch.client.expert import RemoteExpert
from learning_at_home_tpu_torch.client.rpc import (
    client_loop,
    pool_registry,
    reset_client_rpc,
)
from learning_at_home_tpu_torch.dht import DHT
from learning_at_home_tpu_torch.convert import (
    numpy_to_tensor,
    tensor_to_numpy,
)
from learning_at_home_tpu_torch.experiments import (
    benchmark_throughput,
    decode_gap_eval,
    generate_lm,
    loadgen,
    mnist_expert,
    profile_step,
    train_lm,
)
from learning_at_home_tpu_torch.gateway import Gateway, GatewayClient
from learning_at_home_tpu_torch.models.data import (
    VOCAB_SIZE,
    LMBatcher,
    load_corpus,
)
from learning_at_home_tpu_torch.models import swarm_decoder
from learning_at_home_tpu_torch.models.sampling import SamplingParams
from learning_at_home_tpu_torch.models.swarm_decoder import SwarmKVDecoder
from learning_at_home_tpu_torch.models.transformer import (
    DMoETransformerConfig,
    DMoETransformerLM,
)
from learning_at_home_tpu_torch.models.transformer_swarm import (
    SwarmDMoETransformerLM,
    SwarmTransformerConfig,
)
from learning_at_home_tpu_torch.ops import build
from learning_at_home_tpu_torch.ops import flash_attention as fa
from learning_at_home_tpu_torch.ops import fused_ce as fce
from learning_at_home_tpu_torch.ops import moe_dispatch
from learning_at_home_tpu_torch.ops import token_dispatch as td
from learning_at_home_tpu_torch.ops.fused_adafactor import fused_adafactor
from learning_at_home_tpu_torch.parallel import sharded_moe
from learning_at_home_tpu_torch.parallel.launch import RankGroup
from learning_at_home_tpu_torch.parallel.mesh import (
    local_shard,
    make_mesh,
    mesh_layout,
    opt_state_shardings,
)
from learning_at_home_tpu_torch.models.layers import make_expert
from learning_at_home_tpu_torch.server import lifecycle
from learning_at_home_tpu_torch.server.expert_backend import (
    ROW_TILE,
    ExpertBackend,
)
from learning_at_home_tpu_torch.server.server import Server, uid_key
from learning_at_home_tpu_torch.utils import telemetry
from learning_at_home_tpu_torch.utils import checkpoint as ckpt_io
from learning_at_home_tpu_torch.utils import sizing
from learning_at_home_tpu_torch.utils.nested import nested_flatten, nested_map
from learning_at_home_tpu_torch.utils.profiling import timeline
from learning_at_home_tpu_torch.utils.subproc import find_orphan_servers
from learning_at_home_tpu_torch.tools import collect_gate, roofline
from learning_at_home_tpu_torch.tree import tree_leaves, tree_map

SEED = 0
# the 256-expert flagship of __graft_entry__.py at the sequence length
# where the attention rule picks the flash kernel
FLAGSHIP_8K = dict(
    vocab_size=32768, d_model=512, n_layers=4, n_heads=8, seq_len=8192,
    num_experts=256, k=2, capacity_factor=1.25, dtype=torch.bfloat16,
    param_dtype=torch.float32, attn_impl="auto",
)
# the same flagship with the single-chip training recipe of bench.py
# (bf16 params, remat "full", the unrolled per-layer tuple layout, the
# fused CE), trained with fused_adafactor(1e-3) at batch 176: 45,056
# tokens a step
FLAGSHIP_TRAIN = dict(
    vocab_size=32768, d_model=512, n_layers=4, n_heads=8, seq_len=256,
    num_experts=256, k=2, capacity_factor=1.25, dtype=torch.bfloat16,
    param_dtype=torch.bfloat16, attn_impl="auto", remat=True,
    remat_policy="full", scan_layers=False, stack_layers=False,
    ce_impl="fused",
)
TRAIN_BATCH = 176
# flagship-train at the long context (8192 = the flagship-8k serving
# length): batch 4, 32,768 tokens a step, is this configuration's choice
# (the repo publishes no long-context batch); expert capacity 320
FLAGSHIP_8K_TRAIN = dict(FLAGSHIP_TRAIN, seq_len=8192)
TRAIN_8K_BATCH = 4
# the flagship's balanced-routing recipe of bench.py (_balanced_variant):
# router jitter 0.1 and aux-loss weight 5e-2, BALANCE_STEPS untimed steps
# before the timed ones
FLAGSHIP_TRAIN_BALANCED = dict(FLAGSHIP_TRAIN, router_jitter=0.1,
                               aux_loss_weight=5e-2)
BALANCE_STEPS = 30
TRAINING = {
    "flagship-train": (FLAGSHIP_TRAIN, TRAIN_BATCH),
    "flagship-8k-train": (FLAGSHIP_8K_TRAIN, TRAIN_8K_BATCH),
    "flagship-train-balanced": (FLAGSHIP_TRAIN_BALANCED, TRAIN_BATCH),
    # the two short runs: expert-choice gating, and remat "dots"
    "flagship-train-expert-choice": (
        dict(FLAGSHIP_TRAIN, gating="expert_choice"), TRAIN_BATCH),
    "flagship-train-dots": (dict(FLAGSHIP_TRAIN, remat_policy="dots"),
                            TRAIN_BATCH),
}
TRAIN_STEPS = 5
SHORT_STEPS = 3  # the expert-choice and "dots" runs
# [BJ] config 2 at its published width: 4 ffn experts at hidden 1024 (the
# width of Server.create's default and of [BJ] config 1) behind one
# server, optax.adam(1e-3)'s port, max batch 1024; the client's grid (4,),
# top-2, k_min 1, batches of 256 rows
SWARM = dict(num_experts=4, expert_cls="ffn", hidden_dim=1024,
             expert_prefix="swarm", max_batch_size=1024)
SWARM_LR = 1e-3
SWARM_ROWS = 256
SWARM_CHECK_STEPS = 3
SWARM_TRAIN_STEPS = 25
SWARM_LATENCY_CALLS = 50
SWARM_SPAN_STEPS, SWARM_PROFILE_STEPS = 10, 5  # the breakdown's steps
SWARM_CHECK_GRACE_S = 120.0  # the card-against-CPU clients wait for all
# card against the CPU copy, f32 with TF32 off: the CPU tests' bar at
# hidden 16 (2e-5) scaled by sqrt(1024 / 16) = 8 for dot products 64x
# longer, rounded up: |err| <= 2e-4 + 2e-4 |ref|.  After each check step
# (both sides from one state): adam's moments within 1e-5 of each leaf's
# largest value plus 1e-4 |ref| (the CPU tests' bar for the same state,
# tests/test_torch_expert_backend.py); params within 1e-6 + 1e-5 |ref|
# plus how far adam's step can carry a gradient difference
# (check_swarm_step).  bf16 wire: 2^-9 relative rounding on each
# crossing, held at 2^-6 of each tensor's largest magnitude.
SWARM_TOL = 2e-4
SWARM_PARAM_ATOL, SWARM_PARAM_RTOL = 1e-6, 1e-5
SWARM_MOMENT_ATOL, SWARM_MOMENT_RTOL = 1e-5, 1e-4
SWARM_BF16_ATOL_SCALE = 2.0 ** -6
# [BJ] config 3, the swarm DMoE-Transformer, at the repo's config-3 width
# (__graft_entry__.py: d 512, 8 heads of 64, seq 256, top-2) with its 4
# layers cut to 2 (the script's time limit): the byte vocabulary, the
# (16, 16) grid of the config's default (256 ffn experts a layer, 512 in
# all, hidden 512), every timeout and quorum setting at the config's
# defaults; one server process a layer through the port's CLI (adam 3e-4,
# max batch 4096), the trainer in this process with adamw(3e-4) on 8 x
# 256 tokens of the synthetic corpus a step
SWARM_LM = dict(vocab_size=VOCAB_SIZE, d_model=512, n_layers=2, n_heads=8,
                seq_len=256, grid_size=(16, 16), k_best=2)
SWARM_LM_NAME = f"swarm-dmoe-{SWARM_LM['n_layers']}l-256e-d512"
SWARM_LM_BATCH = 8
SWARM_LM_LR = 3e-4
SWARM_LM_SERVER = ["--optimizer", "adam", "--lr", str(SWARM_LM_LR),
                   "--max-batch-size", "4096", "--warmup"]
SWARM_LM_TIMED, SWARM_LM_OVERLAP_STEPS = 3, 2
# warm-up steps until the last 3 steps' times, and the experts they
# called, each lie within 10 % of each other (at most 10 steps)
SWARM_LM_SETTLE_STEPS, SWARM_LM_SETTLE, SWARM_LM_WARMUP_MAX = 3, 0.1, 10
SWARM_LM_PIPELINED_STEPS, SWARM_LM_PROFILE_STEPS = 4, 2
SWARM_LM_DISCOVERY_S = 300.0  # the deadline for all the layers' experts
ALIVE_HOLD_S = 3600.0  # how long phases 13 and 15 keep a layer's alive set
# card against the CPU at a small size: two twin swarms (server processes
# and trainer on the card; the same on the CPU) of 2 layers, grid (4,),
# d 64, f32 with TF32 off, the same crc32-seeded experts and trainer
# params; every reply awaited and the wire pinned to f32, so step 1's loss
# and gradients differ by summation order only: phase 11's bar
SWARM_LM_TWIN = dict(vocab_size=VOCAB_SIZE, d_model=64, n_layers=2,
                     n_heads=4, seq_len=32, grid_size=(4,), k_best=2,
                     uid_prefix="twin", wire_codec="none",
                     timeout_after_k_min=SWARM_CHECK_GRACE_S)
SWARM_LM_TWIN_BATCH = 4
# phase 14 (swarm-elastic-d512): config 3's width cut to one MoE layer
# (server A's 256 experts, ~6.5 GB of params and adam moments to hand
# off).  Heartbeats every 1 s (records live 2 s, longer than the DHT
# client's 1 s cache of a lookup: 0.5 s records came back from that
# cache already expired and emptied the alive set) and the trainers'
# alive set cached 1 s: the drain's 1 s grace is shorter than what
# clients know, so a trainer may send an expert A handed off in the
# drain's first seconds to A, and the quorum absorbs those replies
# (printed)
ELASTIC = dict(SWARM_LM, n_layers=1)
ELASTIC_SERVER = ["--optimizer", "adam", "--lr", str(SWARM_LM_LR),
                  "--max-batch-size", "4096", "--update-period", "1"]
ELASTIC_ALIVE_TTL = 1.0
ELASTIC_AVG_STEPS = 2  # each trainer's steps before the averaging round
ELASTIC_MATCH_S = 60.0  # an averaging round's matchmaking budget
# the averaged params against the snapshots' mean: the delta's two f32
# roundings (avg - snap, then + cur), each within 1 ulp of the larger
ELASTIC_AVG_ULPS = 4
ELASTIC_REPLICAS = 8
ELASTIC_PUSH_ROWS = 16  # rows of the backward that moves B's replica
ELASTIC_GRACE_S = 1.0
ELASTIC_STEPS_AROUND = 3  # timed steps before and after the drain
ELASTIC_DRAIN_S = 600.0  # the deadline for A to reach DRAINED
ELASTIC_SYNC_S = 120.0  # the deadline for a replica sync round per uid
# phase 15 (gateway swarm-dmoe-2l-256e-d512): config 3 served through a
# port Gateway on the card (8 slots, the paged KV layout at page_len 16,
# the prefix cache, coalescing, chunked prefill of 16 tokens a pass) from
# phase 13's servers; the serving model pins the wire to f32, the gate
# blind to routing cost and every expert reply awaited, so the token
# contracts hold bitwise (the JAX gateway tests pin the same)
GATEWAY = dict(SWARM_LM, wire_codec="none", routing_cost_weight=0,
               timeout_after_k_min=SWARM_CHECK_GRACE_S)
GATEWAY_SLOTS, GATEWAY_PAGE_LEN, GATEWAY_CHUNK = 8, 16, 16
GATEWAY_STREAMS, GATEWAY_NEW = 16, 32  # twice the slots: admission queues
GATEWAY_PROMPT = (32, 128)  # bytes of the synthetic corpus
GATEWAY_PREFIX = 64  # the bytes every other prompt shares
GATEWAY_SAMPLED = (1, 4, 9, 14)  # the sampled streams (the rest greedy)
GATEWAY_SAMPLING = dict(temperature=0.8, top_p=0.9, top_k=40)
GATEWAY_SPEC_K = 4
# streams held against the re-forward argmax chain, and their tokens
# held (each token a full forward of every stream's sequence: ~0.8 s)
GATEWAY_REFORWARD, GATEWAY_REFORWARD_TOKENS = 2, 4
GATEWAY_DEADLINE_S = 300.0  # for every stream of one arm to finish
GATEWAY_POLL_S = 0.1  # the client's pause between rounds of polls
# phase 16 (the experiment drivers through their CLIs): (a) [BJ] config
# 3's widths in pod mode at seq 8192 with the byte vocabulary and optax's
# Adafactor chain; (b) generation at the same widths from a 4096-byte
# prompt; (c) config 3 cut to 2 layers through the swarm trainer and 2
# server processes;
# (d) open-loop load on phase 15's gateway; (e) [BJ] config 4's churn;
# (f) the server benchmark; (g) [BJ] config 1
EXP_POD = ["--mode", "pod", "--d-model", "512", "--n-layers", "4",
           "--num-experts", "256", "--seq-len", "8192", "--batch-size", "4",
           "--param-dtype", "bf16", "--optimizer", "adafactor",
           "--steps", "4", "--log-every", "1"]
EXP_POD_STEPS = 4
EXP_GEN = ["--no-checkpoint", "--seq-len", "8192", "--d-model", "512",
           "--n-layers", "4", "--num-experts", "256"]
EXP_GEN_PROMPT, EXP_GEN_BENCH = 4096, 64
EXP_SWARM_LAYERS, EXP_SWARM_STEPS = 2, 4
EXP_SWARM = ["--mode", "swarm", "--subprocess-servers", "--d-model", "512",
             "--n-layers", str(EXP_SWARM_LAYERS), "--experts-per-layer",
             "256", "--n-servers", str(EXP_SWARM_LAYERS), "--seq-len", "256",
             "--batch-size", "8", "--steps", str(EXP_SWARM_STEPS),
             "--log-every", "1"]
EXP_SWARM_S = 420.0  # the swarm trainer's run, discovery included
EXP_LOAD = dict(rate_hz=2.0, duration_s=15.0)  # the CLI's other defaults
EXP_CHURN = ["--profile", "fast"]
EXP_CHURN_S = 400.0
EXP_THROUGHPUT = ["--num-experts", "16", "--hidden-dim", "1024",
                  "--clients", "16", "--requests", "50", "--backward"]
EXP_MNIST = ["--hidden-dim", "1024", "--steps", "100"]
EXP_OPT_REPS = 3  # timed optimizer updates after the pod run, each kind
# the main paths' kernel shapes: [B,S,H,hd] of one flagship-8k prefill
# layer and of one flagship-8k-train layer; [n, d, V] of each training
# configuration's CE
SERVE_ATTN = (2, 4096, 8, 64)
TRAIN_ATTN = (TRAIN_8K_BATCH, FLAGSHIP_8K_TRAIN["seq_len"],
              FLAGSHIP_8K_TRAIN["n_heads"],
              FLAGSHIP_8K_TRAIN["d_model"] // FLAGSHIP_8K_TRAIN["n_heads"])
# one layer's of perfbench's seq-256 training cell
# (dmoe256-s256.train-b2832): flagship-train's widths at batch 2832
CELL_256_ATTN = (2832, FLAGSHIP_TRAIN["seq_len"], *TRAIN_ATTN[2:])
CE_TRAIN, CE_8K_TRAIN = ((batch * cfg["seq_len"], cfg["d_model"],
                          cfg["vocab_size"]) for cfg, batch in
                         list(TRAINING.values())[:2])
# phase 17 (b)'s shapes on each of its two ranks (half flagship-8k-train's
# rows), and the CE's of its bf16 check at seq MESH_CHECK_SEQ: a rank's
# row, the single device's two
MESH_CHECK_SEQ = FLAGSHIP_TRAIN["seq_len"]
MESH_ATTN = (TRAIN_8K_BATCH // 2, *TRAIN_ATTN[1:])
MESH_CE = (CE_8K_TRAIN[0] // 2, *CE_8K_TRAIN[1:])
MESH_CHECK_CE = [(rows * MESH_CHECK_SEQ, *CE_TRAIN[1:]) for rows in (1, 2)]
# [n, d, E, C] of the MoE token dispatch on each path (C at capacity
# factor 1.25, top-2): flagship-train (and its balanced run), the
# flagship-8k prefill, flagship-8k-train
DISPATCH_TRAIN = (45056, 512, 256, 440)
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = sizing.CARD_PEAK_BF16[sizing.H100]
PEAK_BYTES = sizing.CARD_HBM_BPS[sizing.H100]
# the library Pallas kernel whose backward the dkv and dq kernels replace
LIBRARY_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"
# the kernels line: each kernel's source in csrc/, the TPU kernel it
# replaces, and the shape whose numbers head its row (the path it stands
# for); the numbers of every other shape it was checked or timed at follow
KERNELS = {
    "flash_attn_fwd": ("flash_attn_fwd.cu",
                       "learning_at_home_tpu/models/trunk.py:73", SERVE_ATTN),
    "flash_attn_bwd_dkv": ("flash_attn_bwd.cu", LIBRARY_FLASH + ":941",
                           TRAIN_ATTN),
    "flash_attn_bwd_dq": ("flash_attn_bwd.cu", LIBRARY_FLASH + ":1287",
                          TRAIN_ATTN),
    **{name: (source, f"learning_at_home_tpu/ops/fused_ce.py:{line}",
              CE_TRAIN)
       for name, source, line in (("fused_ce_fwd", "fused_ce_fwd.cu", 58),
                                  ("fused_ce_dx", "fused_ce.cu", 96),
                                  ("fused_ce_dhead", "fused_ce.cu", 124))},
    "token_dispatch": ("token_dispatch.cu",
                       "learning_at_home_tpu/ops/pallas_dispatch.py:44",
                       DISPATCH_TRAIN),
}
CONTRACT_KEYS = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms"}
# bf16 kernel against the plain version computed in f32 from the same bf16
# inputs: the kernel rounds P and O to bf16 (2^-8 relative each), so
# |err| <= ATOL + RTOL * |ref| with ATOL = 4 * 2^-8 for |v| up to ~4
FLASH_ATOL, FLASH_RTOL = 1.6e-2, 8e-3
# flagship prefill logits, flash against plain attention, both bf16:
# logits have std ~1 and the two paths round attention differently in
# the last bf16 bit, which the residual stream carries through 4 layers
LOGITS_MAX_ABS, LOGITS_MEAN_ABS = 0.25, 5e-3
# K1-K3 against their plain versions computed in f32 from the same bf16
# inputs.  ce / lse: only the f32 summation order of the logits differs;
# the worst-case f32 bound d * 2^-24 * sum|x_k h_k| is ~4e-4 per logit at
# d = 512 with unit-scale x and N(0, 1/d) heads, so 1e-3.  dx / dhead: the
# kernels round dl to bf16 (2^-9 relative per term, summed over terms
# whose absolute sum is about twice the largest output) and round the
# output to bf16 (2^-9): |err| <= 2^-8 |ref| + 2^-7 max|ref|.
CE_ATOL = 1e-3
GRAD_RTOL, GRAD_ATOL_SCALE = 2.0 ** -8, 2.0 ** -7
# tiny bf16 model, card (kernels) against cpu (plain versions): the two
# devices round the bf16 trunk differently, and a near-tie in the gate can
# route a token elsewhere, so the check is normwise: loss within 1e-2
# relative, every gradient leaf at cosine >= 0.99 with the cpu's
SMALL_LOSS_RTOL, SMALL_GRAD_COSINE = 1e-2, 0.99
# flagship-train, fused against chunked CE on one batch: the kernels round
# dl to bf16 where the chunked CE keeps f32 logits end to end
FUSED_LOSS_ATOL, EMBED_GRAD_COSINE = 1e-3, 0.999
# K5's backward against its plain version computed in f32 from the same
# bf16 q, k, v, do and the kernel's own o and lse: the kernels round p and
# ds to bf16 before the products that consume them (2^-9 relative per
# term, summed over terms whose absolute sum is a few times the largest
# output) and round dq, dk, dv to bf16 (2^-9): the CE's gradient form
# |err| <= 2^-8 |ref| + 2^-7 max|ref| (GRAD_RTOL, GRAD_ATOL_SCALE).  lse:
# f32 summation order of the scores (<= 64 * 2^-24 * sum|q_d k_d| / 8,
# ~2e-5 for unit-scale inputs) and __expf's few-2^-22 relative error,
# against values near log(S): 1e-3 absolute.
LSE_ATOL = 1e-3
# flagship-8k-train (and flagship-train), flash against plain attention
# on one batch of 8192 tokens, both bf16: the two round attention's
# output and gradients differently in the last bf16 bit, which the
# residual stream carries through 4 layers.  The loss is a mean over
# 8192 tokens of CE differences of the size of the logits' (mean 3e-3 in
# phase 5): 1e-3 relative.  The
# attention projections wq, wk, wv and wo, whose gradients flow through
# the flash kernels: cosine >= 0.999 and norms within 1e-2 relative (a
# cosine alone cannot see a gradient off by a constant factor).  The same
# last-bit differences tip near-ties in the gate, so some tokens route to
# other experts on the two paths (counted per layer); the expert and gate
# leaves then differ by those tokens' terms, and with each path routing
# by itself every leaf is held at cosine >= 0.9 only.  With the plain path
# replaying the flash path's routing, every leaf must meet the attention
# projections' limits.
FLASH_LOSS_RTOL, ATTN_GRAD_COSINE, FLASH_GRAD_COSINE = 1e-3, 0.999, 0.9
# the tokens those limits were set on, at every sequence length: at 256
# tokens an expert sees ~2 of them, and one token routed elsewhere moves
# its leaves far more than at 8192 (~64 an expert)
FLASH_CHECK_TOKENS = 8192
ATTN_GRAD_NORM_RTOL = 1e-2
# phase 17 (mesh), the flagship at full width and depth on meshes of ranks:
# (a) one NCCL rank, mesh {"data": 1, "expert": 1}, flagship-8k-train;
# (b) two gloo ranks sharing the card, mesh {"expert": 2}: first checks at
# seq MESH_CHECK_SEQ (flagship-train's), batch 2 (a row a rank) with
# capacity factor E/k (no token drops; the one-hot dispatch's [n, E, C]
# tensors grow with n squared there), then MESH_STEPS steps of
# flagship-8k-train (MESH_ATTN, MESH_CE on each rank); (c) the same ranks
# on {"expert": 1, "seq": 2}, the zigzag ring at seq 8192.
MESH_STEPS = 3
MESH_CALL_S = 420.0
# (b) and (c) on flagship-8k-train's widths with its 4 layers cut to 2
# (the script's time limit); (a) keeps all 4
MESH_PAIR = dict(FLAGSHIP_8K_TRAIN, n_layers=2)
# (b)'s f32 check (bf16 params, the chunked CE): the sides differ by f32
# summation order (~1e-6 relative), so the loss within 1e-4 relative;
# gradients of bf16 params are rounded to bf16 (2^-9), a rank's shares
# once more before their bf16 all-reduce: each leaf's error norm within
# 2^-6 of its norm.  (b)'s bf16 check (the recipe's compute and fused CE):
# the two sides' last-bit differences tip near-ties of the bf16 gate
# logits, and an expert whose handful of tokens changes moves its whole
# gradient, as between flash and plain attention in phase 7; so phase 7's
# limits, with the single device replaying the ranks' routing too: the
# loss within FLASH_LOSS_RTOL, every leaf at cosine >= FLASH_GRAD_COSINE
# with each side's own routing, and with one routing every leaf at cosine
# >= ATTN_GRAD_COSINE with its norm within ATTN_GRAD_NORM_RTOL.
MESH_LOSS_RTOL, MESH_GRAD_RTOL = 1e-4, 2.0 ** -6
# (c)'s check computes in f32 (bf16 params): the zigzag ring and plain
# attention differ by f32 summation order only (~1e-6 relative), so the
# loss within 1e-5 relative; gradients of bf16 params are rounded to bf16
# (2^-9), the seq ranks' shares once more before their bf16 all-reduce:
# each leaf within 2^-6 in norm.  The recipe's capacity factor drops
# tokens (over half at the seed's init), and capacity claims go in token
# order, which the zigzag layout changes: the single-device model routes
# its tokens in the zigzag order (RoutedInOrder), so both sides drop the
# same tokens.
MESH_SEQ_LOSS_RTOL = 1e-5
ATTN_LEAVES = ("wq", "wk", "wv", "wo")
# phase 18 (sharded checkpoints on a mesh): (a) phase 16 (a)'s train_lm pod
# run (config 3's widths at seq 8192, bf16 params, optax's Adafactor
# chain, batch 4; CKPT_LAYERS layers) on two gloo ranks sharing the card, mesh {"data": 1,
# "expert": 2}, 2 rows a rank, a checkpoint every CKPT_EVERY steps; a
# second job resumes from step CKPT_EVERY and must repeat the first's
# losses bit for bit; (b) that step restored onto one device, every leaf
# against the ranks' slices, and generate_lm decoding from it:
# CKPT_GEN_NEW tokens on 2 prompts of EXP_GEN_PROMPT bytes; (c)
# decode_gap_eval at its own widths (d 128, 2 layers, 16 experts, seq
# 128, batch 16) on {"expert": 2}, --steps cut from 150 to CKPT_GAP_STEPS;
# (d) the two macro-sim entry points on the host, beside (c) and (b)
CKPT_EVERY = 2
CKPT_LAYERS = 2  # phase 16 (a)'s 4 layers cut to 2 (the script's time limit)
CKPT_POD = [str(CKPT_LAYERS) if EXP_POD[i - 1] == "--n-layers" else a
            for i, a in enumerate(EXP_POD)] + [
    "--checkpoint-every", str(CKPT_EVERY)]
CKPT_GEN_NEW = 16
CKPT_GEN = ["--seq-len", "8192", "--d-model", "512", "--n-layers",
            str(CKPT_LAYERS),
            "--num-experts", "256", "--batch", "2", "--max-new-tokens",
            str(CKPT_GEN_NEW)]
CKPT_GAP_STEPS = 20
CKPT_GAP_KEYS = {"gating", "steps", "num_experts", "eval_ce_training_routing",
                 "eval_ce_decode_fallback_routing", "decode_gap_nats",
                 "control_topk_eval_ce"}  # experiments/decode_gap_eval.py's
CKPT_CALL_S = 420.0
CKPT_SIM_S = 300.0
CKPT_SIMS = {
    "experiments.dht_swarm_sim": [
        "--sizes", "128", "--experts", "64", "--churn-rounds", "2",
        "--lookups", "150", "--check"],
    "sim.runner": [
        "--nodes", "200", "--servers", "48", "--gateways", "4",
        "--experts", "64", "--trace", "poisson:60:6,burst:420:3",
        "--churn", "4:kill:0.15", "--check"],
}
# the JAX runner's report at that scenario (seed 0), which the port's must
# repeat byte for byte: the sha256 of the first line (without its newline)
# of ``python -m learning_at_home_tpu.sim.runner`` with those flags; and
# its --check verdict: the reference scenario misses its own DHT hit-rate
# floor (0.8286 < 0.95)
MACRO_SIM_SHA256 = (
    "83e7470025855831c79e6dde37732964be4cd663137bd59814eaea06c8e82f5e")
MACRO_SIM_VERDICT = (1, ["MACRO_SIM_FAIL: lookup hit_rate 0.8286 < 0.95"])
# phase 21: profile_step's bench recipe, its "dots" rung and a variant
# past the memory budget (~99 GB by the estimate, against 0.75 of 80 GB)
PROFILE_STEPS = 10
PROFILE_A = ["--batch", "176", "--no-stack", "--optimizer", "fused",
             "--steps", str(PROFILE_STEPS)]
PROFILE_B = PROFILE_A + ["--remat-policy", "dots"]
PROFILE_REFUSED = ["--no-remat", "--batch", "4096"]
PROFILE_TRACE_STEPS = 3  # profile_step's --trace runs this many more


T_START = time.perf_counter()


def phase(name: str) -> None:
    """A phase's header, with the seconds since the script started."""
    print(f"== {name} (+{time.perf_counter() - T_START:.1f} s)", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(fn, reps: int = 25, warmup: int = 5,
              queue_ahead: bool = False) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up.
    ``queue_ahead`` holds the card in a ~1 ms spin before each start
    event, so that ``fn``'s launches are queued before the card reaches
    them and the events time the card's work, not the host's Python
    (for calls of tens of microseconds)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(2_000_000)  # clock cycles
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def randn_bf16(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def record(results: dict, name: str, shape, form: str | None = None,
           **values) -> None:
    """Merge ``values`` into kernel ``name``'s entry at ``shape`` (and
    ``form``, which tells the forward with lse from the one without): the
    kernels line takes every number of an entry from that entry's runs."""
    entry = {"shape": list(shape), **({"form": form} if form else {})}
    results.setdefault(name, {}).setdefault(
        (tuple(shape), form), entry).update(values)


def _fwd_err(name, out, ref32) -> float:
    """max |kernel - plain| of a flash forward output, within the stated
    tolerance."""
    err = (out.float() - ref32).abs()
    bad = int((err > FLASH_ATOL + FLASH_RTOL * ref32.abs()).sum())
    assert torch.isfinite(out).all(), f"{name} output is not finite"
    assert bad == 0, f"{name}: {bad} elements outside tolerance"
    return float(err.max())


def check_flash(shape, gen, results) -> None:
    """K5 fwd without lse (serving's form) against its plain version."""
    q, k, v = (randn_bf16(shape, gen) for _ in range(3))
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref16 = fa.attention_reference(q, k, v).float()
    err16 = float((out.float() - ref16).abs().max())
    del ref16
    max_err = _fwd_err(f"flash_attn_fwd {list(shape)}", out,
                       fa.attention_reference(q.float(), k.float(), v.float()))
    print(f"flash_attn_fwd {list(shape)}: max|kernel - plain_f32| = "
          f"{max_err:.3e}, max|kernel - plain_bf16| = {err16:.3e}")
    record(results, "flash_attn_fwd", shape, max_abs_err=max_err)


def check_flash_bwd(shape, gen, results) -> None:
    """K5 fwd with lse (training's form) and K5 bwd (dkv, dq) on one shape
    against their plain versions computed in f32 from the same bf16 inputs
    (the backward's from the kernel's own o and lse), one batch row at a
    time so that only one row's [H, S, S] scores are live."""
    q, k, v, do = (randn_bf16(shape, gen) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do)
    if shape == TRAIN_ATTN:  # deterministic: a second launch, the same bits
        again = fa.flash_attention_bwd(q, k, v, o, lse, do)
        same = [torch.equal(_bits(a), _bits(b))
                for a, b in zip((dq, dk, dv), again)]
        del again
        print(f"flash_attn_bwd {list(shape)}: dq, dk, dv of two launches "
              f"bit for bit: {same}")
        assert all(same), "the K5 backward is not deterministic"
    torch.cuda.synchronize()
    err_o = err_lse = 0.0
    for i in range(shape[0]):
        want_o, want_lse = fa.attention_fwd_reference(
            *(t[i: i + 1].float() for t in (q, k, v)))
        err_o = max(err_o, _fwd_err(f"flash_attn_fwd {list(shape)}",
                                    o[i: i + 1], want_o))
        err_lse = max(err_lse, float((lse[i: i + 1] - want_lse).abs().max()))
        del want_o, want_lse
    want = fa.attention_bwd_reference(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float())
    errs = {name: _grad_err(f"flash_attn_bwd {name}", got, ref)
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    for name, got in zip(("dq", "dk", "dv"), (dq, dk, dv)):
        assert float(got.float().abs().max()) > 0, f"{name} is all zeros"
    print(f"flash_attn_fwd+bwd {list(shape)}: max|err| o {err_o:.3e}, "
          f"lse {err_lse:.3e}, "
          + ", ".join(f"{n} {e:.3e} (max|{n}| "
                      f"{float(w.abs().max()):.3e})"
                      for (n, e), w in zip(errs.items(), want)))
    assert err_lse <= LSE_ATOL, f"flash_attn_fwd lse disagrees at {shape}"
    record(results, "flash_attn_fwd", shape, "with lse", max_abs_err=err_o,
           lse_max_abs_err=err_lse)
    record(results, "flash_attn_bwd_dkv", shape,
           max_abs_err=max(errs["dk"], errs["dv"]))
    record(results, "flash_attn_bwd_dq", shape, max_abs_err=errs["dq"])


def ce_inputs(n, d, v, gen):
    """bf16 x [n, d] (unit scale, like the final layer norm's output), the
    tied head embed.T [d, v] with N(0, 1/d) entries, int32 targets (a few
    outside [0, V)), and dce = 1/n, the cotangent of the mean CE."""
    x = randn_bf16((n, d), gen)
    head = (torch.randn((v, d), generator=gen, device="cuda")
            * d ** -0.5).to(torch.bfloat16).t()
    tgt = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    tgt[::997] = -1
    dce = torch.full((n,), 1.0 / n, device="cuda")
    return x, head, tgt, dce


def _grad_err(name, got, want) -> float:
    want = want.float()
    err = (got.float() - want).abs()
    limit = GRAD_RTOL * want.abs() + GRAD_ATOL_SCALE * float(want.abs().max())
    bad = int((err > limit).sum())
    assert torch.isfinite(got).all(), f"{name} output is not finite"
    assert bad == 0, f"{name}: {bad} elements outside tolerance"
    return float(err.max())


def check_fused_ce(shape, gen, results) -> None:
    """K1-K3 on one shape against their plain versions."""
    n, d, v = shape
    x, head, tgt, dce = ce_inputs(n, d, v, gen)
    ce, lse = fce.ce_forward(x, head, tgt)
    dx = fce.ce_dx(x, head, tgt, lse, dce)
    dhead = fce.ce_dhead(x, head, tgt, lse, dce)
    if shape == CE_TRAIN:  # deterministic: a second launch, the same bits
        same = [torch.equal(_bits(a), _bits(b)) for a, b in (
            (dx, fce.ce_dx(x, head, tgt, lse, dce)),
            (dhead, fce.ce_dhead(x, head, tgt, lse, dce)))]
        print(f"fused CE {list(shape)}: dx, dhead of two launches bit for "
              f"bit: {same}")
        assert all(same), "K2 or K3 is not deterministic"
    torch.cuda.synchronize()
    want_ce, want_lse = fce.ce_fwd_reference(x, head, tgt)
    assert torch.isfinite(ce).all() and torch.isfinite(lse).all()
    err_fwd = max(float((ce - want_ce).abs().max()),
                  float((lse - want_lse).abs().max()))
    del want_ce, want_lse
    assert err_fwd <= CE_ATOL, f"fused_ce_fwd disagrees at {shape}: {err_fwd}"
    # the backward plain versions start from the kernel's lse, as K2/K3 do
    err_dx = _grad_err("fused_ce_dx", dx,
                       fce.ce_dx_reference(x, head, tgt, lse, dce))
    err_dhead = _grad_err("fused_ce_dhead", dhead,
                          fce.ce_dhead_reference(x, head, tgt, lse, dce))
    print(f"fused CE {list(shape)}: max|err| ce/lse {err_fwd:.3e}, "
          f"dx {err_dx:.3e} (max|dx| {float(dx.float().abs().max()):.3e}), "
          f"dhead {err_dhead:.3e} (max|dhead| "
          f"{float(dhead.float().abs().max()):.3e})")
    for name, err in (("fused_ce_fwd", err_fwd), ("fused_ce_dx", err_dx),
                      ("fused_ce_dhead", err_dhead)):
        record(results, name, shape, max_abs_err=err)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _index_plan(token_for_slot: torch.Tensor) -> moe_dispatch.IndexDispatchPlan:
    """A plan holding only what the dispatch reads."""
    return moe_dispatch.IndexDispatchPlan(token_for_slot, None, None, None,
                                          None)


def dispatch_err(name, out, x, token_for_slot) -> float:
    """max |K4 - plain| on one plan, once K4's output is shown to equal
    its plain version's bit for bit."""
    want = moe_dispatch.dispatch_tokens_indexed(x, _index_plan(token_for_slot))
    assert out.shape == want.shape and out.dtype == want.dtype, name
    assert torch.equal(_bits(out), _bits(want)), f"token_dispatch {name}"
    return float((out.float() - want.float()).abs().max())


def check_dispatch_ragged(gen, results) -> None:
    """K4 on the cases outside the path's shapes: f32 rows of d = 100, one
    token, a plan with every slot empty and one with every slot full."""
    x = torch.randn((300, 100), generator=gen, device="cuda")
    tfs = torch.randint(-1, 300, (8, 40), generator=gen, device="cuda",
                        dtype=torch.int32)
    cases = [("f32 d=100", x, tfs),
             ("n=1", x[:1].to(torch.bfloat16), torch.tensor(
                 [[0, -1, 0], [-1, 0, -1]], dtype=torch.int32, device="cuda")),
             ("all empty", x.to(torch.bfloat16), torch.full_like(tfs, -1)),
             ("all full", x.to(torch.bfloat16), torch.randperm(
                 300, generator=gen, device="cuda").reshape(5, 60)
              .to(torch.int32))]
    for form, xx, t in cases:
        out = td.dispatch_tokens_kernel(xx, _index_plan(t))
        torch.cuda.synchronize()
        record(results, "token_dispatch", (*xx.shape, *t.shape), form,
               max_abs_err=dispatch_err(form, out, xx, t))
        if form == "all empty":
            assert not out.any()
    print(f"token_dispatch ragged cases ({', '.join(c[0] for c in cases)}): "
          "bit for bit")


def small_reference() -> None:
    cfg = DMoETransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                                n_heads=4, seq_len=32, num_experts=4, k=2,
                                dtype=torch.float32)
    cpu = DMoETransformerLM(cfg, device="cpu")
    gpu = DMoETransformerLM(cfg, device="cuda")
    params = cpu.init_params(prng.PRNGKey(SEED))
    params_gpu = tree_to(params, "cuda")
    ids = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(1))
    want = cpu.apply(params, ids)[0]
    got = gpu.apply(params_gpu, ids.cuda())[0].cpu()
    err = float((got - want).abs().max())
    print(f"tiny f32 model, card vs cpu: max|logits diff| = {err:.3e}")
    assert err < 1e-4, "the card's logits disagree with the CPU's"
    prompt = ids[:, :6].to(torch.int32)
    want_tok = cpu.generate(params, prompt, 8, use_cache=True)
    got_tok = gpu.generate(params_gpu, prompt.cuda(), 8, use_cache=True).cpu()
    assert torch.equal(want_tok, got_tok), "greedy tokens differ card vs cpu"


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    denom = float(a.norm() * b.norm())
    return 1.0 if denom == 0 else float(a @ b) / denom


def small_train_reference(counters) -> None:
    """One train step of a tiny bf16 fused-CE model: the card runs K1-K3,
    the CPU their plain versions."""
    cfg = DMoETransformerConfig(
        vocab_size=2048, d_model=128, n_layers=1, n_heads=4, seq_len=16,
        num_experts=4, k=2, dtype=torch.bfloat16, ce_impl="fused",
        remat=True, stack_layers=False, scan_layers=False)
    models = {dev: DMoETransformerLM(cfg, device=dev) for dev in ("cpu", "cuda")}
    params = models["cpu"].init_params(prng.PRNGKey(SEED))
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 2048, (8, 16), generator=gen)
    tgt = torch.randint(0, 2048, (8, 16), generator=gen)
    out = {}
    for dev, model in models.items():
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        reset_counts(counters)
        (loss, _), grads = model.value_and_grad(p, ids.to(dev), tgt.to(dev))
        grads = tree_leaves(grads)
        step = model.make_train_step(fused_adafactor(1e-3))
        _, _, step_loss, _ = step(p, model.init_opt_state(fused_adafactor(1e-3), p),
                                  ids, tgt)
        out[dev] = (float(loss), [g.cpu() for g in grads], float(step_loss),
                    read_counts(counters))
    per_step = {"fused_ce_fwd": 2, "fused_ce_dx": 2, "fused_ce_dhead": 2}
    assert out["cpu"][3] == dict.fromkeys(counters, 0), out["cpu"][3]
    assert out["cuda"][3] == {**dict.fromkeys(counters, 0), **per_step}, \
        out["cuda"][3]
    l_cpu, l_gpu = out["cpu"][0], out["cuda"][0]
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    step_rel = abs(out["cuda"][2] - out["cpu"][2]) / abs(out["cpu"][2])
    cosines = [cosine(a, b) for a, b in zip(out["cuda"][1], out["cpu"][1])]
    print(f"tiny bf16 fused-CE model, card vs cpu: loss {l_gpu:.5f} vs "
          f"{l_cpu:.5f} (rel {rel:.2e}); train-step loss rel {step_rel:.2e}; "
          f"min gradient cosine {min(cosines):.5f} over {len(cosines)} leaves")
    assert rel <= SMALL_LOSS_RTOL and step_rel <= SMALL_LOSS_RTOL, \
        "the card's loss disagrees with the CPU's"
    assert min(cosines) >= SMALL_GRAD_COSINE, "gradients differ card vs cpu"


def leaf_paths(tree, prefix="") -> list[str]:
    """Names of the leaves of a param tree, in tree_leaves' order."""
    if isinstance(tree, dict):
        return [p for key, val in tree.items()
                for p in leaf_paths(val, f"{prefix}.{key}" if prefix else key)]
    if isinstance(tree, (tuple, list)):
        return [p for i, val in enumerate(tree)
                for p in leaf_paths(val, f"{prefix}[{i}]")]
    return [prefix]


def tree_to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def reset_counts(counters) -> None:
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters) -> dict:
    return {name: fn.launches for name, fn in counters.items()}


def timed(fn) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def capture_dispatch(plans: list, label: str, count: int):
    """Keeps ``(label, layer, x, token_for_slot)`` of the first ``count``
    gather dispatches of the MoE layers (a forward's layers, in order):
    the inputs K4's path is driven with."""
    own = sharded_moe.dispatch_tokens_indexed
    seen = []

    def dispatch(x, plan):
        if len(seen) < count:
            seen.append((label, len(seen), x.detach(),
                         plan.token_for_slot.detach()))
        return own(x, plan)

    sharded_moe.dispatch_tokens_indexed = dispatch
    try:
        yield
    finally:
        sharded_moe.dispatch_tokens_indexed = own
    assert len(seen) == count, (label, len(seen))
    plans.extend(seen)


def serve_flagship(counters, plans: list) -> dict:
    """Phase 5; returns the kernel counts of one generate and keeps the
    prefill's dispatch plans in ``plans``."""
    cfg = DMoETransformerConfig(**FLAGSHIP_8K)
    model = DMoETransformerLM(cfg, device="cuda")
    assert model.cfg.attn_impl == "flash", model.cfg.attn_impl
    params = model.init_params(prng.PRNGKey(SEED))
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch, prompt_len, new = 2, 4096, 32
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), dtype=torch.int32,
        device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED + 1),
    )
    with capture_dispatch(plans, "flagship-8k prefill", cfg.n_layers):
        model.generate(params, prompts, 2, use_cache=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_counts(counters)
    out, t_total = timed(
        lambda: model.generate(params, prompts, new, use_cache=True))
    launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"kernel launches in one generate: {launches}")
    assert launches["flash_attn_fwd"] == cfg.n_layers, launches
    # serving takes no gradient: no backward kernel, no lse
    assert launches["flash_attn_bwd_dkv"] == launches["flash_attn_bwd_dq"] == 0
    assert out.shape == (batch, prompt_len + new) and out.dtype == torch.int32
    assert torch.equal(out[:, :prompt_len], prompts)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size

    prefill_s = statistics.median(
        timed(lambda: model.generate(params, prompts, 1, use_cache=True))[1]
        for _ in range(3))
    decode_ms = (t_total - prefill_s) / (new - 1) * 1e3
    print(f"params {n_params / 1e9:.3f} B; generate 2x{prompt_len} + {new}: "
          f"{t_total * 1e3:.1f} ms; prefill (+1 token) {prefill_s * 1e3:.1f} ms; "
          f"decode {decode_ms:.2f} ms/token; "
          f"{batch * new / t_total:.1f} new tokens/s; peak {peak_gb:.2f} GB")

    plain = DMoETransformerLM(dataclasses.replace(cfg, attn_impl="xla"),
                              device="cuda")
    logits_flash = model.apply(params, prompts)[0]
    logits_plain = plain.apply(params, prompts)[0]
    assert logits_flash.shape == (batch, prompt_len, cfg.vocab_size)
    assert torch.isfinite(logits_flash).all() and torch.isfinite(logits_plain).all()
    diff = (logits_flash - logits_plain).abs()
    lmax, lmean = float(diff.max()), float(diff.mean())
    argmax_same = float(
        (logits_flash.argmax(-1) == logits_plain.argmax(-1)).float().mean())
    del logits_flash, logits_plain, diff
    print(f"prefill logits flash vs plain attention: max|diff| {lmax:.4f}, "
          f"mean|diff| {lmean:.2e}, argmax agreement {argmax_same:.5f}")
    assert lmax <= LOGITS_MAX_ABS and lmean <= LOGITS_MEAN_ABS, (lmax, lmean)
    out_plain = plain.generate(params, prompts, new, use_cache=True)
    match = float((out_plain[:, prompt_len:] == out[:, prompt_len:]).float().mean())
    print(f"greedy token match, flash vs plain attention: {match:.4f}")
    return launches


def train_batch(cfg, batch: int, seed: int):
    """One fixed batch of random token ids and their next-token targets."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    seq = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len + 1),
                        dtype=torch.int32, device="cuda", generator=gen)
    return seq[:, :-1].contiguous(), seq[:, 1:].contiguous()


def build_train(name: str):
    """(model, params, optimizer, opt_state, step, ids, tgt) of the
    training configuration ``name`` (a key of TRAINING) with random
    weights from SEED."""
    config, batch = TRAINING[name]
    cfg = DMoETransformerConfig(**config)
    model = DMoETransformerLM(cfg, device="cuda")
    # bf16 at head dim 64: the auto rule picks the flash kernels at every
    # length
    assert model.cfg.attn_impl == "flash", model.cfg.attn_impl
    params = model.init_params(prng.PRNGKey(SEED))
    optimizer = fused_adafactor(1e-3)
    opt_state = model.init_opt_state(optimizer, params)
    step = model.make_train_step(optimizer)
    ids, tgt = train_batch(cfg, batch, SEED + 2)
    return model, params, optimizer, opt_state, step, ids, tgt


def train(name: str, counters, plans: list) -> dict:
    """Phases 6-9: one training configuration; returns the number of its
    timed steps and their kernel counts.  The first step's dispatch plans go
    to ``plans`` (the balanced run's: its last balance step's)."""
    model, params, _, opt_state, step, ids, tgt = build_train(name)
    cfg = model.cfg
    n_params = sum(t.numel() for t in tree_leaves(params))
    tokens = ids.numel()
    balanced = bool(cfg.router_jitter)
    short = cfg.gating == "expert_choice" or cfg.remat_policy == "dots"
    n_steps = SHORT_STEPS if short else TRAIN_STEPS
    capture = (capture_dispatch(plans, name, cfg.n_layers)
               if cfg.gating == "topk" and not (balanced or short)
               else contextlib.nullcontext())
    if balanced:
        clean_dropped = dropped_without_jitter(model, params, ids, tgt)
    with capture, routing_log() as (chosen, _):
        (params, opt_state, loss0, metrics0), warm_s = timed(
            lambda: step(params, opt_state, ids, tgt))
    print(f"params {n_params / 1e9:.3f} B ({tree_leaves(params)[0].dtype}); "
          f"batch {ids.shape[0]} x {cfg.seq_len}; "
          f"warm-up step {warm_s * 1e3:.1f} ms, loss {float(loss0):.5f}, "
          f"metrics {({k: round(float(v), 5) for k, v in metrics0.items()})}")
    dropped = [float(metrics0["dropped_fraction"])]
    if balanced:
        check_recompute_routing(chosen, cfg.n_layers)
        print(f"first step: dropped fraction {dropped[0]:.5f} with jitter, "
              f"{clean_dropped:.5f} without it on the same weights")
        assert dropped[0] < clean_dropped, "jitter split no ties"
        for i in range(BALANCE_STEPS - 1):
            last = i == BALANCE_STEPS - 2
            with (capture_dispatch(plans, f"{name} after balance",
                                   cfg.n_layers)
                  if last else contextlib.nullcontext()):
                params, opt_state, _, metrics = step(params, opt_state, ids,
                                                     tgt)
            dropped.append(float(metrics["dropped_fraction"]))
    del chosen
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    step_ms, losses = [], []
    for _ in range(n_steps):
        (params, opt_state, loss, metrics), dt = timed(
            lambda: step(params, opt_state, ids, tgt))
        step_ms.append(dt * 1e3)
        losses.append(float(loss))
        dropped.append(float(metrics["dropped_fraction"]))
    launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: n / n_steps for k, n in launches.items()}
    print(f"kernel launches in {n_steps} train steps: {launches}; "
          f"per step {per_step}")
    print(f"losses {[round(float(loss0), 5)] + [round(x, 5) for x in losses]}; "
          f"last metrics {({k: round(float(v), 5) for k, v in metrics.items()})}")
    label = ("uncovered fraction (no expert picked the token)"
             if cfg.gating == "expert_choice" else "dropped fraction")
    print(f"{label}: first step {dropped[0]:.5f}, last step "
          f"{dropped[-1]:.5f}; every step {[round(x, 4) for x in dropped]}")
    med = statistics.median(step_ms)
    print(f"{name} step: median {med:.1f} ms (all {[round(t, 1) for t in step_ms]}), "
          f"{tokens / med * 1e3:.0f} tokens/s, peak {peak_gb:.2f} GB")
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < float(loss0), "the loss did not fall on a fixed batch"
    want = {**dict.fromkeys(counters, 0),
            "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dhead": 1,
            "flash_attn_fwd": 2 * cfg.n_layers,
            "flash_attn_bwd_dkv": cfg.n_layers,
            "flash_attn_bwd_dq": cfg.n_layers}
    assert per_step == want, (per_step, want)
    if not (balanced or short):
        check_flash_training(model, params)
    if balanced:
        check_jitter_noise(cfg, tokens)
    elif cfg.remat_policy == "dots":
        check_dots(model, params, ids, tgt)
    elif name == "flagship-train":
        check_fused_training(model, params, ids, tgt)
    return n_steps, launches


def dropped_without_jitter(model, params, ids, tgt) -> float:
    """The dropped fraction of the same weights and batch routed without
    jitter (a forward only)."""
    clean = DMoETransformerLM(dataclasses.replace(model.cfg, router_jitter=0.0),
                              device="cuda")
    with torch.no_grad():
        _, metrics = clean.loss_fn(params, ids, tgt)
    return float(metrics["dropped_fraction"])


def check_recompute_routing(chosen, n_layers: int) -> None:
    """Remat's recompute (the layers in reverse) routed every token as the
    forward did: the jitter noise is the same draw in both."""
    assert len(chosen) == 2 * n_layers, len(chosen)
    differ = [int((fwd != again).sum())
              for fwd, again in zip(chosen[:n_layers], chosen[::-1])]
    print(f"routing choices that differ, forward vs remat recompute, per "
          f"layer: {differ}")
    assert not any(differ), differ


def check_jitter_noise(cfg, n_tokens: int) -> None:
    """Each layer's jitter noise as the card drew it for the run equals
    the CPU's draw bit for bit (the CPU side is what the tests hold
    against jax.random)."""
    shape = (n_tokens, cfg.num_experts)
    card = torch.device("cuda", torch.cuda.current_device())
    hits = moe_dispatch._jitter_noise.cache_info().hits
    for salt in range(cfg.n_layers):
        args = (cfg.router_jitter, salt, shape, torch.float32)
        on_card = moe_dispatch._jitter_noise(*args, card)
        on_cpu = moe_dispatch._jitter_noise(*args, torch.device("cpu"))
        assert torch.equal(_bits(on_card).cpu(), _bits(on_cpu)), salt
    assert moe_dispatch._jitter_noise.cache_info().hits == hits + cfg.n_layers
    print(f"jitter noise {list(shape)} of layers 0-{cfg.n_layers - 1}: card "
          f"and cpu bit for bit; {moe_dispatch._jitter_noise.cache_info()}")


def check_dots(model, params, ids, tgt) -> None:
    """Remat "dots" against "full" on one batch: the loss and every
    gradient leaf bit for bit (every kernel on the path is deterministic);
    the memory each takes above the resting state."""
    full = DMoETransformerLM(dataclasses.replace(model.cfg,
                                                 remat_policy="full"),
                             device="cuda")
    out, extra_gb = {}, {}
    for label, m in (("dots", model), ("full", full)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (loss, _), grads = m.value_and_grad(params, ids, tgt)
        torch.cuda.synchronize()
        extra_gb[label] = (torch.cuda.max_memory_allocated() - base) / 1e9
        out[label] = (loss, tree_leaves(grads))
        del grads
    same = [torch.equal(a, b) for a, b in zip(out["dots"][1], out["full"][1])]
    print(f'remat "dots" vs "full", one batch: loss {float(out["dots"][0]):.6f}'
          f' vs {float(out["full"][0]):.6f}; {sum(same)} of {len(same)} '
          f"gradient leaves bit for bit; peak above resting state "
          f'{extra_gb["dots"]:.2f} GB vs {extra_gb["full"]:.2f} GB')
    assert torch.equal(out["dots"][0], out["full"][0])
    assert all(same), [n for n, ok in zip(leaf_paths(params), same) if not ok]


def check_fused_training(model, params, ids, tgt) -> None:
    """The fused CE against the chunked CE on the same batch and weights."""
    chunked = DMoETransformerLM(dataclasses.replace(model.cfg,
                                                    ce_impl="chunked"),
                                device="cuda")
    (l_fused, _), grads = model.value_and_grad(params, ids, tgt)
    e_fused = grads["embed"].float()
    del grads
    (l_chunk, _), grads = chunked.value_and_grad(params, ids, tgt)
    e_chunk = grads["embed"].float()
    del grads
    cos = cosine(e_fused, e_chunk)
    dloss = abs(float(l_fused) - float(l_chunk))
    print(f"fused vs chunked CE: loss {float(l_fused):.6f} vs "
          f"{float(l_chunk):.6f} (|diff| {dloss:.2e}); embedding-gradient "
          f"cosine {cos:.6f}")
    assert dloss <= FUSED_LOSS_ATOL and cos >= EMBED_GRAD_COSINE


@contextlib.contextmanager
def routing_log(replay=None):
    """Records the top-k expert choices [n, k] of every routing call in
    call order (under remat the forward's, then the recompute's).  Given
    ``replay``, the record of the same model's calls, each call routes to
    the recorded experts instead, with the gate weights of its own logits,
    and ``differ`` gets how many of its own choices were other ones."""
    own_top_k = moe_dispatch._top_k
    chosen, differ = [], []

    def top_k(x, k):
        w, i = own_top_k(x, k)
        if replay is not None:
            pinned = replay[len(chosen)]
            differ.append(int((i != pinned).sum()))
            i, w = pinned, x.gather(-1, pinned.long())
        chosen.append(i)
        return w, i

    moe_dispatch._top_k = top_k
    try:
        yield chosen, differ
    finally:
        moe_dispatch._top_k = own_top_k


def grad_agreement(g_a, g_b) -> dict:
    """{leaf name: (cosine, |1 - |a| / |b||)} of two gradient trees."""
    out = {}
    for name, a, b in zip(leaf_paths(g_a), tree_leaves(g_a), tree_leaves(g_b)):
        na, nb = float(a.double().norm()), float(b.double().norm())
        out[name] = (cosine(a, b),
                     0.0 if na == nb else abs(1 - na / nb) if nb else math.inf)
    return out


def report_agreement(label: str, agree: dict) -> None:
    attn = {n: v for n, v in agree.items()
            if n.rsplit(".", 1)[-1] in ATTN_LEAVES}
    print(f"{label}: attention projections (cosine, norm deviation) "
          + ", ".join(f"{n} {c:.6f} {d:.1e}" for n, (c, d) in attn.items()))
    worst = sorted(agree.items(), key=lambda kv: kv[1][0])[:6]
    print(f"{label}: min cosine {worst[0][1][0]:.6f} over {len(agree)} "
          "leaves; lowest " + ", ".join(f"{n} {c:.6f} {d:.1e}"
                                        for n, (c, d) in worst))


def check_flash_training(model, params) -> None:
    """Flash against plain attention on the same weights and one batch of
    FLASH_CHECK_TOKENS tokens (1 row at seq 8192, 32 at 256), where the
    plain path's [rows, H, S, S] scores fit, first with each
    path routing by itself, then with the plain path replaying the flash
    path's routing.  The losses agree; the attention projections'
    gradients pass ATTN_GRAD_COSINE and ATTN_GRAD_NORM_RTOL, every leaf's
    FLASH_GRAD_COSINE, and with one routing every leaf the attention
    projections' limits; no leaf's gradient is all zeros (wq, wk and wv's
    would be if the flash kernels' gradient were dropped)."""
    rows = max(1, FLASH_CHECK_TOKENS // model.cfg.seq_len)
    ids, tgt = train_batch(model.cfg, rows, SEED + 3)
    plain = DMoETransformerLM(dataclasses.replace(model.cfg, attn_impl="xla"),
                              device="cuda")
    n_layers = model.cfg.n_layers
    with routing_log() as (flash_route, _):
        (l_flash, m_flash), g_flash = model.value_and_grad(params, ids, tgt)
    with routing_log() as (plain_route, _):
        (l_plain, _), g_plain = plain.value_and_grad(params, ids, tgt)
    moved = [int((a != b).sum())
             for a, b in zip(flash_route[:n_layers], plain_route[:n_layers])]
    zero = [n for n, g in zip(leaf_paths(g_flash), tree_leaves(g_flash))
            if not bool(g.any())]
    own = grad_agreement(g_flash, g_plain)
    del g_plain
    with routing_log(replay=flash_route) as (replayed, differ):
        (l_pinned, _), g_pinned = plain.value_and_grad(params, ids, tgt)
    assert len(replayed) == len(flash_route), (len(replayed), len(flash_route))
    pinned = grad_agreement(g_flash, g_pinned)
    del g_pinned, g_flash
    rel, rel_pinned = (abs(float(l_flash) - float(x)) / abs(float(x))
                       for x in (l_plain, l_pinned))
    print(f"flash vs plain attention, batch {rows} x {model.cfg.seq_len}: loss "
          f"{float(l_flash):.6f} vs {float(l_plain):.6f} (rel {rel:.2e}), "
          f"{float(l_pinned):.6f} replaying flash's routing (rel "
          f"{rel_pinned:.2e}); dropped fraction "
          f"{float(m_flash['dropped_fraction']):.4f}; all-zero leaves {zero}")
    print(f"routing choices (of {ids.numel() * model.cfg.k} a layer) that "
          f"differ, flash vs plain, per layer: {moved}; plain's own choices "
          f"where it replays flash's routing: {differ[:n_layers]}")
    report_agreement("own routing", own)
    report_agreement("flash's routing", pinned)
    assert not zero, f"gradient leaves {zero} are all zeros"
    assert max(rel, rel_pinned) <= FLASH_LOSS_RTOL, \
        "flash and plain attention losses differ"
    for name, (cos, dev) in own.items():
        if name.rsplit(".", 1)[-1] in ATTN_LEAVES:
            assert cos >= ATTN_GRAD_COSINE and dev <= ATTN_GRAD_NORM_RTOL, \
                f"flash and plain {name} gradients differ: {cos}, {dev}"
        assert cos >= FLASH_GRAD_COSINE, f"flash and plain {name} differ: {cos}"
    for name, (cos, dev) in pinned.items():
        assert cos >= ATTN_GRAD_COSINE and dev <= ATTN_GRAD_NORM_RTOL, \
            f"with one routing, flash and plain {name} differ: {cos}, {dev}"


def _dispatch_form(label: str) -> str | None:
    return "balanced routing" if "balance" in label else None


def dispatch_path(plans, counters, results) -> dict:
    """Phase 10, K4's path: ``dispatch_tokens_auto(use_kernel=True)`` on
    every plan the flagship's MoE layers made on the paths above; each
    output equals the plain version's bit for bit.  Returns the path's
    kernel counts."""
    reset_counts(counters)
    with torch.no_grad():
        outs = [td.dispatch_tokens_auto(x, _index_plan(tfs), use_kernel=True)
                for _, _, x, tfs in plans]
    torch.cuda.synchronize()
    launches = read_counts(counters)
    assert launches == {**dict.fromkeys(counters, 0),
                        "token_dispatch": len(plans)}, launches
    fills = {}
    for (label, layer, x, tfs), out in zip(plans, outs):
        record(results, "token_dispatch", (*x.shape, *tfs.shape),
               _dispatch_form(label),
               max_abs_err=dispatch_err(f"{label} layer {layer}", out, x, tfs))
        fills.setdefault(f"{label} {list(x.shape) + list(tfs.shape)}",
                         []).append(round(float((tfs >= 0).float().mean()), 4))
    print(f"dispatch_tokens_auto(use_kernel=True) on {len(plans)} plans: "
          f"{launches['token_dispatch']} launches, every output bit for bit "
          f"the plain version's; filled share of the slots per layer {fills}")
    return launches


# ---- phase 11: the swarm expert server and client ----


def swarm_client(endpoint, wire: str = "none",
                 grace: float = 1.0) -> RemoteMixtureOfExperts:
    """The phase's client.  ``wire`` pins the wire codec: "none" (f32) or
    "bf16" (the adaptive default would pick bf16 or 8-bit codecs for a
    pool whose exchanges look slow, as the CPU copy's do: a lossy wire
    must be chosen, not stumbled into).  ``grace`` is its
    ``timeout_after_k_min`` (the quorum's wait for stragglers once every
    row has k_min replies)."""
    uids = [f"{SWARM['expert_prefix']}.{i}"
            for i in range(SWARM["num_experts"])]
    return RemoteMixtureOfExperts(
        in_features=SWARM["hidden_dim"], grid_size=(SWARM["num_experts"],),
        uid_prefix=SWARM["expert_prefix"], k_best=2, k_min=1,
        timeout_after_k_min=grace, wire_codec=wire,
        wire_dtype="bfloat16" if wire == "bf16" else None,
        source=StaticExpertSource({uid: endpoint for uid in uids}))


def swarm_step(moe, gate, x, cot):
    """One forward and backward through the MoE: ``(y, x grad, gate
    grads)``; ``cot`` is d(loss)/dy."""
    g = {k: v.detach().clone().requires_grad_(True) for k, v in gate.items()}
    xg = x.detach().clone().requires_grad_(True)
    y = moe(xg, g)
    y.backward(cot)
    return y.detach(), xg.grad, {k: v.grad for k, v in g.items()}


def _close(got, want, what, atol, rtol) -> float:
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    if got.numel() == 0:
        return 0.0
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    assert torch.isfinite(got).all(), f"{what} is not finite"
    assert bad == 0, f"{what}: {bad} elements outside tolerance " \
                     f"(max err {float(err.max()):.3g})"
    return float(err.max())


def _moments(backend) -> tuple[list, list]:
    state = backend.opt_state[0]
    return ([m.detach().cpu().clone() for m in nested_flatten(state.mu)],
            [v.detach().cpu().clone() for v in nested_flatten(state.nu)])


def check_swarm_step(card_srv, cpu_srv, step: int) -> None:
    """After one adam step that both sides took from the same state: each
    expert's moments and params on the card against the CPU copy.  The
    moments within SWARM_MOMENT_ATOL of each leaf's largest value plus
    SWARM_MOMENT_RTOL |ref|.  Adam moves a param by ~lr whatever |g| is
    (a first step is lr * sign(g)), so a gradient difference dg between
    the sides moves it apart by up to ``lr * min(2, 2 |dg| / (sqrt(v) +
    eps))``, dg read off the first moments (``mu = 0.9 mu_0 + 0.1 g``
    from one mu_0): each param within that plus SWARM_PARAM_ATOL +
    SWARM_PARAM_RTOL |ref|.  A failure names the leaf and its worst
    element."""
    for uid, card_b in card_srv.experts.items():
        cpu_b = cpu_srv.experts[uid]
        names = leaf_paths(cpu_b.params)
        (mu_g, nu_g), (mu_c, nu_c) = _moments(card_b), _moments(cpu_b)
        for what, got, want in (("mu", mu_g, mu_c), ("nu", nu_g, nu_c)):
            for name, g, w in zip(names, got, want):
                _close(g, w, f"step {step} {uid} {what} {name}",
                       SWARM_MOMENT_ATOL * float(w.abs().max()),
                       SWARM_MOMENT_RTOL)
        corr = 1 - 0.999 ** int(cpu_b.opt_state[0].count)
        n_tight = n_all = 0
        ratio = 0.0
        for name, pc, pg, mg, mc, v in zip(
                names, nested_flatten(cpu_b.params),
                nested_flatten(card_b.params), mu_g, mu_c, nu_c):
            dg = (mg - mc).abs() / 0.1
            bound = SWARM_LR * torch.clamp(
                2 * dg / ((v / corr).sqrt() + 1e-8), max=2.0)
            err = (pg.cpu() - pc).abs()
            limit = SWARM_PARAM_ATOL + SWARM_PARAM_RTOL * pc.abs() + bound
            bad = err > limit
            if bad.any():
                i = int(torch.argmax(torch.where(bad, err - limit, 0.0)))
                raise AssertionError(
                    f"step {step} {uid} {name}: {int(bad.sum())} params "
                    f"outside their bounds; worst: card "
                    f"{float(pg.flatten()[i]):.8g} cpu "
                    f"{float(pc.flatten()[i]):.8g}, bound "
                    f"{float(limit.flatten()[i]):.3g}")
            ratio = max(ratio, float((err / limit).max()))
            n_tight += int((bound <= SWARM_PARAM_ATOL).sum())
            n_all += bound.numel()
        print(f"  step {step} {uid}: moments and params match the cpu copy "
              f"({n_tight / n_all:.4f} of the params held within "
              f"{2 * SWARM_PARAM_ATOL:.0e} + {SWARM_PARAM_RTOL:.0e} |ref|; "
              f"largest error / bound {ratio:.3f})")


def swarm_breakdown(run, card: str) -> None:
    """Where a swarm step's time goes, after the timed window: the spans
    of SWARM_SPAN_STEPS steps with the timeline on (client, handler and
    Runtime spans, p50 a step, summed over the 4 experts), and on the card
    the kernels' summed time against the wall time of SWARM_PROFILE_STEPS
    steps under ``torch.profiler`` (the busy share)."""
    timeline.clear()
    timeline.enable()
    try:
        run(SWARM_SPAN_STEPS)
    finally:
        timeline.disable()
    totals = {}
    for name, st in timeline.summary().items():
        key = re.sub(r"\.swarm\.\d+\.", ".*.", name)
        totals[key] = totals.get(key, 0.0) + st["total_ms"]
    timeline.clear()
    print(f"  spans, ms a step over {SWARM_SPAN_STEPS} steps: " + ", ".join(
        f"{k} {v / SWARM_SPAN_STEPS:.3f}"
        for k, v in sorted(totals.items(), key=lambda kv: -kv[1])))
    if card != "cuda":
        return
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(SWARM_PROFILE_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    print(f"  profiled {SWARM_PROFILE_STEPS} steps: kernels {busy:.3f} ms "
          f"in {wall_ms:.3f} ms wall, busy share {busy / wall_ms:.4f}; top: "
          + "; ".join(f"{name[:50]} {ms:.3f} ms x{n}"
                      for name, ms, n in rows[:6]))


def swarm(counters, card: str = "cuda") -> dict:
    """Phase 11 (see the module docstring).  Returns the kernels' launch
    counts of the phase's main path (the card server's run).  ``card``
    names the device under test (a CPU rehearsal passes "cpu")."""
    hidden, rows = SWARM["hidden_dim"], SWARM_ROWS
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if card == "cuda" else (lambda: None)
    gen = torch.Generator(device=card).manual_seed(SEED)
    card_srv = Server.create(**SWARM, optimizer=optim.adam(SWARM_LR),
                             warmup=True, seed=SEED, host="127.0.0.1",
                             device=card)
    cpu_srv = None
    try:
        cpu_srv = Server.create(**SWARM, optimizer=optim.adam(SWARM_LR),
                                seed=SEED, host="127.0.0.1", device="cpu")
        for uid, b in card_srv.experts.items():
            devices = {t.device.type for t in tree_leaves(b.params)}
            devices |= {t.device.type for t in tree_leaves(b.opt_state)}
            assert devices == {card}, f"{uid} is not on {card}: {devices}"
        leaf = nested_flatten(card_srv.experts["swarm.0"].params)[0]
        print(f"params on {leaf.device}; "
              f"{card_srv.experts['swarm.0'].get_info()['num_params']} a "
              f"expert; warm buckets "
              f"{sorted(card_srv.experts['swarm.0'].warm_buckets)}")
        gate = swarm_client(card_srv.endpoint).init_gate_params(
            prng.PRNGKey(SEED, device=card))
        x = torch.randn((rows, hidden), generator=gen, device=card)
        target = torch.tanh(
            x @ torch.randn((hidden, hidden), generator=gen, device=card)
            / math.sqrt(hidden))

        # correctness: the card pair against a CPU copy of the server and
        # client, SWARM_CHECK_STEPS steps, each from the same state on both
        # sides (the CPU copy takes the card's state first: a param that
        # adam moved apart in one step would move the next step's
        # gradients apart too).  Both clients wait for every expert's
        # reply: with k_min 1 the quorum drops a straggler after its
        # grace, and the CPU experts' backward at hidden 1024 takes longer
        # than the default 1 s, so the two would differ by its share
        fresh = {uid: b.state_dict() for uid, b in card_srv.experts.items()}
        check_moe = swarm_client(card_srv.endpoint, grace=SWARM_CHECK_GRACE_S)
        cpu_moe = swarm_client(cpu_srv.endpoint, grace=SWARM_CHECK_GRACE_S)
        gate_cpu = tree_to(gate, "cpu")
        for step in range(1, SWARM_CHECK_STEPS + 1):
            for uid, b in card_srv.experts.items():
                cpu_srv.experts[uid].load_state_dict(b.state_dict())
            cot = torch.randn((rows, hidden), generator=gen, device=card)
            got = swarm_step(check_moe, gate, x, cot)
            want = swarm_step(cpu_moe, gate_cpu, x.cpu(), cot.cpu())
            assert check_moe.selection_log[-1] == cpu_moe.selection_log[-1]
            errs = [_close(got[0], want[0], "y", SWARM_TOL, SWARM_TOL),
                    _close(got[1], want[1], "x grad", SWARM_TOL, SWARM_TOL),
                    _close(got[2]["w0"], want[2]["w0"], "gate grad",
                           SWARM_TOL, SWARM_TOL)]
            print(f"  step {step}, card against cpu: max |err| y "
                  f"{errs[0]:.3g}, x grad {errs[1]:.3g}, gate grad "
                  f"{errs[2]:.3g}")
            for uid, b in card_srv.experts.items():
                assert b.update_count == cpu_srv.experts[uid].update_count \
                    == step, uid
            check_swarm_step(card_srv, cpu_srv, step)
        for moe in (check_moe, cpu_moe):
            assert moe.samples_dropped == moe.backward_samples_dropped == 0
            assert moe.backward_rpcs_ok == moe.backward_rpcs_sent
            assert set(moe.codec_counts) == {"none"}, moe.codec_counts
        # the main path starts from the fresh state
        for uid, b in card_srv.experts.items():
            b.load_state_dict(fresh[uid])
        card_moe = swarm_client(card_srv.endpoint)

        # training: a fixed regression, gate trained by the client's adam;
        # the last SWARM_LATENCY_CALLS steps are the timed window
        reset_counts(counters)
        gate_opt = optim.adam(SWARM_LR)
        opt = {"gate": gate, "state": gate_opt.init(gate)}
        losses, fwd_s, bwd_s = [], [], []

        def run(n, timed=False):
            for _ in range(n):
                g = {k: v.detach().requires_grad_(True)
                     for k, v in opt["gate"].items()}
                sync()
                t0 = time.perf_counter()
                y = card_moe(x, g)
                loss = ((y - target) ** 2).mean()
                sync()
                t1 = time.perf_counter()
                loss.backward()
                sync()
                t2 = time.perf_counter()
                losses.append(float(loss.detach()))
                if timed:
                    fwd_s.append(t1 - t0)
                    bwd_s.append(t2 - t1)
                updates, opt["state"] = gate_opt.update(
                    {k: v.grad for k, v in g.items()}, opt["state"],
                    opt["gate"])
                opt["gate"] = optim.apply_updates(
                    {k: v.detach() for k, v in g.items()}, updates)

        run(SWARM_TRAIN_STEPS)
        rt0 = card_srv.runtime.stats()
        run(SWARM_LATENCY_CALLS, timed=True)
        rt1 = card_srv.runtime.stats()
        counts = read_counts(counters)
        print(f"  loss {losses[0]:.5f} -> {losses[SWARM_TRAIN_STEPS - 1]:.5f} "
              f"in {SWARM_TRAIN_STEPS} steps, {losses[-1]:.5f} after "
              f"{len(losses)}")
        assert all(math.isfinite(v) for v in losses)
        assert losses[SWARM_TRAIN_STEPS - 1] < losses[0], \
            f"swarm loss did not fall: {losses[:SWARM_TRAIN_STEPS]}"
        updates_total = sum(b.update_count for b in card_srv.experts.values())
        assert updates_total == card_moe.backward_rpcs_sent == \
            card_moe.backward_rpcs_ok, (updates_total,
                                        card_moe.backward_rpcs_sent)
        assert card_moe.samples_dropped == 0
        assert set(card_moe.codec_counts) == {"none"}, card_moe.codec_counts
        print(f"  update_count {updates_total} = backward RPCs "
              f"{card_moe.backward_rpcs_sent}")

        def pct(v, q):
            return statistics.quantiles(v, n=100)[q - 1] * 1e3

        jobs = rt1["jobs_processed"] - rt0["jobs_processed"]
        per_job = {key: (rt1[key] - rt0[key]) / jobs for key in (
            "queue_time_ms", "stack_time_ms", "device_time_ms",
            "materialize_time_ms")}
        total = sum(fwd_s) + sum(bwd_s)
        print(f"swarm {SWARM_LATENCY_CALLS} calls, {rows} rows each: "
              f"forward p50 {pct(fwd_s, 50):.3f} ms p95 {pct(fwd_s, 95):.3f} "
              f"ms; backward p50 {pct(bwd_s, 50):.3f} ms p95 "
              f"{pct(bwd_s, 95):.3f} ms; {rows * len(fwd_s) / total:.1f} "
              f"rows/s forward+backward")
        print(f"swarm runtime per job ({jobs} jobs, "
              f"{rt1['jobs_overlapped'] - rt0['jobs_overlapped']} "
              f"overlapped): " + ", ".join(
                  f"{k[:-3]} {v:.4f} ms" for k, v in per_job.items()))
        if card == "cuda":
            # the Runtime's forward job: ExpertBackend.forward in row
            # tiles (a row's bits then do not depend on its batch), and
            # the same batch as one product, the forward before the tiles
            backend = card_srv.experts["swarm.0"]

            def one_batch():
                with torch.no_grad():
                    return backend._apply(backend.params,
                                          backend._inputs(host_x))

            for n in (rows, 1):
                host_x = [x[:n].detach().cpu().numpy()]
                tiled, whole = (median_ms(lambda: backend.forward(host_x)),
                                median_ms(one_batch))
                print(f"  ExpertBackend.forward of {n} x {hidden}: "
                      f"{ROW_TILE['cuda']}-row tiles {tiled:.4f} ms, one "
                      f"batch (the forward before the tiles) {whole:.4f} ms "
                      f"[{card}]")
        swarm_breakdown(run, card)
        gate = opt["gate"]

        # the bf16 wire: one step from a snapshot, against the f32 wire's
        snap = {uid: b.state_dict() for uid, b in card_srv.experts.items()}
        cot = torch.randn((rows, hidden), generator=gen, device=card)
        ref = swarm_step(swarm_client(card_srv.endpoint,
                                      grace=SWARM_CHECK_GRACE_S), gate, x, cot)
        for uid, b in card_srv.experts.items():
            b.load_state_dict(snap[uid])
        bf16 = swarm_step(swarm_client(card_srv.endpoint, "bf16",
                                       grace=SWARM_CHECK_GRACE_S),
                          gate, x, cot)
        for what, a, b in (("y", bf16[0], ref[0]),
                           ("x grad", bf16[1], ref[1]),
                           ("gate grad", bf16[2]["w0"], ref[2]["w0"])):
            err = _close(a, b, f"bf16 wire {what}", SWARM_BF16_ATOL_SCALE
                         * float(b.abs().max()), 0.0)
            print(f"  bf16 wire {what}: max |err| {err:.3g} "
                  f"(max |ref| {float(b.abs().max()):.3g})")
        assert counts == read_counts(counters), "a kernel ran in phase 11"
        print(f"swarm phase: {time.perf_counter() - t_phase:.1f} s")
        return counts
    finally:
        card_srv.shutdown()
        if cpu_srv is not None:
            cpu_srv.shutdown()
        reset_client_rpc()


# ---- phase 13: the swarm DMoE-Transformer through the DHT ----


class SwarmServers:
    """Expert server processes started through the port's CLI, each
    writing its output to a log under ``build/swarm_logs``; :meth:`check`
    fails the phase with a log's tail when a process has exited, and
    :meth:`stop` ends them all (terminate, then kill).  The host's cores
    are shared out among the ``n_procs`` processes (``OMP_NUM_THREADS``):
    each draws its experts on the CPU, and four processes of torch's
    default 8 threads on 8 cores took 12x longer than 2 threads each."""

    def __init__(self, n_procs: int) -> None:
        self.threads = str(max(1, (os.cpu_count() or 1) // n_procs))
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.log_dir = os.path.join(self.root, "build", "swarm_logs")
        os.makedirs(self.log_dir, exist_ok=True)
        self.procs: list[tuple[str, subprocess.Popen, str]] = []

    def start(self, name: str, uids: list, hidden: int, peer, device: str,
              extra: list) -> None:
        log = os.path.join(self.log_dir, f"{name}.log")
        env = dict(os.environ, PYTHONPATH=self.root,
                   OMP_NUM_THREADS=self.threads)
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "learning_at_home_tpu_torch.server",
                 *(["--expert-uids", ",".join(uids)] if uids else []),
                 "--hidden-dim", str(hidden),
                 "--host", "127.0.0.1", "--initial-peers",
                 f"{peer[0]}:{peer[1]}", "--device", device, *extra],
                cwd=self.root, env=env, stdout=out, stderr=subprocess.STDOUT)
        self.procs.append((name, proc, log))

    def tail(self, log: str, n: int = 30) -> str:
        with open(log, errors="replace") as f:
            return "".join(f.readlines()[-n:])

    def logs_tail(self, names: list, n: int = 30) -> str:
        """The last ``n`` lines of each named process's log."""
        return "".join(f"--- {name}:\n{self.tail(log, n)}"
                       for name, _, log in self.procs if name in names)

    def check(self) -> None:
        for name, proc, log in self.procs:
            if proc.poll() is not None:
                raise AssertionError(
                    f"server process {name} exited with {proc.returncode}; "
                    f"its last output:\n{self.tail(log)}")

    def stop(self) -> None:
        for _, proc, _ in self.procs:
            if proc.poll() is None:
                proc.terminate()
        for _, proc, _ in self.procs:
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)


def grid_uids(prefix: str, grid) -> list:
    return [".".join([prefix, *map(str, c)])
            for c in itertools.product(*(range(g) for g in grid))]


def wait_for_experts(dht, servers: SwarmServers, prefixes, want: int,
                     deadline_s: float) -> dict:
    """uid -> endpoint of every expert alive under ``prefixes``, once all
    ``want`` are visible through ``dht`` (fails at the deadline)."""
    async def lookup():
        found = await asyncio.gather(
            *(dht.get_alive_experts_fresh(p) for p in prefixes))
        return {uid: ep for alive in found for uid, ep in alive.items()}

    t_end = time.perf_counter() + deadline_s
    while True:
        servers.check()
        alive = client_loop().run(lookup())
        if len(alive) >= want or time.perf_counter() > t_end:
            break
        time.sleep(0.5)
    assert len(alive) >= want, f"{len(alive)} of {want} experts alive"
    return alive


def hold_alive_sets(model, deadline_s: float) -> None:
    """Each of ``model``'s MoE layers resolves its alive set through the
    DHT until it holds the layer's whole grid, then keeps that set for
    ALIVE_HOLD_S (fails at the deadline).  Phases 13 and 15 run on servers
    that neither join nor leave, and phase 15 holds every arm's tokens
    against one reference, which presumes one alive set; a refresh whose
    lookup RPCs all time out on a loaded host returns an empty set, and
    the layer's next dispatch then finds no expert (ROADMAP queue 3)."""
    t_end = time.perf_counter() + deadline_s
    for m in model.moes:
        want = math.prod(m.grid_size)
        while True:
            alive = client_loop().run(m.alive_cache.get(force_refresh=True))
            if len(alive) >= want or time.perf_counter() > t_end:
                break
            time.sleep(0.5)
        assert len(alive) >= want, \
            f"{len(alive)} of {want} experts alive under {m.uid_prefix!r}"
        m.alive_cache.ttl = ALIVE_HOLD_S


def server_stats(endpoints) -> list:
    """Each server's ``stats`` RPC reply (one RPC a server)."""
    async def one(ep):
        _, meta = await pool_registry().get(ep).rpc("stats", (), {},
                                                    timeout=60.0)
        return meta

    async def gather():
        return await asyncio.gather(*(one(ep) for ep in endpoints))

    return client_loop().run(gather())


RUNTIME_KEYS = ("jobs_processed", "queue_time_ms", "stack_time_ms",
                "device_time_ms", "materialize_time_ms")


def runtime_totals(endpoints) -> dict:
    """The servers' Runtime counters (jobs, ms by stage), summed."""
    out = dict.fromkeys(RUNTIME_KEYS, 0.0)
    for st in server_stats(endpoints):
        for key in RUNTIME_KEYS:
            out[key] += float(st["runtime"][key])
    return out


def backward_ledger(model, endpoints) -> tuple:
    """(backward RPCs acked, the servers' summed update_count, backward
    RPCs sent) of the model's MoE layers."""
    updates = sum(int(st["update_count_total"])
                  for st in server_stats(endpoints))
    return (sum(m.backward_rpcs_ok for m in model.moes), updates,
            sum(m.backward_rpcs_sent for m in model.moes))


def count_forward_replies(moe) -> dict:
    """Counts the forward replies a MoE's fan-outs expected and the ones
    its quorum dropped (a straggler past the grace or a failed RPC), by
    wrapping its join-side finalizer; measurement only."""
    counts = {"expected": 0, "dropped": 0}
    finalize = moe._finalize_forward

    def wrapped(results, **kwargs):
        counts["expected"] += len(results)
        counts["dropped"] += sum(1 for r in results.values() if r[-1] is None)
        return finalize(results, **kwargs)

    moe._finalize_forward = wrapped
    return counts


def swarm_lm_twins(card: str) -> None:
    """Card against CPU: step 1's loss and every trunk and gate gradient of
    the twin swarms (see SWARM_LM_TWIN), within SWARM_TOL + SWARM_TOL
    |ref|; then (phase 15) a paged KV decoder on each twin: the same
    greedy tokens, the logits behind each first token within the same
    bar."""
    devices = ("cuda", "cpu")
    cfg = SwarmTransformerConfig(**SWARM_LM_TWIN)
    rs = np.random.RandomState(SEED)
    shape = (SWARM_LM_TWIN_BATCH, cfg.seq_len)
    ids = rs.randint(0, cfg.vocab_size, shape)
    tgt = rs.randint(0, cfg.vocab_size, shape)
    boots, servers = [], SwarmServers(len(devices) * cfg.n_layers)
    try:
        for i, dev in enumerate(devices):
            boots.append(DHT())
            for layer in range(cfg.n_layers):
                servers.start(f"twin{i}-{dev}-{layer}",
                              grid_uids(f"{cfg.uid_prefix}{layer}",
                                        cfg.grid_size),
                              cfg.d_model, boots[i].endpoint, dev,
                              SWARM_LM_SERVER)
        got, decoded = [], []
        for dev, boot in zip(devices, boots):
            dht = DHT(initial_peers=[boot.endpoint])
            try:
                wait_for_experts(dht, servers, [f"{cfg.uid_prefix}{i}" for i
                                                in range(cfg.n_layers)],
                                 cfg.n_layers * math.prod(cfg.grid_size), 120)
                model = SwarmDMoETransformerLM(cfg, dht)
                params = model.init_params(prng.PRNGKey(SEED), device=dev)
                loss, grads = optim.value_and_grad(model.loss_fn)(
                    params, ids, tgt)
                got.append((loss, grads,
                            [m.selection_log[-1] for m in model.moes]))
                blind = SwarmDMoETransformerLM(SwarmTransformerConfig(
                    **SWARM_LM_TWIN, routing_cost_weight=0), dht)
                decoded.append(twin_decoders(blind, params, dev))
            finally:
                dht.shutdown()
        (loss_c, g_c, sel_c), (loss_h, g_h, sel_h) = got
        assert sel_c == sel_h, "the twins chose other experts"
        errs = [_close(loss_c, loss_h, "loss", SWARM_TOL, SWARM_TOL)]
        for name, a, b in zip(leaf_paths(g_h), tree_leaves(g_c),
                              tree_leaves(g_h)):
            errs.append(_close(a, b, f"grad {name}", SWARM_TOL, SWARM_TOL))
        print(f"  twins, card against cpu: loss {float(loss_c):.6f} vs "
              f"{float(loss_h):.6f}; max |err| over loss and "
              f"{len(errs) - 1} gradient leaves {max(errs):.3g} (bar "
              f"{SWARM_TOL:.0e} + {SWARM_TOL:.0e} |ref|) [{card}]")
        (toks_c, logits_c), (toks_h, logits_h) = decoded
        assert toks_c == toks_h, (toks_c, toks_h)
        errs = [_close(a, b, "decoder prefill logits", SWARM_TOL, SWARM_TOL)
                for a, b in zip(logits_c, logits_h)]
        print(f"  twins' paged decoders, card against cpu: the same "
              f"{sum(map(len, toks_c))} greedy tokens; prefill logits max "
              f"|err| {max(errs):.3g} [{card}]")
    finally:
        servers.stop()
        for boot in boots:
            boot.shutdown()
        reset_client_rpc()


def swarm_lm_busy(run, card: str):
    """The trainer's card busy share over SWARM_LM_PROFILE_STEPS steps
    under ``torch.profiler`` (the servers' card work is in their own
    processes), with the kernels that take most of it; returns what
    ``run`` returned."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = run()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in rows)
    print(f"  trainer's card busy {busy:.3f} ms of {wall_ms:.3f} ms wall over "
          f"{SWARM_LM_PROFILE_STEPS} profiled steps, busy share "
          f"{busy / wall_ms:.4f}; top: " + "; ".join(
              f"{name[:50]} {ms:.3f} ms x{n}" for name, ms, n in rows[:6])
          + f" [{card}]")
    return out


def lah_top_once(boot, endpoints, card: str) -> None:
    """Phase 13's operator view: ``lah_top --once --json`` joined through
    the bootstrap DHT node must show one row per server process (its RPC
    endpoint) and a non-zero expert update count on each."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "learning_at_home_tpu_torch.tools.lah_top",
         "--once", "--json", "--initial-peers",
         f"{boot.endpoint[0]}:{boot.endpoint[1]}"],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    doc = json.loads(r.stdout.splitlines()[-1])
    rows = {tuple(p["snapshot"]["endpoint"]): p for p in doc["peers"]
            if p["role"] == "server" and p["snapshot"] is not None}
    assert set(rows) == {tuple(ep) for ep in endpoints}, (
        sorted(rows), endpoints)
    updates = {ep: sum(p["snapshot"]["experts"].values())
               for ep, p in sorted(rows.items())}
    print(f"  lah_top --once --json: {len(doc['peers'])} peers, one row per "
          f"server process ({len(rows)}), health "
          f"{sorted({p['health'] for p in rows.values()})}, expert updates "
          f"{', '.join(str(u) for u in updates.values())} "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    assert all(u > 0 for u in updates.values()), updates


def swarm_lm(counters, card: str, train: bool = True,
             arms: bool = True) -> tuple[dict, dict]:
    """Phase 13 (see the module docstring), then phase 15 on its servers
    and trained params and phase 16 (d); ``train=False`` brings the
    servers up and serves key-seeded params without training, and
    ``arms=False`` runs phase 16 (d) only.  Returns the kernels' launch
    counts of each phase's main path (phase 13's training steps, empty
    without training; phase 15's first gateway arm)."""
    t_phase = time.perf_counter()
    cfg = SwarmTransformerConfig(**SWARM_LM)
    n_experts = math.prod(cfg.grid_size)
    prefixes = [f"{cfg.uid_prefix}{i}" for i in range(cfg.n_layers)]
    boot = DHT()
    servers = SwarmServers(len(prefixes))
    dht = None
    try:
        for layer, prefix in enumerate(prefixes):
            servers.start(f"layer{layer}", grid_uids(prefix, cfg.grid_size),
                          cfg.d_model, boot.endpoint, "cuda",
                          SWARM_LM_SERVER)
        dht = DHT(initial_peers=[boot.endpoint])
        t0 = time.perf_counter()
        alive = wait_for_experts(dht, servers, prefixes,
                                 cfg.n_layers * n_experts,
                                 SWARM_LM_DISCOVERY_S)
        endpoints = sorted(set(alive.values()))
        print(f"  discovery: {len(alive)}/{cfg.n_layers * n_experts} experts "
              f"alive through the DHT on {len(endpoints)} servers, "
              f"{time.perf_counter() - t0:.1f} s after the trainer's DHT "
              f"node joined ({time.perf_counter() - t_phase:.1f} s after "
              f"the processes started) [{card}]")

        if not train:
            phase(f"gateway {SWARM_LM_NAME}")
            params = SwarmDMoETransformerLM(cfg, dht).init_params(
                prng.PRNGKey(SEED), device="cuda")
            return {}, serve_gateway(counters, card, dht, params, arms=arms)
        model = SwarmDMoETransformerLM(cfg, dht)
        hold_alive_sets(model, SWARM_LM_DISCOVERY_S)
        replies = [count_forward_replies(m) for m in model.moes]
        opt = optim.adamw(SWARM_LM_LR)
        run = {"params": model.init_params(prng.PRNGKey(SEED),
                                              device="cuda")}
        run["state"] = opt.init(run["params"])
        batches = LMBatcher(load_corpus(seed=SEED), SWARM_LM_BATCH,
                            cfg.seq_len, seed=SEED)
        tokens = SWARM_LM_BATCH * cfg.seq_len

        def steps(step_fn, n):
            """Losses, seconds and experts called (summed over the layers'
            last dispatches) of ``n`` steps."""
            losses, times, called = [], [], []
            for _ in range(n):
                servers.check()
                ids, tgt = next(batches)
                torch.cuda.synchronize()
                t = time.perf_counter()
                run["params"], run["state"], loss = step_fn(
                    run["params"], run["state"], ids, tgt)
                losses.append(float(loss))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                called.append(sum(len(m.selection_log[-1])
                                  for m in model.moes))
            assert all(math.isfinite(v) for v in losses), losses
            return losses, times, called

        def settled(*series):
            return all(
                len(v) >= SWARM_LM_SETTLE_STEPS and
                max(v[-SWARM_LM_SETTLE_STEPS:])
                <= (1 + SWARM_LM_SETTLE) * min(v[-SWARM_LM_SETTLE_STEPS:])
                for v in series)

        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        step = model.make_train_step(opt)
        rtw = runtime_totals(endpoints)
        warm, warm_t, warm_n = steps(step, 1)
        rt_first = runtime_totals(endpoints)
        print(f"  first warm-up step {warm_t[0]:.3f} s; its forward "
              f"dispatches by layer: " + ", ".join(
                  f"{m.dispatch_times[0]:.3f}" for m in model.moes)
              + f" s; the servers' Runtime: "
              f"{rt_first['jobs_processed'] - rtw['jobs_processed']:.0f} "
              f"jobs, device "
              f"{(rt_first['device_time_ms'] - rtw['device_time_ms']) / 1e3:.3f}"
              f" s (summed over servers)")
        # a step's time follows the experts it calls (each costs its
        # server a forward and a backward job), and the gate concentrates
        # as it trains; first use slows the first steps too: warm up until
        # the step's time and its experts called both hold still
        while len(warm_t) < SWARM_LM_WARMUP_MAX and \
                not settled(warm_t, warm_n):
            more, more_t, more_n = steps(step, 1)
            warm, warm_t, warm_n = warm + more, warm_t + more_t, warm_n + more_n
        print(f"  warm-up: {len(warm_t)} steps, s (experts called): "
              + ", ".join(f"{t:.3f} ({n})" for t, n in zip(warm_t, warm_n))
              + ("; settled" if settled(warm_t, warm_n) else
                 f"; not settled at the cap of {SWARM_LM_WARMUP_MAX}")
              + f" [{card}]")
        rt0, n0 = runtime_totals(endpoints), [len(m.dispatch_times)
                                              for m in model.moes]
        losses, times, called = steps(step, SWARM_LM_TIMED)
        rt1 = runtime_totals(endpoints)
        med = statistics.median(times)
        print(f"  make_train_step: {SWARM_LM_TIMED} steps median {med:.3f} s "
              f"({', '.join(f'{t:.3f}' for t in times)}), "
              f"{tokens / med:.1f} tokens/s; experts called a step "
              f"{', '.join(map(str, called))} of "
              f"{cfg.n_layers * n_experts} [{card}]")
        # where a timed step's wall goes: the trainer's waits on the forward
        # fan-outs (fire to join, summed over layers), the rest (backward
        # fan-outs and the trunk), and the servers' Runtime a step
        fwd = sum(sum(list(m.dispatch_times)[n:])
                  for m, n in zip(model.moes, n0)) / SWARM_LM_TIMED
        jobs = (rt1["jobs_processed"] - rt0["jobs_processed"]) / SWARM_LM_TIMED
        busy = {k: (rt1[k] - rt0[k]) / SWARM_LM_TIMED / 1e3
                for k in RUNTIME_KEYS[1:]}
        print(f"  a timed step: {statistics.mean(times):.3f} s mean = forward "
              f"dispatch waits {fwd:.3f} s + backward fan-outs and trunk "
              f"{statistics.mean(times) - fwd:.3f} s; the {len(endpoints)} "
              f"servers ran "
              f"{jobs:.0f} Runtime jobs a step: " + ", ".join(
                  f"{k[:-8]} {v:.3f} s" for k, v in busy.items())
              + f" (summed over servers) [{card}]")
        for overlap in (True, False):
            ol, ot, _ = steps(model.make_overlapped_train_step(
                opt, overlap=overlap), SWARM_LM_OVERLAP_STEPS)
            print(f"  make_overlapped_train_step(overlap={overlap}): "
                  f"{SWARM_LM_OVERLAP_STEPS} steps median "
                  f"{statistics.median(ot):.3f} s, "
                  f"{tokens / statistics.median(ot):.1f} tokens/s; losses "
                  f"{', '.join(f'{v:.4f}' for v in ol)} [{card}]")
        # one trainer thread sends each expert one backward RPC a step: a
        # straggler cancelled after the grace still updates its expert
        # (train_lm.py), so acked <= the servers' updates <= sent
        rpcs = backward_ledger(model, endpoints)
        print(f"  backward RPCs acked {rpcs[0]} <= servers' update_count "
              f"{rpcs[1]} <= sent {rpcs[2]} [{card}]")
        assert 0 < rpcs[0] <= rpcs[1] <= rpcs[2], rpcs
        trainer = PipelinedSwarmTrainer(model, opt, run["params"],
                                        run["state"], n_workers=2)
        summary = trainer.train(batches, steps=SWARM_LM_PIPELINED_STEPS,
                                tokens_per_batch=tokens)
        run["params"], run["state"], _ = trainer.snapshot()
        print(f"  PipelinedSwarmTrainer(n_workers=2): "
              f"{summary['steps']} steps in {summary['elapsed_s']:.3f} s, "
              f"{summary['tokens_per_sec']:.1f} tokens/s; losses "
              f"{', '.join(f'{v:.4f}' for v in trainer.losses)} [{card}]")
        counts = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        all_losses = warm + losses
        print(f"  loss {all_losses[0]:.5f} -> {all_losses[-1]:.5f} over "
              f"{len(all_losses)} make_train_step steps; last pipelined "
              f"{trainer.losses[-1]:.5f} [{card}]")
        assert statistics.mean(losses[-2:]) < warm[0], \
            f"the swarm LM's loss did not fall: {all_losses}"
        dispatch = sorted(model.moes[0].dispatch_times)
        print(f"  layer 0 dispatch p50 "
              f"{statistics.median(dispatch) * 1e3:.3f} ms over "
              f"{len(dispatch)} forward dispatches [{card}]")
        for i, (m, r) in enumerate(zip(model.moes, replies)):
            print(f"  layer {i} quorum drops: forward {r['dropped']}/"
                  f"{r['expected']} replies "
                  f"({r['dropped'] / max(r['expected'], 1):.4f}), backward "
                  f"{m.backward_rpcs_sent - m.backward_rpcs_ok}/"
                  f"{m.backward_rpcs_sent} RPCs ("
                  f"{1 - m.backward_rpcs_ok / max(m.backward_rpcs_sent, 1):.4f})"
                  f"; samples dropped {m.samples_dropped} forward, "
                  f"{m.backward_samples_dropped} backward; codecs "
                  f"{dict(sorted(m.codec_counts.items()))} [{card}]")

        _, prof_t, prof_n = swarm_lm_busy(
            lambda: steps(step, SWARM_LM_PROFILE_STEPS), card)
        print(f"  the profiled steps, s (experts called): " + ", ".join(
            f"{t:.3f} ({n})" for t, n in zip(prof_t, prof_n)) + f" [{card}]")

        # two workers' backward RPCs to one expert may share a batch (one
        # update): then only updates <= sent holds
        acked, updates, sent = (b - a for a, b in zip(
            rpcs, backward_ledger(model, endpoints)))
        print(f"  since then (the pipelined and profiled steps): acked "
              f"{acked}, servers' updates {updates} <= sent {sent} [{card}]")
        assert 0 < updates <= sent, (acked, updates, sent)
        lah_top_once(boot, endpoints, card)
        peaks = [st["metrics"]["collected"].get(
            "lah_server_device_peak_bytes", 0) for st in server_stats(endpoints)]
        print(f"  trainer peak card memory {peak / 1e9:.3f} GB; servers' "
              f"peak {', '.join(f'{b / 1e9:.3f}' for b in peaks)} GB "
              f"[{card}]")
        servers.check()
        print(f"swarm-lm phase: {time.perf_counter() - t_phase:.1f} s")
        phase(f"gateway {SWARM_LM_NAME}")
        gateway_counts = serve_gateway(counters, card, dht, run["params"])
        servers.check()
        return counts, gateway_counts
    finally:
        servers.stop()
        if dht is not None:
            dht.shutdown()
        boot.shutdown()
        reset_client_rpc()


# ---- phase 15: the serving gateway ----


def gateway_prompts() -> tuple[list, list]:
    """GATEWAY_STREAMS prompts of GATEWAY_PROMPT bytes of the synthetic
    corpus, every other one starting with the same GATEWAY_PREFIX bytes,
    and each stream's sampling (None: greedy)."""
    rs = np.random.RandomState(SEED + 15)
    corpus = load_corpus(seed=SEED)
    shared = corpus[:GATEWAY_PREFIX].tolist()
    prompts, sampling = [], []
    for i in range(GATEWAY_STREAMS):
        lo = GATEWAY_PREFIX + 1 if i % 2 == 0 else GATEWAY_PROMPT[0]
        n = int(rs.randint(lo, GATEWAY_PROMPT[1] + 1))
        start = int(rs.randint(GATEWAY_PREFIX, len(corpus) - n))
        body = corpus[start:start + n].tolist()
        prompts.append(shared + body[:n - GATEWAY_PREFIX] if i % 2 == 0
                       else body)
        sampling.append(SamplingParams(seed=SEED + 100 + i,
                                       **GATEWAY_SAMPLING)
                        if i in GATEWAY_SAMPLED else None)
    return prompts, sampling


class DecodeLog:
    """Wraps a gateway decoder's ``decode_step`` and ``verify_step``
    (called on the ``lah-gw-decode`` thread) to record each call's end
    time, the streams it advanced, the experts it called (the MoE layers'
    selection logs, summed over layers) and the pages in use after it;
    measurement only."""

    def __init__(self, decoder, moes) -> None:
        self.steps: list[tuple[float, list, int]] = []
        self.peak_pages = 0
        for name in ("decode_step", "verify_step"):
            setattr(decoder, name,
                    self._wrap(decoder, getattr(decoder, name), moes))

    def _wrap(self, dec, inner, moes):
        def run(*args):
            before = [len(m.selection_log) for m in moes]
            if args:  # verify_step's proposals: slot -> drafts
                sids = [dec.stream_ids[int(s)] for s in args[0]]
            else:
                sids = [sid for _, sid in dec.live_slots()]
            out = inner(*args)
            called = 0
            for m, n in zip(moes, before):
                new = list(m.selection_log)[n:]
                called += len(frozenset().union(*new)) if new else 0
            self.steps.append((time.perf_counter(), sids, called))
            if dec.kv is not None:
                self.peak_pages = max(self.peak_pages, dec.kv.pages_used())
            return out

        return run

    def inter_token_ms(self) -> list:
        """Each stream's intervals between the decode steps that gave it a
        token, ms (the first token comes from its prefill)."""
        last, out = {}, []
        for t, sids, _ in self.steps:
            for sid in sids:
                if sid in last:
                    out.append((t - last[sid]) * 1e3)
                last[sid] = t
        return out


def pcts(values) -> tuple[float, float]:
    """(p50, p95) of ``values``."""
    q = statistics.quantiles(values, n=100, method="inclusive")
    return q[49], q[94]


def gateway_arm(model, params, prompts, sampling, *, spec_k: int,
                chunk: int, card: str, profile: bool = False) -> dict:
    """Every prompt submitted at once through a ``GatewayClient`` to a
    fresh card ``Gateway`` (a shed is retried after its ``retry_after_s``)
    and polled until every stream is done; returns the tokens, the
    streams' times and the gateway's counters."""
    gw = Gateway(model, params, max_slots=GATEWAY_SLOTS, coalesce=True,
                 kv_layout="paged", page_len=GATEWAY_PAGE_LEN,
                 prefix_cache=True, prefill_chunk_tokens=chunk,
                 spec_k=spec_k, spec_drafter="ngram",
                 max_pending=GATEWAY_STREAMS, device="cuda")
    try:
        log = DecodeLog(gw.decoder, model.moes)
        client = GatewayClient(gw.endpoint)
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profile
            else contextlib.nullcontext())
        torch.cuda.synchronize()
        with prof:
            t0 = time.perf_counter()
            sids, sheds = [], 0
            for prompt, sp in zip(prompts, sampling):
                kw = {} if sp is None else dict(
                    seed=sp.seed, temperature=sp.temperature, top_p=sp.top_p,
                    top_k=sp.top_k)
                for _ in range(100):
                    sub = client.submit(prompt, GATEWAY_NEW, **kw)
                    if sub.get("accepted"):
                        break
                    sheds += 1
                    time.sleep(float(sub["retry_after_s"]))
                assert sub.get("accepted"), f"stream never admitted: {sub}"
                sids.append(sub["sid"])
            tokens = {sid: [] for sid in sids}
            open_sids = set(sids)
            t_end = time.perf_counter() + GATEWAY_DEADLINE_S
            while open_sids:
                assert time.perf_counter() < t_end, \
                    f"{len(open_sids)} streams unfinished at the deadline"
                for sid in sorted(open_sids):
                    out = client.poll(sid, len(tokens[sid]))
                    tokens[sid].extend(int(t) for t in out.get("tokens") or [])
                    if out.get("done"):
                        assert out.get("error") is None, out
                        open_sids.discard(sid)
                # the polls share the host with the decode thread: seldom
                # enough not to slow it (TTFT and inter-token times are
                # the scheduler's own, not the polls')
                time.sleep(GATEWAY_POLL_S)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        with gw.scheduler._lock:
            states = [gw.scheduler._streams[sid] for sid in sids]
        ttft = [(st.first_token_at - st.submitted_at) * 1e3 for st in states]
        span = (max(st.finished_at for st in states)
                - min(st.submitted_at for st in states))
        result = {
            "tokens": [tokens[sid] for sid in sids],
            "ttft_ms": ttft, "itl_ms": log.inter_token_ms(),
            "tokens_per_s": sum(len(t) for t in tokens.values()) / span,
            "experts": [n for _, _, n in log.steps],
            "steps": len(log.steps), "peak_pages": log.peak_pages,
            "sheds": sheds, "wall_s": wall,
            "stats": gw.gateway_stats(),
            "audit": gw.scheduler.audit() + gw.decoder.kv.audit(),
        }
        if profile:
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in rows) / 1e3
            result["busy"] = (busy, wall * 1e3)
        return result
    finally:
        gw.shutdown()


def reforward_chain(model, params, prompts, n: int) -> list:
    """Greedy tokens of full re-forwards through ``model.apply``, the
    streams batched with right padding (causal: a row's logits at its
    last position do not see the padding)."""
    seqs = [list(p) for p in prompts]
    out = [[] for _ in prompts]
    for _ in range(n):
        width = max(len(q) for q in seqs)
        ids = np.zeros((len(seqs), width), np.int64)
        for i, q in enumerate(seqs):
            ids[i, :len(q)] = q
        with torch.no_grad():
            logits = model.apply(params, torch.from_numpy(ids).cuda())
        for i, q in enumerate(seqs):
            tok = int(logits[i, len(q) - 1].argmax())
            out[i].append(tok)
            q.append(tok)
    return out


def check_row_invariance(dht, prefix: str, hidden: int, card: str) -> None:
    """One row through a card server of the swarm alone, then at the
    first, middle and last position of batches of 2..16 rows and of one
    row tile and 3: its output bits must not change (the coalescing
    contract rests on this)."""
    alive = client_loop().run(dht.get_alive_experts_fresh(prefix))
    uid = sorted(alive)[0]
    expert = RemoteExpert(uid, alive[uid])
    rs = np.random.RandomState(SEED)
    row = rs.randn(1, hidden).astype(np.float32)
    solo = expert.forward_blocking([row])[0][0]
    sizes = list(range(2, 17)) + [ROW_TILE["cuda"] + 3]
    for m in sizes:
        for pos in sorted({0, m // 2, m - 1}):
            batch = rs.randn(m, hidden).astype(np.float32)
            batch[pos] = row[0]
            out = expert.forward_blocking([batch])[0]
            assert np.array_equal(out[pos], solo), (uid, m, pos)
    print(f"  row invariance: one row of {uid} alone and in batches of "
          f"{sizes[0]}-{sizes[-2]} and {sizes[-1]} rows, the same bits "
          f"[{card}]")


def serve_gateway(counters, card: str, dht, params,
                  arms: bool = True) -> dict:
    """Phase 15 (see the module docstring) on phase 13's servers, found
    through ``dht``, then phase 16 (d) on a gateway of its own; returns
    the kernels' launch counts of phase 15's main path (the gateway's
    first arm).  ``arms=False`` runs phase 16 (d) only."""
    t_phase = time.perf_counter()
    model = SwarmDMoETransformerLM(SwarmTransformerConfig(**GATEWAY), dht)
    hold_alive_sets(model, SWARM_LM_DISCOVERY_S)
    if not arms:
        experiment_load(model, params, card)
        return {}
    check_row_invariance(dht, f"{model.cfg.uid_prefix}0", model.cfg.d_model,
                         card)
    prompts, sampling = gateway_prompts()
    greedy = [i for i, sp in enumerate(sampling) if sp is None]
    print(f"  {len(prompts)} streams ({len(greedy)} greedy, "
          f"{len(prompts) - len(greedy)} sampled at {GATEWAY_SAMPLING}), "
          f"prompts of {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"bytes, every other one sharing its first {GATEWAY_PREFIX}; "
          f"{GATEWAY_NEW} new tokens each; {GATEWAY_SLOTS} slots")
    # the reference: a bare dense decoder with ungrouped dispatches
    t0 = time.perf_counter()
    ref = []
    for i in range(0, len(prompts), GATEWAY_SLOTS):
        dec = SwarmKVDecoder(model, params, max_slots=GATEWAY_SLOTS,
                             device="cuda")
        ref += dec.generate(prompts[i:i + GATEWAY_SLOTS], GATEWAY_NEW,
                            sampling=sampling[i:i + GATEWAY_SLOTS])
    print(f"  bare dense ungrouped decoder: {time.perf_counter() - t0:.1f} s")

    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    main = gateway_arm(model, params, prompts, sampling, spec_k=0,
                       chunk=GATEWAY_CHUNK, card=card)
    counts = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    assert main["tokens"] == ref, [
        i for i, (a, b) in enumerate(zip(main["tokens"], ref)) if a != b]
    assert main["audit"] == [], main["audit"]
    st = main["stats"]
    ttft, itl = pcts(main["ttft_ms"]), pcts(main["itl_ms"])
    print(f"  gateway (paged, page_len {GATEWAY_PAGE_LEN}, prefix cache, "
          f"coalescing, prefill chunks of {GATEWAY_CHUNK}): TTFT p50 "
          f"{ttft[0]:.3f} ms p95 {ttft[1]:.3f} ms; inter-token p50 "
          f"{itl[0]:.3f} ms p95 {itl[1]:.3f} ms; {main['tokens_per_s']:.1f} "
          f"tokens/s over {len(prompts)} streams ({main['wall_s']:.2f} s, "
          f"{main['steps']} decode steps, {main['sheds']} sheds) [{card}]")
    print(f"  experts called a decode step ({len(model.moes)} layers): median "
          f"{statistics.median(main['experts']):.0f}, max "
          f"{max(main['experts'])}; group dispatches "
          f"{st['group_dispatches_total']}, coalesced dispatches avoided "
          f"{st['coalesced_dispatches_total']}; prefix-hit tokens "
          f"{st['prefix_hit_tokens_total']} ({st['prefix_hits_total']} hits),"
          f" peak pages {main['peak_pages']} of {st['kv_pages_total']}; "
          f"preemptions {st['preemptions_total']}; peak card memory "
          f"{peak / 1e9:.3f} GB [{card}]")
    assert st["coalesced_dispatches_total"] > 0, "nothing was coalesced"
    assert st["prefix_hit_tokens_total"] > 0, "no prefix hit"

    spec = gateway_arm(model, params, prompts, sampling,
                       spec_k=GATEWAY_SPEC_K, chunk=0, card=card,
                       profile=True)
    assert spec["tokens"] == main["tokens"], [
        i for i, (a, b) in enumerate(zip(spec["tokens"], main["tokens"]))
        if a != b]
    assert spec["audit"] == [], spec["audit"]
    sst = spec["stats"]
    busy, wall_ms = spec["busy"]
    print(f"  spec_k {GATEWAY_SPEC_K} (ngram drafter), prefill unchunked: "
          f"the same tokens for every stream; acceptance "
          f"{sst['spec_acceptance_rate']:.4f} ({sst['spec_accepted_total']}/"
          f"{sst['spec_proposed_total']} drafts), "
          f"{sst['spec_effective_k']:.3f} tokens a round over "
          f"{sst['spec_rounds_total']} rounds; under the profiler: card busy "
          f"{busy:.3f} ms of {wall_ms:.3f} ms wall, busy share "
          f"{busy / wall_ms:.4f} [{card}]")
    chain = reforward_chain(model, params,
                            [prompts[i] for i in greedy[:GATEWAY_REFORWARD]],
                            GATEWAY_REFORWARD_TOKENS)
    assert chain == [main["tokens"][i][:GATEWAY_REFORWARD_TOKENS]
                     for i in greedy[:GATEWAY_REFORWARD]]
    print(f"  {GATEWAY_REFORWARD} greedy streams' first "
          f"{GATEWAY_REFORWARD_TOKENS} tokens equal the re-forward argmax "
          f"chain through model.apply; launches on this path: {counts}")
    print(f"gateway phase: {time.perf_counter() - t_phase:.1f} s")
    experiment_load(model, params, card)
    return counts


def twin_decoders(model, params, dev: str) -> tuple[list, list]:
    """Greedy tokens of a paged card-or-CPU decoder on two prompts, and
    the logits behind each first token."""
    seen, inner = [], swarm_decoder.sample_token

    def record(logits, sp, position):
        seen.append(torch.as_tensor(logits).float().cpu())
        return inner(logits, sp, position)

    swarm_decoder.sample_token = record
    try:
        dec = SwarmKVDecoder(model, params, max_slots=2, device=dev,
                             kv_layout="paged", page_len=5)
        toks = dec.generate([[1, 2, 3, 4, 5, 6, 7], [200, 201, 202]], 16)
    finally:
        swarm_decoder.sample_token = inner
    return toks, seen[:2]


# ---- phase 16: the experiment drivers ----

def experiment_log(name: str) -> str:
    log_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "experiment_logs")
    os.makedirs(log_dir, exist_ok=True)
    return os.path.join(log_dir, f"{name}.log")


def run_twin(name: str, argv: list, timeout_s: float,
             env: dict | None = None) -> tuple[int, str]:
    """``python -m learning_at_home_tpu_torch.experiments.<name> argv``
    with its output in a log; (exit code, its output).  A run past
    ``timeout_s`` is killed and fails the phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    log = experiment_log(name)
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             f"learning_at_home_tpu_torch.experiments.{name}", *argv],
            cwd=root, env=dict(os.environ, PYTHONPATH=root, **(env or {})),
            stdout=out, stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            raise AssertionError(f"{name} ran past {timeout_s:.0f} s; "
                                 f"its log: {log}")
    with open(log, errors="replace") as f:
        return rc, f.read()


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


@contextlib.contextmanager
def twin_stdout(name: str):
    """An in-process twin's own output (its JSON lines, a generated
    completion) goes to its log, not to this script's output."""
    with open(experiment_log(name), "w") as out, \
            contextlib.redirect_stdout(out):
        yield


class TimedUpdates:
    """Wraps an optimizer factory so that each ``update`` is timed (host
    clock between two synchronizes) and its last inputs are kept for a
    later comparison; measurement only."""

    def __init__(self, make):
        self.make, self.times, self.last = make, [], None

    def __call__(self, *args, **kwargs):
        inner = self.make(*args, **kwargs)

        def update(grads, state, params=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner.update(grads, state, params)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            self.last = (grads, params)
            return out

        return optim.GradientTransformation(inner.init, update)


def optimizer_ms(make, grads, params) -> list:
    """Host-clock ms of ``EXP_OPT_REPS`` updates of a fresh optimizer on
    the same gradients and params, after one warm-up update."""
    opt = make(1e-3)
    state = opt.init(params)
    opt.update(grads, state, params)
    out = []
    for _ in range(EXP_OPT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.update(grads, state, params)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def experiment_pod_train(counters, card: str) -> dict:
    """Phase 16 (a): ``train_lm --mode pod`` in this process; returns its
    launch counts."""
    t0 = time.perf_counter()
    timed_chain = TimedUpdates(optim.adafactor)
    optim.adafactor = timed_chain
    try:
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        with twin_stdout("train_lm_pod"):
            out = train_lm.main(EXP_POD)
        counts = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
    finally:
        optim.adafactor = timed_chain.make
    losses = out["losses"]
    assert len(losses) == EXP_POD_STEPS and all(
        math.isfinite(v) for v in losses), losses
    for name in ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq"):
        assert counts[name] == 4 * EXP_POD_STEPS, counts  # 4 layers, no remat
    steps = np.diff(out["wall_s"])  # the steps after the first
    step_s = float(np.median(steps))
    tokens = 4 * 8192
    print(f"  train_lm --mode pod (d 512, 4 layers, 256 experts, seq 8192, "
          f"batch 4, bf16 params, optax adafactor): losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; first step "
          f"{out['wall_s'][0]:.3f} s, then median {step_s:.3f} s "
          f"({', '.join(f'{v:.3f}' for v in steps)}), {tokens / step_s:.1f} "
          f"tokens/s; peak card memory {peak / 1e9:.3f} GB; launches "
          f"{counts} [{card}]")
    chain_in_run = [t * 1e3 for t in timed_chain.times]
    grads, params = timed_chain.last
    chain = optimizer_ms(optim.adafactor, grads, params)
    fused = optimizer_ms(fused_adafactor, grads, params)
    print(f"  its optimizer update (optax's Adafactor chain, plain PyTorch): "
          f"in the run {', '.join(f'{v:.3f}' for v in chain_in_run)} ms; on "
          f"the last step's gradients, chain "
          f"{', '.join(f'{v:.3f}' for v in chain)} ms against the fused "
          f"Adafactor's {', '.join(f'{v:.3f}' for v in fused)} ms (host "
          f"clock between synchronizes) [{card}]")
    del grads, params, timed_chain
    print(f"experiments (a): {time.perf_counter() - t0:.1f} s")
    return counts


def experiment_pod_generate(counters, card: str) -> dict:
    """Phase 16 (b): ``generate_lm`` in this process, once with
    ``--bench 64`` and once with 1 new token (the prefill); returns the
    launch counts of both."""
    t0 = time.perf_counter()
    prompt = bytes(load_corpus(seed=SEED)[:EXP_GEN_PROMPT].astype(
        np.uint8)).decode("ascii")
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    with twin_stdout("generate_lm"):
        full = generate_lm.main(EXP_GEN + ["--prompt", prompt, "--bench",
                                           str(EXP_GEN_BENCH)])
        one = generate_lm.main(EXP_GEN + ["--prompt", prompt,
                                          "--max-new-tokens", "1",
                                          "--bench", "1"])
    counts = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    # 3 generates a run (the completion, the warm-up, the timed one), each
    # prefilling 4 layers through the flash kernel (phase 5: 4 a generate)
    assert counts["flash_attn_fwd"] == 2 * 3 * 4, counts
    assert full["tokens"].shape == (1, EXP_GEN_PROMPT + 64)
    prefill_ms = one["bench_s"] * 1e3
    decode_ms = (full["bench_s"] - one["bench_s"]) * 1e3 / (EXP_GEN_BENCH - 1)
    print(f"  generate_lm (the same widths, f32 params, seq 8192, a "
          f"{EXP_GEN_PROMPT}-byte prompt): --bench {EXP_GEN_BENCH} "
          f"{full['bench_s'] * 1e3:.3f} ms; prefill and first token "
          f"{prefill_ms:.3f} ms; decode {decode_ms:.3f} ms/token; peak card "
          f"memory {peak / 1e9:.3f} GB; launches {counts} [{card}]")
    print(f"experiments (b): {time.perf_counter() - t0:.1f} s")
    return counts


def experiment_swarm_train(card: str) -> None:
    """Phase 16 (c): ``train_lm --mode swarm --subprocess-servers`` as a
    process of its own, its servers on the card."""
    t0 = time.perf_counter()
    assert find_orphan_servers() == [], find_orphan_servers()
    threads = str(max(1, (os.cpu_count() or 1) // 4))
    rc, text = run_twin("train_lm", EXP_SWARM, EXP_SWARM_S,
                        env={"OMP_NUM_THREADS": threads})
    tail = "\n".join(text.splitlines()[-30:])
    assert rc == 0, f"train_lm --mode swarm exited with {rc}:\n{tail}"
    n = EXP_SWARM_LAYERS * 256
    assert f"# discovered {n}/{n} experts via DHT" in text, tail
    steps = [e for e in json_lines(text) if "step" in e]
    assert [e["step"] for e in steps] == list(range(EXP_SWARM_STEPS)), tail
    assert all(math.isfinite(e["loss"]) for e in steps), steps
    last = steps[-1]
    assert 0 < last["backward_rpcs_ok"] <= last["server_updates"] <= \
        last["backward_rpcs_sent"], last
    assert find_orphan_servers() == [], "a server outlived the run"
    # each line's tokens/s is cumulative since the first step began
    ends = [(e["step"] + 1) * 8 * 256 / e["tokens_per_sec"] for e in steps]
    step_s = [ends[0]] + list(np.diff(ends))
    print(f"  train_lm --mode swarm (config 3: d 512, {EXP_SWARM_LAYERS} "
          f"layers, 256 experts a layer on {EXP_SWARM_LAYERS} server "
          f"processes, seq 256, batch 8; OMP_NUM_THREADS={threads}): "
          f"{n}/{n} experts discovered; "
          f"losses {', '.join(str(e['loss']) for e in steps)}; step "
          f"seconds {', '.join(f'{v:.3f}' for v in step_s)} (the last "
          f"{8 * 256 / step_s[-1]:.1f} tokens/s); dispatch "
          f"p50 {last['dispatch_p50_ms']} ms; backward RPCs acked "
          f"{last['backward_rpcs_ok']} <= servers' updates "
          f"{last['server_updates']} <= sent {last['backward_rpcs_sent']}; "
          f"no server left [{card}]")
    print(f"experiments (c): {time.perf_counter() - t0:.1f} s")


def experiment_load(model, params, card: str) -> None:
    """Phase 16 (d): the loadgen twin's ``run_load`` against a gateway on
    phase 13's servers (phase 15's configuration)."""
    t0 = time.perf_counter()
    gw = Gateway(model, params, max_slots=GATEWAY_SLOTS, coalesce=True,
                 kv_layout="paged", page_len=GATEWAY_PAGE_LEN,
                 prefix_cache=True, prefill_chunk_tokens=GATEWAY_CHUNK,
                 device="cuda")
    try:
        report = loadgen.run_load(gw.endpoint, **EXP_LOAD)
    finally:
        gw.shutdown()
    floors = loadgen.check_floors(report)
    assert floors == [], (floors, report)
    print(f"  loadgen: Poisson {EXP_LOAD['rate_hz']} requests/s for "
          f"{EXP_LOAD['duration_s']} s (prompts 4-12, 8-16 new tokens): "
          f"{report['arrivals']} arrivals, {report['completed']} completed, "
          f"{report['shed']} shed, {report['errors']} errors, "
          f"{report['crashes']} crashes; TTFT p50 {report['ttft_p50_ms']} "
          f"p99 {report['ttft_p99_ms']} ms; ITL p50 {report['itl_p50_ms']} "
          f"p99 {report['itl_p99_ms']} ms; {report['tokens_per_sec']} "
          f"tokens/s; floors held [{card}]")
    print(f"experiments (d): {time.perf_counter() - t0:.1f} s")


def experiment_churn(card: str) -> None:
    """Phase 16 (e): ``churn_experiment --profile fast`` as a process of
    its own, its servers and trainer on the card; exit 0 under the SLO
    gate."""
    t0 = time.perf_counter()
    report = experiment_log("churn_report").replace(".log", ".json")
    rc, text = run_twin("churn_experiment",
                        EXP_CHURN + ["--report", report], EXP_CHURN_S)
    tail = "\n".join(text.splitlines()[-30:])
    assert rc == 0, f"churn_experiment exited with {rc}:\n{tail}"
    with open(report) as f:
        summary = json.load(f)
    assert summary["slo"]["pass"], summary
    assert find_orphan_servers() == [], "a server outlived the run"
    print(f"  churn_experiment --profile fast: SLO pass; throughput ratio "
          f"{summary['throughput_ratio']} (floor "
          f"{summary['slo']['throughput_floor']}), dispatch p99 "
          f"{summary['dispatch_p99_churn_ms']} ms (ceiling "
          f"{summary['slo']['p99_ceiling_ms']}), kills {summary['kills']}, "
          f"relaunches {summary['relaunches']}, quorum failures "
          f"{summary['quorum_failures']} ("
          f"{summary['quorum_failures_during_graceful_drains']} in graceful "
          f"windows) [{card}]")
    print(f"experiments (e): {time.perf_counter() - t0:.1f} s")


def experiment_throughput(card: str) -> None:
    """Phase 16 (f): ``benchmark_throughput`` in this process."""
    t0 = time.perf_counter()
    with twin_stdout("benchmark_throughput"):
        out = benchmark_throughput.main(EXP_THROUGHPUT)
    assert out["samples_per_sec"] > 0 and out["batches_formed"] > 0, out
    print(f"  benchmark_throughput (16 ffn experts at hidden 1024, 16 "
          f"clients x 50 requests of 16 rows, forward and backward): "
          f"{out['samples_per_sec']} samples/s, {out['requests_per_sec']} "
          f"requests/s; latency p50 {out['latency_ms']['p50']} ms p99 "
          f"{out['latency_ms']['p99']} ms; {out['batches_formed']} forward "
          f"batches of {out['avg_batch_rows']} rows [{card}]")
    print(f"experiments (f): {time.perf_counter() - t0:.1f} s")


def experiment_mnist(card: str) -> None:
    """Phase 16 (g): ``mnist_expert`` in this process."""
    t0 = time.perf_counter()
    with twin_stdout("mnist_expert"):
        out = mnist_expert.main(EXP_MNIST)
    losses, summary = out["losses"], out["summary"]
    assert statistics.mean(losses[-10:]) < losses[0], losses
    assert summary["updates_applied"] == 100, summary
    print(f"  mnist_expert (hidden 1024, batch 256, 100 steps): loss "
          f"{losses[0]:.4f} -> {abs(losses[-1]):.6f}; "
          f"{summary['steps_per_sec']} "
          f"steps/s; batch formation p50 "
          f"{summary['batch_formation_p50_ms']} ms; updates applied "
          f"{summary['updates_applied']} [{card}]")
    print(f"experiments (g): {time.perf_counter() - t0:.1f} s")


def experiments(counters, card: str) -> dict:
    """Phase 16 but (d), which runs on phase 15's gateway; returns the
    launch counts of (a) and (b)."""
    t0 = time.perf_counter()
    launches = {
        "train_lm --mode pod (4 steps)": experiment_pod_train(counters, card)}
    torch.cuda.empty_cache()
    launches["generate_lm (6 generates)"] = experiment_pod_generate(
        counters, card)
    torch.cuda.empty_cache()
    experiment_swarm_train(card)
    experiment_churn(card)
    experiment_throughput(card)
    experiment_mnist(card)
    print(f"experiments phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ---- phase 17: the pod tier on meshes of ranks ----


def mesh_counters() -> dict:
    """A rank's kernel launch counters (the wrappers' counts in its own
    process)."""
    return {"flash_attn_fwd": fa.flash_attention,
            "flash_attn_bwd_dkv": fa.flash_attention_dkv,
            "flash_attn_bwd_dq": fa.flash_attention_dq,
            "fused_ce_fwd": fce.ce_forward, "fused_ce_dx": fce.ce_dx,
            "fused_ce_dhead": fce.ce_dhead,
            "token_dispatch": td.dispatch_tokens_kernel}


def _rank_setup() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_T0 = time.perf_counter()


def _note(what: str) -> None:
    """A rank's progress line (the ranks share this script's output)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    print(f"  [rank {rank} +{time.perf_counter() - _T0:.1f} s] {what}",
          flush=True)


def mesh_batch(cfg, batch: int, seed: int, device):
    """train_batch's ids and targets, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    seq = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len + 1),
                        dtype=torch.int32, device=device, generator=gen)
    return seq[:, :-1].contiguous(), seq[:, 1:].contiguous()


def mesh_train(model, params, ids, tgt) -> dict:
    """flagship-8k-train's recipe on a mesh rank: a warm-up step, then
    MESH_STEPS steps with the counters reset just before them; the losses,
    step times, launches a step and peak memory."""
    counters = mesh_counters()
    optimizer = fused_adafactor(1e-3, mesh=model.mesh,
                                specs=model.param_specs(params))
    state = model.init_opt_state(optimizer, params)
    step = model.make_train_step(optimizer)
    ids, tgt = model.local_batch(ids), model.local_batch(tgt)
    (params, state, loss0, _), warm_s = timed(
        lambda: step(params, state, ids, tgt))
    _note(f"warm-up step {warm_s:.2f} s, loss {float(loss0):.5f}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    losses, step_ms = [], []
    for _ in range(MESH_STEPS):
        (params, state, loss, metrics), dt = timed(
            lambda: step(params, state, ids, tgt))
        losses.append(float(loss))
        step_ms.append(dt * 1e3)
        _note(f"step {dt:.2f} s, loss {losses[-1]:.5f}")
    launches = read_counts(counters)
    return {"loss0": float(loss0), "losses": losses, "step_ms": step_ms,
            "warm_ms": warm_s * 1e3, "launches": launches,
            "dropped": float(metrics["dropped_fraction"]),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "rows": ids.shape[0]}


def mesh_rank_nccl() -> dict:
    """(a) on the one rank: the loss and every gradient leaf of the mesh
    {"data": 1, "expert": 1} model against the single-device model
    (``mesh=None``) on the same weights and batch, bit for bit; then the
    recipe's steps on the rank's card."""
    _rank_setup()
    mesh = make_mesh({"data": 1, "expert": 1})
    cfg = DMoETransformerConfig(**FLAGSHIP_8K_TRAIN)
    single = DMoETransformerLM(cfg, device=mesh.device)
    meshed = DMoETransformerLM(cfg, mesh=mesh)
    params = meshed.init_params(prng.PRNGKey(SEED))
    ids, tgt = mesh_batch(cfg, TRAIN_8K_BATCH, SEED + 2, mesh.device)
    (l_single, _), g_single = single.value_and_grad(params, ids, tgt)
    (l_mesh, _), g_mesh = meshed.value_and_grad(params, ids, tgt)
    differ = [n for n, a, b in zip(leaf_paths(g_single),
                                   tree_leaves(g_single), tree_leaves(g_mesh))
              if not torch.equal(a, b)]
    same_loss = torch.equal(l_single, l_mesh)
    del g_single, g_mesh
    out = mesh_train(meshed, params, ids, tgt)
    out.update(backend=dist.get_backend(), device=str(mesh.device),
               same_loss=same_loss, differ=differ, loss=float(l_mesh))
    return out


def _slices(tree, model):
    """The rank's slices of a global tree of ``model``'s layout."""
    return tree_map(lambda t, spec: local_shard(t, spec, model.mesh),
                    tree, model.param_specs(tree))


def _rel_errors(got, want) -> dict:
    """{leaf: |got - want| / |want|} in norm, over this rank's leaves."""
    out = {}
    for name, a, b in zip(leaf_paths(want), tree_leaves(got),
                          tree_leaves(want)):
        nb = float(b.double().norm())
        out[name] = float((a.double() - b.double()).norm()) / nb if nb else (
            0.0 if not bool(a.any()) else math.inf)
    return out


class RoutedInOrder:
    """A MoE layer that routes the flattened tokens in another ``order``
    (capacity claims go in token order) and returns their outputs in the
    caller's."""

    def __init__(self, moe, order: torch.Tensor):
        self.moe, self.order = moe, order
        self.inverse = torch.argsort(order)

    def __call__(self, params, x, jitter_salt=0, token_mask=None):
        mask = None if token_mask is None else token_mask[self.order]
        y, aux = self.moe(params, x[self.order], jitter_salt=jitter_salt,
                          token_mask=mask)
        return y[self.inverse], aux

    def __getattr__(self, name):
        return getattr(self.moe, name)


def _global_grads_sliced(model, single, whole, ids, tgt):
    """The single-device model's loss, metrics and gradient (kept as the
    rank's slices of ``model``'s layout: a split leaf's slice is copied,
    so the rest is freed) on the global tree ``whole``."""
    (loss, metrics), grads = single.value_and_grad(whole, ids, tgt)
    grads = tree_map(lambda g, s: s if s.shape == g.shape else s.clone(),
                     grads, _slices(grads, model))
    return loss, metrics, grads


def mesh_check(mesh, cfg_mesh, cfg_single, whole, local, batch: int) -> dict:
    """The mesh model's loss and gradients on this rank (its params
    ``local``) against the single-device model's (``cfg_single``) on the
    global tree ``whole`` and the same batch: the rank compares its own
    slices.  With a zigzag layout the single device routes its tokens in
    the layout's order."""
    dev = mesh.device
    single = DMoETransformerLM(cfg_single, device=dev)
    meshed = DMoETransformerLM(cfg_mesh, mesh=mesh)
    if meshed._zig is not None:
        s = cfg_single.seq_len
        zig = torch.as_tensor(meshed._zig, device=dev)
        single.moe = RoutedInOrder(single.moe, torch.cat(
            [row * s + zig for row in range(batch)]))
    ids, tgt = mesh_batch(cfg_single, batch, SEED + 4, dev)
    l_single, m_single, g_single = _global_grads_sliced(
        meshed, single, whole, ids, tgt)
    _note(f"{mesh.shape}: the single-device model's value_and_grad done")
    (l_mesh, m_mesh), g_mesh = meshed.value_and_grad(
        local, meshed.local_batch(ids), meshed.local_batch(tgt))
    _note(f"{mesh.shape}: the mesh model's value_and_grad done")
    errors = _rel_errors(g_mesh, g_single)
    zero = [n for n, g in zip(leaf_paths(g_mesh), tree_leaves(g_mesh))
            if not bool(g.any())]
    return {"loss_single": float(l_single), "loss_mesh": float(l_mesh),
            "dropped": (float(m_single["dropped_fraction"]),
                        float(m_mesh["dropped_fraction"])),
            "errors": errors, "zero": zero}


def mesh_check_bf16(mesh, cfg, whole, local) -> dict:
    """(b)'s check in the recipe's bf16 compute (its fused CE, K1-K3 on
    each rank's row): the mesh model's gradients against the single
    device's, first with each side routing by itself (the gate choices
    that differ counted per layer), then with the single device replaying
    the ranks' routing, gathered from both ranks."""
    dev, n_layers = mesh.device, cfg.n_layers
    single = DMoETransformerLM(cfg, device=dev)
    meshed = DMoETransformerLM(cfg, mesh=mesh)
    ids, tgt = mesh_batch(cfg, 2, SEED + 4, dev)
    with routing_log() as (mesh_route, _):
        (l_mesh, _), g_mesh = meshed.value_and_grad(
            local, meshed.local_batch(ids), meshed.local_batch(tgt))
    # rank r routes row r's tokens; the single device's rows in rank order
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [i.cpu() for i in mesh_route])
    route = [torch.cat(calls).to(dev) for calls in zip(*per_rank)]
    _note("bf16: the mesh model's value_and_grad done")
    with routing_log() as (own_route, _):
        l_own, _, g_own = _global_grads_sliced(meshed, single, whole, ids,
                                               tgt)
    _note("bf16: the single device's own routing done")
    moved = [int((a != b).sum())
             for a, b in zip(route[:n_layers], own_route[:n_layers])]
    own = (_rel_errors(g_mesh, g_own), grad_agreement(g_mesh, g_own))
    del g_own
    with routing_log(replay=route) as (replayed, differ):
        l_pin, _, g_pin = _global_grads_sliced(meshed, single, whole, ids,
                                               tgt)
    assert len(replayed) == len(route), (len(replayed), len(route))
    pinned = (_rel_errors(g_mesh, g_pin), grad_agreement(g_mesh, g_pin))
    return {"loss_mesh": float(l_mesh), "loss_own": float(l_own),
            "loss_pinned": float(l_pin), "moved": moved,
            "differ": differ[:n_layers], "tokens": ids.numel() * cfg.k,
            "own": own, "pinned": pinned}


def mesh_rank_pair() -> dict:
    """(b) and (c) on one of two gloo ranks sharing the card.  The rank
    draws the global tree once (the single device's weights in every
    check) and its {"expert": 2} slices through the mesh model's
    init_params, which must equal the global tree's; the checks, then
    (b)'s steps once the global tree is freed."""
    _rank_setup()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cfg = DMoETransformerConfig(**MESH_PAIR)
    whole = DMoETransformerLM(cfg, device=dev).init_params(
        prng.PRNGKey(SEED))
    _note("the global tree drawn")
    mesh = make_mesh({"expert": 2}, device=dev)
    model = DMoETransformerLM(cfg, mesh=mesh)
    local = model.init_params(prng.PRNGKey(SEED))
    out = {"stage": mesh.stage, "init_same": all(
        torch.equal(a, b) for a, b in zip(tree_leaves(_slices(whole, model)),
                                          tree_leaves(local)))}
    _note("the global tree and the rank's slices drawn")
    # the checks at seq MESH_CHECK_SEQ: capacity factor E/k (no token
    # drops), aux weight 0 (the balance loss is the mean of the shards',
    # the JAX layer's pmean, not the whole batch's); the tree's pos rows
    # past the sequence get no gradient on either side
    check = dict(MESH_PAIR, seq_len=MESH_CHECK_SEQ,
                 aux_loss_weight=0.0, capacity_factor=cfg.num_experts / cfg.k)
    f32 = DMoETransformerConfig(**dict(check, dtype=torch.float32,
                                       ce_impl="chunked"))
    out["f32"] = mesh_check(mesh, f32, f32, whole, local, 2)
    out["bf16"] = mesh_check_bf16(mesh, DMoETransformerConfig(**check),
                                  whole, local)
    # (c): the CE takes the chunked path under a seq axis; the single
    # device's too (the fused kernels take bf16 operands)
    base = dict(MESH_PAIR, dtype=torch.float32, ce_impl="chunked")
    out["seq"] = mesh_check(
        make_mesh({"expert": 1, "seq": 2}, device=dev),
        DMoETransformerConfig(**dict(base, seq_parallel=True,
                                     seq_layout="zigzag")),
        DMoETransformerConfig(**dict(base, attn_impl="xla")), whole, whole, 1)
    del whole
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _note("checks done")
    ids, tgt = mesh_batch(cfg, TRAIN_8K_BATCH, SEED + 2, dev)
    out["train"] = mesh_train(model, local, ids, tgt)
    t2 = time.perf_counter()
    out["seconds"] = (t1 - t0, t2 - t1)
    return out


def _worst(errors: dict) -> tuple[str, float]:
    return max(errors.items(), key=lambda kv: kv[1])


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def report_mesh_bf16(rank: int, chk: dict) -> None:
    """(b)'s bf16 check on one rank: the routing choices that differ, and
    the gradients with each side's own routing and with one routing."""
    own_err, own_agree = chk["own"]
    pin_err, pin_agree = chk["pinned"]
    rel_own = _rel(chk["loss_mesh"], chk["loss_own"])
    rel_pin = _rel(chk["loss_mesh"], chk["loss_pinned"])
    lowest = min(own_agree.items(), key=lambda kv: kv[1][0])
    print(f"(b) rank {rank}, bf16 at seq {MESH_CHECK_SEQ}: loss "
          f"{chk['loss_mesh']:.6f} vs {chk['loss_own']:.6f} (rel "
          f"{rel_own:.2e}), {chk['loss_pinned']:.6f} replaying the ranks' "
          f"routing (rel {rel_pin:.2e}); routing choices (of "
          f"{chk['tokens']} a layer) that differ, mesh vs one device, per "
          f"layer: {chk['moved']}; the single device's own where it "
          f"replays: {chk['differ']}")
    print(f"(b) rank {rank}, bf16, own routing: worst leaf "
          f"{_worst(own_err)[0]} {_worst(own_err)[1]:.2e}; lowest cosine "
          f"{lowest[0]} {lowest[1][0]:.6f}")
    print(f"(b) rank {rank}, bf16, one routing: worst leaf "
          f"{_worst(pin_err)[0]} {_worst(pin_err)[1]:.2e}; lowest cosine "
          + ", ".join(f"{n} {c:.6f} {d:.1e}" for n, (c, d) in sorted(
              pin_agree.items(), key=lambda kv: kv[1][0])[:3]))
    assert max(rel_own, rel_pin) <= FLASH_LOSS_RTOL, (rel_own, rel_pin)
    for name, (cos, _) in own_agree.items():
        assert cos >= FLASH_GRAD_COSINE, f"mesh and one device {name}: {cos}"
    for name, (cos, dev) in pin_agree.items():
        assert cos >= ATTN_GRAD_COSINE and dev <= ATTN_GRAD_NORM_RTOL, \
            f"with one routing, mesh and one device {name}: {cos}, {dev}"


def mesh_phase(card: str) -> dict:
    """Phase 17; returns each arm's launches (summed over its ranks)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"this process holds {torch.cuda.memory_allocated() / 1e9:.2f} "
          "GB of the card while the ranks run")
    seq = FLAGSHIP_8K_TRAIN["seq_len"]

    def want(n_layers):
        """Phase 7's launches a step at ``n_layers`` layers (the flash
        forward twice a layer: the forward and remat's recompute)."""
        return {"flash_attn_fwd": 2 * n_layers,
                "flash_attn_bwd_dkv": n_layers, "flash_attn_bwd_dq": n_layers,
                "fused_ce_fwd": 1, "fused_ce_dx": 1, "fused_ce_dhead": 1,
                "token_dispatch": 0}

    def per_step(run):
        return {k: n / MESH_STEPS for k, n in run["launches"].items()}

    def report(label, run, n_layers):
        med = statistics.median(run["step_ms"])
        print(f"{label}: losses {[round(run['loss0'], 5)] + [round(x, 5) for x in run['losses']]}; "
              f"step ms {[round(x, 1) for x in run['step_ms']]} (median "
              f"{med:.1f}, warm-up {run['warm_ms']:.1f}); {run['rows']} rows "
              f"x {seq} a rank; dropped {run['dropped']:.4f}; peak "
              f"{run['peak_gb']:.2f} GB; launches a step {per_step(run)}")
        assert all(math.isfinite(x) for x in run["losses"]), run["losses"]
        assert run["losses"][-1] < run["loss0"], "the loss did not fall"
        assert per_step(run) == want(n_layers), (per_step(run),
                                                 want(n_layers))

    # the pair's processes start (imports, rendezvous) while (a) runs;
    # they touch the card only when called, after (a) has ended
    with RankGroup(2, backend="gloo", timeout_s=MESH_CALL_S,
                   wait=False) as pair_group:
        with RankGroup(1, backend="nccl", timeout_s=MESH_CALL_S) as group:
            a = group.run(mesh_rank_nccl)[0]
        print(f"(a) {a['backend']} rank on {a['device']}, mesh data 1 x "
              f"expert 1 against mesh=None, flagship-8k-train batch "
              f"{TRAIN_8K_BATCH}: loss {a['loss']:.6f} bit for bit "
              f"{a['same_loss']}; gradient leaves that differ: "
              f"{a['differ']}")
        assert a["backend"] == "nccl"
        assert a["same_loss"] and not a["differ"], \
            "mesh of one rank != mesh=None"
        report("(a) flagship-8k-train on the NCCL rank", a,
               FLAGSHIP_8K_TRAIN["n_layers"])
        t1 = time.perf_counter()
        pair = pair_group.run(mesh_rank_pair)
    for rank, out in enumerate(pair):
        chk = out["f32"]
        worst = _worst(chk["errors"])
        rel = _rel(chk["loss_mesh"], chk["loss_single"])
        print(f"(b) rank {rank} (gloo, staged through the host: "
              f"{out['stage']}): init slices bit for bit {out['init_same']}; "
              f"expert 2 against one device at seq {MESH_CHECK_SEQ} in f32, "
              f"capacity factor E/k, aux weight 0: loss "
              f"{chk['loss_mesh']:.6f} vs {chk['loss_single']:.6f} (rel "
              f"{rel:.2e}); dropped {chk['dropped']}; worst leaf {worst[0]} "
              f"{worst[1]:.2e}")
        assert out["init_same"], "a rank's init slices != the global draw's"
        assert chk["dropped"] == (0.0, 0.0), chk["dropped"]
        assert not chk["zero"], chk["zero"]
        assert rel <= MESH_LOSS_RTOL, rel
        assert worst[1] <= MESH_GRAD_RTOL, worst
        report_mesh_bf16(rank, out["bf16"])
        report(f"(b) rank {rank}, flagship-8k-train cut to "
               f"{MESH_PAIR['n_layers']} layers on expert 2", out["train"],
               MESH_PAIR["n_layers"])
        chk = out["seq"]
        worst = _worst(chk["errors"])
        rel = _rel(chk["loss_mesh"], chk["loss_single"])
        print(f"(c) rank {rank}, expert 1 x seq 2, the zigzag ring at seq "
              f"{seq} in f32 against plain attention on one device routing "
              f"in the zigzag order: loss {chk['loss_mesh']:.6f} vs "
              f"{chk['loss_single']:.6f} (rel {rel:.2e}); dropped "
              f"{chk['dropped']}; worst leaf {worst[0]} {worst[1]:.2e}")
        # the same tokens dropped on both sides: the same routing
        assert chk["dropped"][0] == chk["dropped"][1], chk["dropped"]
        assert not chk["zero"], chk["zero"]
        assert rel <= MESH_SEQ_LOSS_RTOL, rel
        assert worst[1] <= MESH_GRAD_RTOL, worst
    secs = [round(x, 1) for x in pair[0]["seconds"]]
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s ((a) {t1 - t0:.1f} "
          f"s; the pair {time.perf_counter() - t1:.1f} s, rank 0's draws and "
          f"checks, then its steps: {secs} s); {card}")

    def summed(runs):
        return {k: sum(r["launches"][k] for r in runs) for k in want(1)}

    return {
        f"mesh (a) nccl data 1 x expert 1 ({MESH_STEPS} steps)":
            a["launches"],
        f"mesh (b) gloo expert 2, both ranks ({MESH_STEPS} steps)":
            summed([o["train"] for o in pair]),
        "mesh (c) gloo expert 1 x seq 2 (one value_and_grad, not counted)":
            dict.fromkeys(want(1), 0),
    }


# ---- phase 18: sharded checkpoints and resume on a mesh ----


def host_leaves(params, opt_state) -> dict:
    """{"<item>/<i>": a host copy of the i-th leaf in the nest's order}:
    a rank's slices, or whole leaves cut to a rank's slices."""
    def copy(leaf):
        if torch.is_tensor(leaf):  # .cpu() copies a card tensor
            return tensor_to_numpy(leaf if leaf.is_cuda else leaf.clone())
        return np.array(leaf)

    return {f"{item}/{i}": copy(leaf)
            for item, tree in (("params", params), ("opt_state", opt_state))
            for i, leaf in enumerate(nested_flatten(tree))}


def leaf_digests(leaves: dict) -> dict:
    """{key: blake2b of the leaf's bytes} of :func:`host_leaves`' output,
    hashed on 8 threads (hashlib lets go of the GIL)."""
    def digest(arr):
        arr = np.ascontiguousarray(arr)
        return hashlib.blake2b(
            memoryview(arr.reshape(-1).view(np.uint8))).hexdigest()

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(leaves, pool.map(digest, leaves.values())))


def ckpt_rank_job(argv: list, digest_step: int | None) -> dict:
    """Phase 18 (a): one job's ``train_lm.main(argv)`` on this rank, the
    launch counters reset just before it.  Each save's and the resume's
    seconds (the checkpointer's own), and with ``digest_step`` the
    digests of the slices saved at that step."""
    from learning_at_home_tpu_torch.utils.checkpoint import TrainCheckpointer

    _rank_setup()
    counters = mesh_counters()
    saved, save_s, restore_s = {}, {}, []
    save, restore = TrainCheckpointer.save, TrainCheckpointer.restore_latest

    def measured_save(self, step, params, opt_state):
        t = time.perf_counter()
        save(self, step, params, opt_state)
        save_s[step] = time.perf_counter() - t
        if step == digest_step:  # host copies: the steps update in place
            saved.update(host_leaves(params, opt_state))

    def measured_restore(self, params, opt_state):
        t = time.perf_counter()
        out = restore(self, params, opt_state)
        restore_s.append(time.perf_counter() - t)
        return out

    TrainCheckpointer.save = measured_save
    TrainCheckpointer.restore_latest = measured_restore
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    try:
        out = train_lm.main(list(argv))
    finally:
        TrainCheckpointer.save = save
        TrainCheckpointer.restore_latest = restore
    return {**out, "launches": read_counts(counters),
            "digests": leaf_digests(saved), "save_s": save_s,
            "restore_s": restore_s[0] if restore_s else None,
            "rank": dist.get_rank(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def ckpt_gap_rank(argv: list) -> dict:
    """Phase 18 (c): ``decode_gap_eval.main(argv)`` on this rank."""
    _rank_setup()
    counters = mesh_counters()
    reset_counts(counters)
    t = time.perf_counter()
    out = decode_gap_eval.main(list(argv))
    return {"out": out, "s": time.perf_counter() - t,
            "launches": read_counts(counters)}


def start_sims() -> dict:
    """Phase 18 (d): the macro-sim entry points as processes of their
    own, started now; {module: (process, log path, start time)}."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for module, argv in CKPT_SIMS.items():
        log = experiment_log(module.replace(".", "_"))
        with open(log, "w") as out:
            procs[module] = (subprocess.Popen(
                [sys.executable, "-m", f"learning_at_home_tpu_torch.{module}",
                 *argv], cwd=root, env=dict(os.environ, PYTHONPATH=root),
                stdout=out, stderr=subprocess.STDOUT), log, time.time())
    return procs


def finish_sims(procs: dict, card: str) -> None:
    """Phase 18 (d)'s checks: dht_swarm_sim passes its floors; the
    runner's report is the JAX runner's bytes with its verdict.  A run's
    seconds end at its log's last write (its last line)."""
    deadline = time.time() + CKPT_SIM_S
    done = {}
    for module, (proc, log, t0) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for other in procs.values():
                other[0].kill()
            raise AssertionError(f"{module} ran past {CKPT_SIM_S:.0f} s; "
                                 f"its log: {log}")
        with open(log, errors="replace") as f:
            done[module] = (rc, f.read().splitlines(),
                            os.path.getmtime(log) - t0)
    rc, lines, secs = done["experiments.dht_swarm_sim"]
    size = json_lines("\n".join(lines))[0]
    argv = " ".join(CKPT_SIMS["experiments.dht_swarm_sim"])
    print(f"(d) dht_swarm_sim {argv}: exit {rc} in {secs:.1f} s (host, "
          f"beside (c) and (b)); join mean "
          f"{size['join']['mean_ms']} ms, heartbeat store-RPC reduction "
          f"{size['heartbeat']['reduction']}x, churn hit rate "
          f"{size['churn']['hit_rate']}, lookup p50/p99 "
          f"{size['churn']['lookup_p50_ms']}/{size['churn']['lookup_p99_ms']}"
          f" ms; rpcs {size['rpcs']}")
    assert rc == 0 and "DHT_SWARM_SIM_OK" in lines, lines[-5:]
    rc, lines, secs = done["sim.runner"]
    report = lines[0]
    digest = hashlib.sha256(report.encode()).hexdigest()
    fails = [line for line in lines if line.startswith("MACRO_SIM")]
    rep = json.loads(report)
    tr = rep["traffic"]
    print(f"(d) sim.runner {' '.join(CKPT_SIMS['sim.runner'])}: exit {rc} "
          f"in {secs:.1f} s (host, beside (c) and (b)), "
          f"{rep['virtual_duration_s']} "
          f"s virtual; arrivals {tr['arrivals']}, completed "
          f"{tr['completed']}, shed {tr['shed_fraction']}, TTFT p50/p99 "
          f"{tr['ttft_p50_ms']}/{tr['ttft_p99_ms']} ms, ITL p50/p99 "
          f"{tr['itl_p50_ms']}/{tr['itl_p99_ms']} ms, DHT hit rate "
          f"{rep['dht']['hit_rate']}; report sha256 {digest} (the JAX "
          f"runner's: {digest == MACRO_SIM_SHA256}); verdict {fails}")
    assert digest == MACRO_SIM_SHA256, report
    assert (rc, fails) == MACRO_SIM_VERDICT, (rc, fails)
    total = max(secs for _, _, secs in done.values())
    print(f"(d) the two sim runs, side by side: both done {total:.1f} s "
          f"after their start [{card}]")


def link_step(src: str, dst: str, step: int) -> None:
    """A root holding only ``src``'s step ``step`` (hard links)."""
    name = f"step_{step:09d}"
    for base, _, files in os.walk(os.path.join(src, name)):
        rel = os.path.relpath(base, src)
        os.makedirs(os.path.join(dst, rel), exist_ok=True)
        for f in files:
            os.link(os.path.join(base, f), os.path.join(dst, rel, f))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(base, f))
               for base, _, files in os.walk(path) for f in files)


def ckpt_phase(counters, card: str) -> dict:
    """Phase 18; returns the launches of (a) (both jobs, both ranks) and
    of (b)'s generate."""
    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase18")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    first, resumed, only = (os.path.join(root, name)
                            for name in ("first", "resumed", "only"))
    print(f"checkpoints under {root}: {shutil.disk_usage(root).free / 1e9:.1f}"
          " GB free")
    gc.collect()
    torch.cuda.empty_cache()
    steps = EXP_POD_STEPS
    want = {"flash_attn_fwd": CKPT_LAYERS, "flash_attn_bwd_dkv": CKPT_LAYERS,
            "flash_attn_bwd_dq": CKPT_LAYERS, "fused_ce_fwd": 0,
            "fused_ce_dx": 0, "fused_ce_dhead": 0,
            "token_dispatch": 0}  # a step, no remat
    # the second job's processes start (imports, rendezvous) while the
    # first job runs; they touch nothing of it and run only after it ends
    second = RankGroup(2, backend="gloo", timeout_s=CKPT_CALL_S, wait=False)
    with second:
        with RankGroup(2, backend="gloo", timeout_s=CKPT_CALL_S) as group:
            job1 = group.run(ckpt_rank_job,
                             CKPT_POD + ["--checkpoint-dir", first],
                             CKPT_EVERY)
        t1 = time.perf_counter()
        assert ckpt_io.list_steps(first) == [CKPT_EVERY, steps], \
            ckpt_io.list_steps(first, only_complete=False)
        link_step(first, resumed, CKPT_EVERY)
        link_step(first, only, CKPT_EVERY)
        job2 = second.run(ckpt_rank_job, CKPT_POD + [
            "--checkpoint-dir", resumed, "--resume"], None)
        t2 = time.perf_counter()
        # (d) on the host beside (c) and (b), not beside (a)'s ranks
        sims = start_sims()
        gap = second.run(ckpt_gap_rank, ["--steps", str(CKPT_GAP_STEPS)])
    t3 = time.perf_counter()
    saved = dir_bytes(os.path.join(first, f"step_{CKPT_EVERY:09d}"))
    for job, label, n_steps in ((job1, "first job", steps),
                                (job2, "resumed job", steps - CKPT_EVERY)):
        for out in job:
            per_step = {k: v / n_steps for k, v in out["launches"].items()}
            walls = out["wall_s"]
            restore = ("" if out["restore_s"] is None
                       else f"; restore {out['restore_s']:.3f} s")
            saves = {k: round(v, 3) for k, v in out["save_s"].items()}
            then = [round(float(x), 3) for x in np.diff(walls)]
            print(f"(a) {label}, rank {out['rank']}: losses "
                  f"{out['losses']}; step s: first {walls[0]:.3f}, then "
                  f"{then}; saves {saves} s{restore}; peak "
                  f"{out['peak_gb']:.2f} GB; launches a step {per_step}")
            assert len(out["losses"]) == n_steps and all(
                math.isfinite(v) for v in out["losses"]), out["losses"]
            assert per_step == want, (per_step, want)
    for job in (job1, job2):
        assert job[0]["losses"] == job[1]["losses"], "the ranks disagree"
    same = job2[0]["losses"] == job1[0]["losses"][CKPT_EVERY:]
    print(f"(a) resumed from step {CKPT_EVERY}: losses "
          f"{job2[0]['losses']} against the first job's "
          f"{job1[0]['losses'][CKPT_EVERY:]}: bit for bit {same}")
    assert same, "the resumed losses differ from the first job's"
    save_wall = max(out["save_s"][CKPT_EVERY] for out in job1)
    restore_wall = max(out["restore_s"] for out in job2)
    print(f"(a) a save writes {saved / 1e9:.3f} GB (both ranks' files): "
          f"{save_wall:.3f} s, {saved / save_wall / 1e6:.1f} MB/s; the "
          f"resume reads it in {restore_wall:.3f} s, "
          f"{saved / restore_wall / 1e6:.1f} MB/s; first job {t1 - t0:.1f} "
          f"s, resumed job {t2 - t1:.1f} s (process start and the init "
          f"draw included) [{card}]")

    # (b) the step restored without a mesh (whole leaves) onto one device,
    # then decoded from (a root holding only it)
    t = time.perf_counter()
    whole = {name: ckpt_io.restore_pytree(first, CKPT_EVERY, name)
             for name in ("params", "opt_state")}
    restore_host = time.perf_counter() - t
    on_card = nested_map(lambda a: numpy_to_tensor(a, "cuda"), whole)
    torch.cuda.synchronize()
    restore_one = time.perf_counter() - t
    del on_card
    axes = {"data": 1, "expert": 2}
    cfg = DMoETransformerConfig(vocab_size=VOCAB_SIZE, d_model=512,
                                n_layers=CKPT_LAYERS, seq_len=8192,
                                num_experts=256)
    for out in job1:
        layout = mesh_layout(axes, out["rank"])
        specs = DMoETransformerLM(cfg, device="cuda",
                                  mesh=layout).param_specs(whole["params"])
        state_specs = opt_state_shardings(whole["opt_state"], specs,
                                          whole["params"])
        got = leaf_digests(host_leaves(*(
            nested_map(lambda a, sp: local_shard(a, sp, layout), whole[item],
                       sp)
            for item, sp in (("params", specs), ("opt_state", state_specs)))))
        differ = sorted(k for k in out["digests"] if got.get(k) !=
                        out["digests"][k])
        print(f"(b) step {CKPT_EVERY} restored without a mesh "
              f"({restore_host:.3f} s; onto the card {restore_one:.3f} s), "
              f"cut to rank "
              f"{out['rank']}'s slices: {len(got)} leaves, {len(differ)} "
              f"differ from the rank's")
        assert sorted(got) == sorted(out["digests"]) and not differ, differ
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    prompt = bytes(load_corpus(seed=SEED)[:EXP_GEN_PROMPT].astype(
        np.uint8)).decode("ascii")
    reset_counts(counters)
    t = time.perf_counter()
    with twin_stdout("generate_lm_phase18"):
        gen = generate_lm.main(CKPT_GEN + ["--checkpoint-dir", only,
                                           "--prompt", prompt])
    gen_s = time.perf_counter() - t
    gen_counts = read_counts(counters)
    tokens = gen["tokens"]
    print(f"(b) generate_lm --checkpoint-dir (step {CKPT_EVERY}, written by "
          f"the two ranks) onto the single-device model: {tokens.shape[0]} x "
          f"{EXP_GEN_PROMPT}-byte prompts, {CKPT_GEN_NEW} greedy tokens "
          f"{tokens[0, EXP_GEN_PROMPT:].tolist()} in {gen_s:.1f} s (its "
          f"init draw and restore included); launches {gen_counts}")
    assert tokens.shape == (2, EXP_GEN_PROMPT + CKPT_GEN_NEW), tokens.shape
    assert (tokens[0] == tokens[1]).all() and (tokens < VOCAB_SIZE).all()
    # the layers' prefill
    assert gen_counts["flash_attn_fwd"] == CKPT_LAYERS, gen_counts

    # (c) decode_gap_eval on the expert mesh
    outs = [g["out"] for g in gap]
    print(f"(c) decode_gap_eval --steps {CKPT_GAP_STEPS} (cut from 150) on "
          f"{{'expert': 2}}: {outs[0]} in {gap[0]['s']:.1f} s; launches "
          f"{gap[0]['launches']} [{card}]")
    assert outs[0] == outs[1], outs
    assert set(outs[0]) == CKPT_GAP_KEYS, set(outs[0]) ^ CKPT_GAP_KEYS
    assert all(math.isfinite(outs[0][k]) for k in (
        "eval_ce_training_routing", "eval_ce_decode_fallback_routing",
        "control_topk_eval_ce")), outs[0]

    finish_sims(sims, card)
    shutil.rmtree(root, ignore_errors=True)
    print(f"checkpoint phase: {time.perf_counter() - t0:.1f} s ((a) "
          f"{t2 - t0:.1f}, (c) {t3 - t2:.1f}, (b) and (d)'s wait "
          f"{time.perf_counter() - t3:.1f}) [{card}]")

    def summed(runs):
        return {k: sum(r["launches"][k] for r in runs) for k in want}

    return {
        f"checkpoint (a) gloo data 1 x expert 2, both ranks ({steps} + "
        f"{steps - CKPT_EVERY} steps)": summed(job1 + job2),
        "checkpoint (b) generate_lm from the ranks' checkpoint": gen_counts,
    }


# ---- phase 19: the operator tools ----

TOOLS = "learning_at_home_tpu_torch.tools"
# the placement gate's skewed two-node fixture: two co-activation clusters
# split across the nodes and a slow measured link, so the solver must
# consolidate
PLACEMENT_FIXTURE = collect_gate._PLACEMENT_FIXTURE
TOOLS_TIMEOUT_S = 300  # each tool process; the phase takes ~40 s
WIRE_HANDLERS = 20  # (family, module, op) entries of the wire IR


def kernel_counters() -> dict:
    """Each wrapper's launch counter (the forward's lives on
    flash_attention)."""
    return {"flash_attn_fwd": fa.flash_attention,
            "flash_attn_bwd_dkv": fa.flash_attention_dkv,
            "flash_attn_bwd_dq": fa.flash_attention_dq,
            "fused_ce_fwd": fce.ce_forward, "fused_ce_dx": fce.ce_dx,
            "fused_ce_dhead": fce.ce_dhead,
            "token_dispatch": td.dispatch_tokens_kernel}


def fuzz_worker() -> None:
    """Phase 19 (c) in a process of its own, with the port's sanitizer
    armed (``LAH_SANITIZE=1`` in its environment): ``lah_fuzz --smoke``
    with the expert and gateway hosts on the card, then the same two
    families hosted on the CPU; prints one JSON line of the reports (each
    case's outcome in order) and this process's kernel launches."""
    from learning_at_home_tpu_torch.tools import lah_fuzz
    from learning_at_home_tpu_torch.utils import sanitizer

    assert sanitizer.enabled()
    counters = kernel_counters()
    reset_counts(counters)
    reports = {}
    run_family = lah_fuzz.run_family

    def kept(family, cases, verbose=False, device=None):
        t0 = time.perf_counter()
        rep = run_family(family, cases, verbose=verbose, device=device)
        rep["wall_s"] = time.perf_counter() - t0  # host up, frames, down
        reports[run].append(rep)
        return rep

    lah_fuzz.run_family = kept
    rcs = []
    with contextlib.redirect_stdout(sys.stderr):  # the CLIs' own lines
        for run, argv in (("card", ["--smoke"]),
                          ("cpu", ["--smoke", "--device", "cpu", *(
                              arg for fam in lah_fuzz.DEVICE_FAMILIES
                              for arg in ("--family", fam))])):
            reports[run] = []
            rcs.append(lah_fuzz.main(argv))
    print(json.dumps({"rc": rcs, "reports": reports,
                      "launches": read_counts(counters)}))


def tool_process(name: str, argv: list, env: dict | None = None):
    """``python argv`` from the checkout's root with its output in
    ``build/tools/<name>.out`` and ``.err``; (process, out path, err path,
    start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    out, err = (os.path.join(out_dir, f"{name}.{s}") for s in ("out", "err"))
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(
            [sys.executable, *argv], cwd=root, stdout=fo, stderr=fe,
            env=dict(os.environ, PYTHONPATH=root, **(env or {})))
    return proc, out, err, time.time()


def start_corpus() -> dict:
    """Phase 19 (e)'s two ``build_corpus`` runs, started now (the whole
    script starts them with phase 18, on the host beside its ranks)."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "tools")
    return {f"build_corpus {i}": tool_process(f"corpus{i}", [
        "-m", "learning_at_home_tpu_torch.experiments.build_corpus",
        "--out", os.path.join(out_dir, f"corpus{i}.txt")]) for i in (1, 2)}


def stop_tools(jobs: dict) -> None:
    """Kill whatever of the tool processes ``jobs`` still runs."""
    for proc, _, _, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def tool_results(jobs: dict) -> dict:
    """name -> (exit code, standard output, seconds from its start to its
    exit) of tool processes; one still running TOOLS_TIMEOUT_S after its
    start fails the phase."""
    ended = {}
    while len(ended) < len(jobs):
        for name, (proc, out, err, t0) in jobs.items():
            if name not in ended and proc.poll() is not None:
                ended[name] = time.time() - t0
        late = [n for n, job in jobs.items()
                if n not in ended and time.time() - job[3] > TOOLS_TIMEOUT_S]
        assert not late, f"{late} ran past {TOOLS_TIMEOUT_S} s"
        time.sleep(0.05)
    done = {}
    for name, (proc, out, err, _) in jobs.items():
        with open(out, errors="replace") as f:
            text = f.read()
        if proc.returncode != 0:
            with open(err, errors="replace") as f:
                print(f"  {name} exited {proc.returncode}; its errors:\n"
                      f"{f.read()[-4000:]}")
        done[name] = (proc.returncode, text, ended[name])
    return done


def tools_phase(counters, card: str, corpus: dict | None = None) -> dict:
    """Phase 19 (see the module docstring): every tool runs as a process
    of its own, all started together but ``corpus``, build_corpus's runs
    when :func:`start_corpus` started them earlier; returns the kernels'
    launch counts (this process's and the card fuzz worker's: none is
    expected)."""
    from learning_at_home_tpu_torch.analysis import schema
    from learning_at_home_tpu_torch.tools import lah_fuzz

    t_phase = time.time()
    reset_counts(counters)
    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    fixture = os.path.join(out_dir, "placement_fixture.json")
    with open(fixture, "w") as f:
        json.dump(PLACEMENT_FIXTURE, f)
    jobs = {
        **(corpus or start_corpus()),
        "lah_lint": tool_process("lint", ["-m", f"{TOOLS}.lah_lint",
                                          "--json"]),
        "lah_verify": tool_process("verify", [
            "-m", f"{TOOLS}.lah_verify", "--smoke", "--seeded-bugs",
            "--json"]),
        **{f"lah_rebalance --plan {i}": tool_process(f"plan{i}", [
            "-m", f"{TOOLS}.lah_rebalance", "--plan", fixture, "--seed",
            "0"]) for i in (1, 2)},
        "lah_fuzz": tool_process("fuzz", [
            "-c", "import chip_smoke; chip_smoke.fuzz_worker()"],
            env={"LAH_SANITIZE": "1"}),
    }
    try:
        # (a) the wire IR, here while the tools run
        t0 = time.time()
        ir = schema.extract([lah_fuzz.PKG])
        entries = {(h.family, os.path.basename(h.path), op)
                   for h in ir.handlers for op in h.ops}
        print(f"  (a) schema.extract over the port: {len(entries)} handler "
              f"(family, module, op) entries, {len(ir.senders)} sender "
              f"sites, {len(ir.unresolved)} unresolved "
              f"({time.time() - t0:.1f} s)")
        assert len(entries) == WIRE_HANDLERS and not ir.unresolved, entries
        done = tool_results(jobs)
    finally:
        stop_tools(jobs)

    rc, out, s = done["lah_lint"]
    findings = json.loads(out)
    active = [f for f in findings if not f["suppressed"]]
    print(f"  (a) lah_lint over the port: {len(active)} findings, "
          f"{len(findings) - len(active)} suppressed, exit {rc} ({s:.1f} s)")
    assert rc == 0 and not active, active

    rc, out, s = done["lah_verify"]
    report = json.loads(out)
    for w in report["worlds"]:
        print(f"      {w['world']:18s} {w['schedules_run']:4d} schedules "
              f"({w['schedules_pruned']} pruned), {w['violations']} "
              f"violation(s)")
    sb = report["seeded_bugs"]
    print(f"  (b) lah_verify --smoke --seeded-bugs: "
          f"{len(report['violations'])} violations across "
          f"{report['invariants_checked']} invariants; stale-prefill "
          f"{'FOUND' if sb['stale_prefill_found'] else 'MISSED'}, "
          f"mutual-preemption "
          f"{'FOUND' if sb['mutual_preemption_found'] else 'MISSED'}, "
          f"deterministic {sb['deterministic']}; exit {rc} ({s:.1f} s)")
    assert rc == 0 and report["clean"] and not report["violations"]
    assert sb["ok"] and sb["stale_prefill_found"] \
        and sb["mutual_preemption_found"], sb

    rc, out, s = done["lah_fuzz"]
    fuzz = json.loads(out.splitlines()[-1])
    assert fuzz["rc"] == [0, 0], fuzz["rc"]
    cpu = {rep["family"]: rep for rep in fuzz["reports"]["cpu"]}
    for rep in fuzz["reports"]["card"]:
        fam = rep["family"]
        print(f"  (c) lah_fuzz --smoke {fam}: {rep['frames']} frames, "
              f"{rep['outcomes']}, sanitizer "
              f"{rep['sanitizer_violations']}, host {rep['device']}, "
              f"{rep['frames'] / rep['wall_s']:.1f} frames/s "
              f"({rep['wall_s']:.3f} s with the host's start and stop) "
              f"[{card}]")
        assert not rep["failures"], rep["failures"]
        assert rep["frames"] >= lah_fuzz.MIN_PER_FAMILY
        assert rep["outcomes"]["noreply"] == 0
        assert rep["sanitizer_violations"] == 0 and not rep["quiesce_leaks"]
        if fam in lah_fuzz.DEVICE_FAMILIES:
            assert rep["device"].startswith("cuda"), rep["device"]
            assert cpu[fam]["device"] == "cpu" and not cpu[fam]["failures"]
            differ = [(a, b) for a, b in zip(rep["case_outcomes"],
                                             cpu[fam]["case_outcomes"])
                      if a != b]
            print(f"      {fam} on the card against the CPU host: "
                  f"{len(rep['case_outcomes']) - len(differ)} of "
                  f"{len(rep['case_outcomes'])} frames the same outcome")
            assert rep["case_outcomes"] == cpu[fam]["case_outcomes"], \
                differ[:5]
    assert {rep["family"] for rep in fuzz["reports"]["card"]} == set(
        lah_fuzz.HOSTS)
    print(f"      lah_fuzz worker: {s:.1f} s")

    plans = [done[f"lah_rebalance --plan {i}"] for i in (1, 2)]
    plan = json.loads(plans[0][1])
    print(f"  (d) lah_rebalance --plan: {len(plan['moves'])} moves, cost "
          f"{plan['cost_before']} -> {plan['cost_after']}; the two "
          f"processes' bytes "
          f"{'equal' if plans[0][1] == plans[1][1] else 'DIFFER'} "
          f"({max(p[2] for p in plans):.1f} s)")
    assert [p[0] for p in plans] == [0, 0] and plans[0][1] == plans[1][1]
    assert plan["moves"] and plan["cost_after"] < plan["cost_before"]

    runs = [done[f"build_corpus {i}"] for i in (1, 2)]
    digests = []
    for i in (1, 2):
        with open(os.path.join(out_dir, f"corpus{i}.txt"), "rb") as f:
            data = f.read()
        digests.append((hashlib.sha256(data).hexdigest(), len(data)))
    print(f"  (e) build_corpus twice: {runs[0][1].strip()}; sha256 "
          f"{digests[0][0]} and {digests[1][0]}, {digests[0][1]} bytes "
          f"({max(r[2] for r in runs):.1f} s)")
    assert [r[0] for r in runs] == [0, 0]
    assert digests[0] == digests[1] and digests[0][1] > 0

    launches = {k: v + fuzz["launches"][k]
                for k, v in read_counts(counters).items()}
    print(f"  kernel launches in phase 19: {launches}")
    print(f"tools phase: {time.time() - t_phase:.1f} s [{card}]")
    return {"operator tools (phase 19)": launches}


# ---- phase 20: the pre-test gate ----

# the gate's smokes whose servers, decoder or model sit on the card (the
# DHT sim, macro-sim and SLO churn smokes are phases 18 (d) and 16 (e),
# with the same tools)
GATE_SMOKES = ("client_path_smoke", "averaging_smoke", "codec_smoke",
               "telemetry_smoke", "replication_smoke", "overlap_smoke",
               "lifecycle_smoke", "gateway_smoke", "slo_trace_smoke")
GATE_DEVICE = "cuda:0"


class _Tee(io.TextIOBase):
    """Writes go to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


def gate_worker() -> None:
    """Phase 20 in a process of its own, with the port's sanitizer armed
    (``LAH_SANITIZE=1`` in its environment): the port gate's orphan guard,
    its collection stage and GATE_SMOKES on GATE_DEVICE, each step's
    output both captured and passed to standard error; prints one JSON
    line of the steps (exit code, seconds, output) and this process's
    kernel launches.  A smoke's failure raises out of the worker."""
    from learning_at_home_tpu_torch.utils import sanitizer

    assert sanitizer.enabled()
    counters = kernel_counters()
    reset_counts(counters)
    smokes = {fn.__name__: fn for _, fn in collect_gate.SMOKES}
    steps = [("orphan guard", collect_gate.orphan_guard, ()),
             ("collection", collect_gate.collection_stage, ()),
             *((name, smokes[name], (GATE_DEVICE,)) for name in GATE_SMOKES)]
    report = []
    for name, fn, args in steps:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee(buf, sys.stderr)):
            rc = fn(*args)
        report.append({"name": name, "rc": rc,
                       "seconds": time.perf_counter() - t0,
                       "out": buf.getvalue()})
        assert rc == 0, (name, rc)
    print(json.dumps({"steps": report, "launches": read_counts(counters)}))


def gate_phase(counters, card: str) -> dict:
    """Phase 20 (see the module docstring): the gate worker, then its
    steps' checks; returns the kernels' launch counts (this process's and
    the worker's: none is expected)."""
    t_phase = time.time()
    reset_counts(counters)
    jobs = {"gate": tool_process("gate", [
        "-c", "import chip_smoke; chip_smoke.gate_worker()"],
        env={"LAH_SANITIZE": "1"})}
    try:
        done = tool_results(jobs)
    finally:
        stop_tools(jobs)
    rc, out, s = done["gate"]
    assert rc == 0, f"the gate worker exited {rc}"
    rep = json.loads(out.splitlines()[-1])
    steps = {step["name"]: step for step in rep["steps"]}
    markers = {fn.__name__: m for m, fn in collect_gate.SMOKES}
    for step in rep["steps"]:
        lines = step["out"].splitlines()
        print(f"  {step['name']}: exit {step['rc']}, "
              f"{step['seconds']:.1f} s [{card}]")
        for line in lines:
            print(f"      {line}")
        assert step["rc"] == 0
        if step["name"] in markers:
            assert any(line.startswith(markers[step["name"]] + " ")
                       for line in lines), (step["name"], lines)
    assert steps["orphan guard"]["out"] == ""  # no port server left over
    collected = steps["collection"]["out"].splitlines()
    assert re.fullmatch(r"collect_gate: OK — \d+ tests collected in .*s",
                        collected[-1]), collected
    codec = re.findall(r"codec (\w+): bytes /([0-9.]+), grad_cosine "
                       r"([0-9.]+)", steps["codec_smoke"]["out"])
    assert [(c, r) for c, r, _ in codec] == [("u8", "4.00"),
                                             ("blockq8", "3.87")], codec
    assert all(float(cos) >= 0.99 for _, _, cos in codec)
    for name in GATE_SMOKES:
        assert f"on {GATE_DEVICE}" in steps[name]["out"], name
    for name in ("overlap_smoke", "gateway_smoke"):  # server processes
        peaks = re.search(
            r"card peak bytes \(stats\) \[([0-9.]+), ([0-9.]+)\]",
            steps[name]["out"])
        assert peaks and min(float(p) for p in peaks.groups()) > 0, \
            steps[name]["out"]
    launches = {k: v + rep["launches"][k]
                for k, v in read_counts(counters).items()}
    assert not any(launches.values()), launches
    print(f"  kernel launches in phase 20: {launches}")
    print(f"gate phase: {time.time() - t_phase:.1f} s (the worker "
          f"{s:.1f} s) [{card}]")
    return {"pre-test gate (phase 20)": launches}


# ---- phase 21: the profiling tools ----


def run_profile_step(argv: list) -> tuple[int, dict | None, str, str]:
    """``profile_step.main(argv)`` in this process: (exit code, its
    returned dict or None, its stdout, its stderr)."""
    out, err = io.StringIO(), io.StringIO()
    got, rc = None, 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            got = profile_step.main(argv)
        except SystemExit as exc:
            rc = exc.code
    return rc, got, out.getvalue(), err.getvalue()


def kernel_events(path: str) -> tuple[int, int]:
    """(events, CUDA kernel events) of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return len(events), sum(e.get("cat") == "kernel" for e in events)


def profile_rung(label: str, argv: list, counters, card: str) -> tuple:
    """One admitted profile_step variant: its JSON line and variant line
    printed, its estimate beside its measured peak; (its returned dict,
    its launch counts)."""
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    reset_counts(counters)
    rc, got, out, err = run_profile_step(argv)
    counts = read_counts(counters)
    assert rc == 0, (rc, err[-2000:])
    line = json.loads(out.strip().splitlines()[-1])
    assert {k: got[k] for k in line} == line
    assert {"mfu", "hbm_peak_gb"} <= set(line), line
    assert math.isfinite(line["loss"]) and line["step_ms"] > 0, line
    variant = [v for v in err.splitlines() if v.startswith("variant: ")]
    assert len(variant) == 1, err[-2000:]
    print(f"  {label}: profile_step {' '.join(argv)}")
    print(f"      {variant[0]}")
    print(f"      {json.dumps(line)}")
    est = got["est_peak_bytes"] / 1e9
    print(f"      estimate {est:.3f} GB against the measured peak "
          f"{line['hbm_peak_gb']} GB (ratio {line['hbm_peak_gb'] / est:.3f};"
          f" {base / 1e9:.3f} GB was allocated before the run); launches "
          f"{counts}; {time.perf_counter() - t0:.1f} s [{card}]")
    return got, counts


def profile_phase(counters, card: str) -> dict:
    """Phase 21 (see the module docstring); returns the launch counts of
    (a) and (b) (K5's alone)."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as trace_dir:
        a, counts_a = profile_rung("(a) the bench recipe",
                                   PROFILE_A + ["--trace", trace_dir],
                                   counters, card)
        n_events, n_kernels = kernel_events(a["trace_file"])
        size = os.path.getsize(a["trace_file"])
    assert n_kernels > 0, (n_events, n_kernels)
    print(f"      trace of {PROFILE_TRACE_STEPS} steps: {n_events} events, "
          f"{n_kernels} CUDA kernel events, {size / 1e6:.1f} MB")
    torch.cuda.empty_cache()
    b, counts_b = profile_rung("(b) remat dots", PROFILE_B, counters, card)
    torch.cuda.empty_cache()

    base = torch.cuda.memory_allocated()
    rc, got, out, err = run_profile_step(PROFILE_REFUSED)
    after = torch.cuda.memory_allocated()
    assert rc == 2 and got is None and out == "", (rc, out, err[-2000:])
    assert err.startswith("REFUSED: "), err[-2000:]
    assert after == base, (base, after)
    print(f"  (c) profile_step {' '.join(PROFILE_REFUSED)}: exit {rc}; "
          f"{err.strip()}; card bytes allocated {base} before, {after} "
          f"after [{card}]")

    kind = torch.cuda.get_device_name(0)
    argv = ["--step-ms", repr(a["step_ms"])]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        roofline.main(argv)
    lines = text.getvalue().splitlines()
    assert len(lines) == 12 and lines[-3].startswith(
        f"decomposition of the measured {a['step_ms']:g} ms"), lines
    print(f"  (d) roofline {' '.join(argv)} on the constants of '{kind}':")
    for line in lines:
        print(f"      {line}")

    launches = {
        f"profile_step (a) bench recipe ({1 + PROFILE_STEPS} + "
        f"{PROFILE_TRACE_STEPS} traced steps)": counts_a,
        f"profile_step (b) remat dots ({1 + PROFILE_STEPS} steps)": counts_b}
    # K5 a step: the forward in each layer and its remat recompute, dkv
    # and dq in each layer; no other kernel (the chunked CE)
    layers = sizing.flagship_config().n_layers
    for counts, steps in ((counts_a, 1 + PROFILE_STEPS + PROFILE_TRACE_STEPS),
                          (counts_b, 1 + PROFILE_STEPS)):
        want = {**dict.fromkeys(counts, 0),
                "flash_attn_fwd": 2 * layers * steps,
                "flash_attn_bwd_dkv": layers * steps,
                "flash_attn_bwd_dq": layers * steps}
        assert counts == want, (counts, want)
    print(f"profiling phase: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


# ---- phase 14: the elastic swarm ----


def rpc(ep, op: str, meta: dict, timeout: float = 60.0):
    """One RPC's reply meta."""
    return client_loop().run(pool_registry().get(ep).rpc(
        op, (), meta, timeout=timeout))[1]


def metrics_endpoints(dht, want: int, servers: SwarmServers,
                      deadline_s: float = 120.0) -> dict:
    """RPC endpoint -> metrics endpoint of the servers advertised under
    ``telemetry.swarm`` (their peer id names the RPC endpoint)."""
    t_end = time.perf_counter() + deadline_s
    while True:
        servers.check()
        found = {}
        for peer, rec in telemetry.discover_telemetry(dht).items():
            if peer.startswith("server-") and rec["role"] == "server":
                host, _, port = peer[len("server-"):].rpartition(":")
                found[(host, int(port))] = tuple(rec["endpoint"])
        if len(found) >= want or time.perf_counter() > t_end:
            break
        time.sleep(0.5)
    assert len(found) >= want, f"{len(found)} of {want} servers advertised"
    return found


def server_doc(metrics_ep) -> dict:
    """A server's ``/metrics.json`` (its per-expert update counts and
    replica sync stats)."""
    doc = telemetry.fetch_json(metrics_ep, timeout=30.0)
    assert doc is not None, f"no /metrics.json from {metrics_ep}"
    return doc


def wait_until(pred, what: str, deadline_s: float, servers: SwarmServers):
    t_end = time.perf_counter() + deadline_s
    while True:
        servers.check()
        got = pred()
        if got:
            return got
        assert time.perf_counter() < t_end, f"timed out: {what}"
        time.sleep(0.5)


def expert_manifest(uid_or_seed, hidden: int, device: str) -> list:
    """The manifest of a fresh ffn expert with adam's state, drawn on
    ``device`` (a uid: its crc32 key; an int: PRNGKey(seed))."""
    key = (uid_key(uid_or_seed) if isinstance(uid_or_seed, str)
           else prng.PRNGKey(uid_or_seed))
    apply_fn, params = make_expert("ffn", hidden, key, device=device)
    backend = ExpertBackend("x", apply_fn, params, optim.adam(SWARM_LM_LR),
                            device=device)
    return lifecycle.flatten_state(backend.state_dict())[1]


def elastic_init_check(uids: list, replicas: list, hidden: int,
                       card: str) -> None:
    """Step 5: card against CPU draws, and one expert's init time."""
    for subject in (uids[-1], replicas[0], 0):
        on_card = expert_manifest(subject, hidden, "cuda")
        on_cpu = expert_manifest(subject, hidden, "cpu")
        assert on_card == on_cpu, f"card and CPU draws of {subject!r} differ"
    times = {}
    for dev in ("cuda", "cpu"):
        ts = []
        for i in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            make_expert("ffn", hidden, uid_key(uids[i]), device=dev)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        times[dev] = statistics.median(ts[1:]) * 1e3
    print(f"  card against CPU: the fresh experts {uids[-1]!r}, "
          f"{replicas[0]!r} (crc32 keys) and PRNGKey(0) drawn on the card "
          f"give the CPU draws' manifest crcs (0 ulp, bar 2); one expert's "
          f"init at hidden {hidden}: card {times['cuda']:.3f} ms, CPU "
          f"{times['cpu']:.3f} ms (median of 4) [{card}]")


def in_threads(fns, what: str, timeout: float) -> None:
    """Run ``fns`` at once, one thread each; re-raise the first failure."""
    errors = []

    def run(fn):
        try:
            fn()
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,), daemon=True)
               for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), f"{what} hung"
    if errors:
        raise errors[0]


def check_group_mean(trainers, snaps) -> int:
    """Each trainer's params after its background round against the mean
    of the round's two snapshots: no step ran after the snapshots, so the
    delta ``cur + (mean - snap)`` is the mean up to its two roundings
    (ELASTIC_AVG_ULPS f32 ulp of the larger of |mean| and |snap|).
    Returns the elements checked."""
    means = tree_map(lambda a, b: (a + b) / 2, snaps[0], snaps[1])
    n = 0
    for trainer, snap in zip(trainers, snaps):
        for got, mean, own in zip(tree_leaves(trainer.snapshot()[0]),
                                  tree_leaves(means), tree_leaves(snap)):
            assert got.device.type == "cuda"
            bar = (ELASTIC_AVG_ULPS * torch.finfo(torch.float32).eps
                   * torch.maximum(mean.abs(), own.abs()))
            bad = (got - mean).abs() > bar
            assert not bool(bad.any()), (
                f"a trainer's param is {float((got - mean).abs().max())} "
                f"off the group mean (bar {ELASTIC_AVG_ULPS} ulp)")
            n += got.numel()
    return n


def elastic(counters, card: str) -> dict:
    """Phase 14 (see the module docstring).  Returns the kernels' launch
    counts of its main path (the trainers' steps, the averaging round,
    the replicas, the migration and the drain)."""
    t_phase = time.perf_counter()
    cfg = SwarmTransformerConfig(**ELASTIC)
    prefix = f"{cfg.uid_prefix}0"
    uids = grid_uids(prefix, cfg.grid_size)
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", "elastic_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    boot = DHT()
    servers = SwarmServers(3)
    nodes, sessions = [], []
    try:
        servers.start("elastic-A", uids, cfg.d_model, boot.endpoint, "cuda",
                      ELASTIC_SERVER + ["--warmup", "--checkpoint-dir", ckpt])
        servers.start("elastic-B", None, cfg.d_model, boot.endpoint, "cuda",
                      ELASTIC_SERVER + ["--num-experts", "0",
                                        "--transport", "native"])
        servers.start("elastic-C", None, cfg.d_model, boot.endpoint, "cuda",
                      ELASTIC_SERVER + ["--num-experts", "0"])
        nodes = [DHT(initial_peers=[boot.endpoint]) for _ in range(2)]
        alive = wait_for_experts(nodes[0], servers, [prefix], len(uids),
                                 SWARM_LM_DISCOVERY_S)
        ep_a = next(iter(set(alive.values())))
        metrics = metrics_endpoints(nodes[0], 3, servers)
        empty = [ep for ep in metrics if ep != ep_a]
        native = [ep for ep in empty if "lah_server_native_frames_in_total"
                  in rpc(ep, "stats", {})["metrics"]["collected"]]
        assert len(native) == 1, native
        ep_b = native[0]
        ep_c = next(ep for ep in empty if ep != ep_b)
        print(f"  {len(alive)} experts alive on A {ep_a}; B {ep_b} "
              f"(native), C {ep_c} empty; "
              f"{time.perf_counter() - t_phase:.1f} s after the processes "
              f"started [{card}]")

        models = [SwarmDMoETransformerLM(cfg, node) for node in nodes]
        for m in models:
            m.moes[0].alive_cache.ttl = ELASTIC_ALIVE_TTL
        replies = [count_forward_replies(m.moes[0]) for m in models]
        opt = optim.adamw(SWARM_LM_LR)
        corpus = load_corpus(seed=SEED)
        batchers = [LMBatcher(corpus, SWARM_LM_BATCH, cfg.seq_len,
                              seed=SEED + i) for i in range(2)]
        tokens = SWARM_LM_BATCH * cfg.seq_len
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()

        # (1) averaging: two trainers at once, each session starting its
        # background round from notify_step after ELASTIC_AVG_STEPS steps
        trainers = [PipelinedSwarmTrainer(
            m, opt, m.init_params(prng.PRNGKey(SEED + i), device="cuda"),
            n_workers=1)
            for i, m in enumerate(models)]
        for node, trainer in zip(nodes, trainers):
            session = AveragingSession(DecentralizedAverager(
                node, AveragingConfig(
                    prefix="averaging.elastic", min_group_size=2,
                    max_group_size=2, matchmaking_timeout=ELASTIC_MATCH_S)),
                every_steps=ELASTIC_AVG_STEPS)
            trainer.attach_averaging(session)
            sessions.append(session)
        snaps = [None, None]

        def steps_then_round(i):
            def on_log(entry):
                # the last step's params, read before its notify_step
                # starts the round: what the round snapshots
                if entry["step"] == ELASTIC_AVG_STEPS:
                    snaps[i] = trainers[i].snapshot()[0]

            trainers[i].train(batchers[i], steps=ELASTIC_AVG_STEPS,
                              log_every=ELASTIC_AVG_STEPS, on_log=on_log,
                              tokens_per_batch=tokens)
            assert sessions[i].wait_idle(timeout=2 * ELASTIC_MATCH_S), \
                "the background averaging round did not end"

        in_threads([lambda i=i: steps_then_round(i) for i in range(2)],
                   "the trainers' steps and averaging round",
                   4 * ELASTIC_MATCH_S)
        servers.check()
        stats = [t.averaging_stats() for t in trainers]
        assert all(st["group_size_last"] == 2 and st["rounds_applied"] == 1
                   for st in stats), stats
        n_avg = check_group_mean(trainers, snaps)
        for session in sessions:
            # trainer 1 steps no more: a lone round of trainer 0 would hold
            # its DHT node in matchmaking through the drain (PERF.md §7)
            session.every_steps = 10 ** 9
        print(f"  averaging: {ELASTIC_AVG_STEPS} steps each (last losses "
              + ", ".join(f"{t.losses[-1]:.4f}" for t in trainers)
              + f"), then one background round each from notify_step, "
              f"group of {stats[0]['group_size_last']}; {n_avg} trunk and "
              f"gate elements on the card within {ELASTIC_AVG_ULPS} ulp of "
              f"the snapshots' mean after the delta; round "
              f"{stats[0]['round_p50_ms']:.3f} / {stats[1]['round_p50_ms']:.3f}"
              f" ms, bytes sent {stats[0]['bytes_sent']} / "
              f"{stats[1]['bytes_sent']}, received "
              f"{stats[0]['bytes_received']} / {stats[1]['bytes_received']}"
              f" [{card}]")

        # (2) synced replicas on B and C of the experts A updated most
        counts_a = server_doc(metrics[ep_a])["experts"]
        hot = sorted(counts_a, key=lambda u: (-counts_a[u], u))[
            :ELASTIC_REPLICAS]
        t_rep = time.perf_counter()
        for uid in hot:
            for ep in (ep_b, ep_c):
                rep = rpc(ep, "replica", {"uid": uid, "sync": True})
                assert rep == {"uid": uid, "installed": True,
                               "hosted": True}, rep
            rep = rpc(ep_a, "replica", {"uid": uid, "sync": True})
            assert rep["installed"] is False and rep["hosted"] is True, rep

        def all_hosters():
            found = client_loop().run(
                nodes[1].get_alive_experts_fresh(prefix))
            return all(isinstance(found.get(u), tuple)
                       and {ep_a, ep_b, ep_c} <= set(found[u]) for u in hot)

        wait_until(all_hosters, "three hosters in the DHT", 60.0, servers)

        def sync_docs():
            return [server_doc(metrics[ep])["replica_sync"]
                    for ep in (ep_b, ep_c)]

        docs = wait_until(
            lambda: (lambda d: d if all(
                u in x and x[u]["rounds"] >= 1 for x in d for u in hot)
                else None)(sync_docs()),
            "a first replica sync round per uid", ELASTIC_SYNC_S, servers)
        t_first = time.perf_counter() - t_rep
        init_crc = {u: docs[1][u]["params_crc"] for u in hot}
        assert not set(hot) & set(server_doc(metrics[ep_a])["replica_sync"])
        # one backward into B's copy of each uid, just after one of its
        # rounds ended (a sync period before the next): B's copy leaves
        # C's, and the next round must average the two
        rng = np.random.default_rng(SEED)
        seen = {u: docs[0][u]["rounds"] for u in hot}
        pushed = {}
        t_end = time.perf_counter() + ELASTIC_SYNC_S
        while len(pushed) < len(hot):
            servers.check()
            doc_b = server_doc(metrics[ep_b])["replica_sync"]
            for u in hot:
                if u not in pushed and doc_b[u]["rounds"] > seen[u]:
                    x, g = (rng.standard_normal(
                        (ELASTIC_PUSH_ROWS, cfg.d_model)).astype(np.float32)
                        for _ in range(2))
                    RemoteExpert(u, ep_b).backward_blocking([x], [g])
                    pushed[u] = doc_b[u]["rounds"]
            assert time.perf_counter() < t_end, "no sync round to follow"
            time.sleep(0.05)

        def averaged():
            d = sync_docs()
            if all(d[0][u]["rounds"] > pushed[u] and d[1][u]["rounds"] >= 2
                   and d[0][u]["params_crc"] == d[1][u]["params_crc"]
                   != init_crc[u] for u in hot):
                return d
            return None

        docs = wait_until(averaged, "a replica sync round after the update",
                          ELASTIC_SYNC_S, servers)
        t_rep = time.perf_counter() - t_rep
        infos = {ep: [rpc(ep, "info", {"uid": u})["update_count"]
                      for u in hot] for ep in (ep_a, ep_b, ep_c)}
        assert infos[ep_b] == [1] * len(hot), infos
        assert infos[ep_c] == [0] * len(hot), infos
        assert infos[ep_a] == [counts_a[u] for u in hot], infos
        p50 = [d[u]["round_p50_ms"] for d in docs for u in hot]
        print(f"  replicas: {hot} on B and C (sync), none synced on A (the "
              f"hoster); the DHT lists A, B and C for each; every first "
              f"sync round {t_first:.1f} s after the first replica RPC; one "
              f"backward into B's copy of each, then a ReplicaSync round "
              f"leaves B's and C's copies the same bits "
              f"({len(docs[0][hot[0]]['params_crc'])} leaf crcs each), "
              f"off the init; update counts B {infos[ep_b]}, C "
              f"{infos[ep_c]}, A {infos[ep_a]} (each its own optimizer "
              f"state); sync round p50 {min(p50):.3f}-{max(p50):.3f} ms; "
              f"{t_rep:.1f} s from the first replica RPC [{card}]")

        # (3) migration of one uid A -> B
        moved = next(u for u in uids if u not in hot)
        t_mig = time.perf_counter()
        rep = rpc(ep_a, "migrate", {"uid": moved, "target": list(ep_b)})
        assert rep["started"] is True, rep

        def migrated():
            placement = rpc(ep_a, "stats", {})["placement"]
            return (placement if placement["migration_in_flight"] is None
                    else None)

        placement = wait_until(migrated, "the migration", 120.0, servers)
        t_mig = time.perf_counter() - t_mig
        lc_b = rpc(ep_b, "stats", {})["lifecycle"]
        assert placement["migrations_out"] == 1, placement
        assert placement["migration_failures"] == 0, placement
        assert moved in lc_b["migrated_in"], lc_b
        assert lc_b["handoff"]["received"] == 1, lc_b
        assert lc_b["handoff"]["rejected"] == 0, lc_b
        print(f"  migration: {moved} A -> B in {t_mig:.3f} s, B's installed "
              f"state verified against A's manifest [{card}]")

        # (4) drain A to B while trainer 0 keeps stepping
        trainer, model = trainers[0], models[0]
        counts_before = server_doc(metrics[ep_a])["experts"]
        drops0 = (replies[0]["dropped"], model.moes[0].backward_rpcs_sent
                  - model.moes[0].backward_rpcs_ok,
                  model.moes[0].samples_dropped)

        def step_times(n):
            """(seconds, experts called) of ``n`` steps of trainer 0."""
            out = []
            for _ in range(n):
                servers.check()
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer.train(batchers[0], steps=1, tokens_per_batch=tokens)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t,
                            len(model.moes[0].selection_log[-1])))
            return out

        before = step_times(ELASTIC_STEPS_AROUND)
        t_drain = time.perf_counter()
        rep = rpc(ep_a, "drain", {"successor": list(ep_b),
                                  "grace": ELASTIC_GRACE_S})
        assert rep["started"] is True and rep["draining"] is True, rep
        during = []
        while True:
            lc_a = rpc(ep_a, "stats", {})["lifecycle"]
            if lc_a["state"] == lifecycle.DRAINED:
                break
            assert time.perf_counter() - t_drain < ELASTIC_DRAIN_S, \
                "A did not reach DRAINED"
            during += step_times(1)
        t_drain = time.perf_counter() - t_drain
        after = step_times(ELASTIC_STEPS_AROUND)
        summary = lc_a["drain_summary"]
        handed = sorted(u for u in uids if u != moved)
        assert summary["handed_off"] == handed, (
            summary["failed"], servers.logs_tail(["elastic-A", "elastic-B"]))
        assert summary["failed"] == [] and summary["checkpointed"] == [], \
            summary
        doc_b = server_doc(metrics[ep_b])
        behind = [u for u in handed
                  if doc_b["experts"].get(u, -1) < counts_before[u]]
        assert not behind, f"B's update counts behind A's: {behind[:5]}"
        st_b = rpc(ep_b, "stats", {})
        lc_b = st_b["lifecycle"]
        assert lc_b["handoff"]["received"] == len(uids), lc_b["handoff"]
        assert set(lc_b["migrated_in"]) == set(uids), lc_b["migrated_in"]
        assert lc_b["handoff"]["rejected"] == 0, lc_b["handoff"]
        mb = summary["handoff_bytes"] / 1e6
        print(f"  drain: A DRAINED {t_drain:.1f} s after the drain RPC "
              f"(its sequence {summary['duration_s']:.3f} s with a "
              f"{ELASTIC_GRACE_S} s grace); {len(handed)} experts handed off "
              f"and verified, 0 failed, 0 checkpointed; handoffs "
              f"{summary['handoff_s']:.3f} s for {mb:.1f} MB: "
              f"{mb / summary['handoff_s']:.1f} MB/s, "
              f"{summary['handoff_s'] / len(handed) * 1e3:.3f} ms per "
              f"expert; B's update counts continue A's [{card}]")
        def fmt(series):
            return ", ".join(f"{t:.3f} ({n})" for t, n in series)

        print(f"  step times s (experts called): before the drain "
              f"{fmt(before)}; during {fmt(during)}; after {fmt(after)} "
              f"({len(during)} steps during, every step completed) "
              f"[{card}]")
        moe = model.moes[0]
        print(f"  quorum drops since the drain's first step: forward "
              f"{replies[0]['dropped'] - drops0[0]} replies, backward "
              f"{moe.backward_rpcs_sent - moe.backward_rpcs_ok - drops0[1]}"
              f" RPCs, samples {moe.samples_dropped - drops0[2]} forward; "
              f"over the phase: forward {replies[0]['dropped']}/"
              f"{replies[0]['expected']} replies [{card}]")
        counts = read_counts(counters)
        peak = torch.cuda.max_memory_allocated()
        collected = [rpc(ep, "stats", {})["metrics"]["collected"]
                     for ep in (ep_a, ep_b, ep_c)]
        print(f"  B's pump: "
              f"{int(collected[1]['lah_server_native_frames_in_total'])} "
              f"frames in, "
              f"{int(collected[1]['lah_server_native_frames_out_total'])} "
              f"replies out; peak card memory A "
              f"{collected[0].get('lah_server_device_peak_bytes', 0) / 1e9:.3f}"
              f" GB, B "
              f"{collected[1].get('lah_server_device_peak_bytes', 0) / 1e9:.3f}"
              f" GB, C "
              f"{collected[2].get('lah_server_device_peak_bytes', 0) / 1e9:.3f}"
              f" GB, trainers {peak / 1e9:.3f} GB [{card}]")

        # (5) card against CPU
        elastic_init_check(uids, hot, cfg.d_model, card)
        servers.check()
        print(f"elastic phase: {time.perf_counter() - t_phase:.1f} s")
        return counts
    finally:
        for session in sessions:
            session.shutdown()
        servers.stop()
        for node in nodes:
            node.shutdown()
        boot.shutdown()
        reset_client_rpc()


def time_dispatch(plans, results) -> None:
    """Timings of K4 on layer 0's plan of each path: kernel, plain
    version, ``index_select`` yardstick, bound from the plan's own fill.
    The card's time only (``queue_ahead``): a call is tens of µs, of the
    order of the host's Python around it."""
    for label, layer, x, tfs in plans:
        if layer:
            continue
        plan = _index_plan(tfs)
        idx = tfs.reshape(-1).clamp(min=0)
        n, d = x.shape
        slots, filled = tfs.numel(), int((tfs >= 0).sum())
        nbytes = x.element_size() * d * (slots + filled) + 4 * slots
        bound_ms, bound_by = bound(0, nbytes)
        with torch.no_grad():
            ms = median_ms(lambda: td.dispatch_tokens_kernel(x, plan),
                           queue_ahead=True)
            plain_ms = median_ms(
                lambda: moe_dispatch.dispatch_tokens_indexed(x, plan),
                queue_ahead=True)
            yard_ms = median_ms(lambda: torch.index_select(x, 0, idx),
                                queue_ahead=True)
        shape = (n, d, *tfs.shape)
        print(f"token_dispatch {label} {list(shape)} (filled "
              f"{filled / slots:.4f}): {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, "
              f"index_select {yard_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {bound_ms / ms:.3f} of it)")
        record(results, "token_dispatch", shape, _dispatch_form(label),
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms, library_ms=None,
               filled=filled / slots,
               yardstick="torch.index_select(x, 0, idx.clamp(min=0)): the "
                         "same rows gathered, empty slots not zeroed",
               yardstick_ms=yard_ms)


def time_jitter_noise() -> None:
    """The router-jitter noise of one flagship-train layer drawn without
    the cache (threefry in int64 torch ops): what each of a step's 8
    routing calls (4 layers and their recompute) would cost if the noise
    were not kept between calls."""
    shape = (TRAIN_BATCH * FLAGSHIP_TRAIN["seq_len"],
             FLAGSHIP_TRAIN["num_experts"])
    key = prng.fold_in(prng.PRNGKey(moe_dispatch._JITTER_SEED, device="cuda"),
                       0)
    ms = median_ms(lambda: prng.uniform(key, shape, minval=0.9, maxval=1.1),
                   reps=5, warmup=1)
    print(f"jitter noise {list(shape)} drawn without the cache: {ms:.3f} ms "
          f"a draw, {8 * ms:.1f} ms a step of 8 routing calls")


def time_fused_ce(shape, gen, results) -> None:
    """Phase 11 for K1-K3 at one shape: kernel, plain version, cuBLAS
    yardstick, bound.  The yardsticks are the kernels' products unfused,
    with the [n, V] logits written and read in bf16: K1's ``x @ head``;
    K2's ``x @ head`` then ``logits @ head^T``; K3's ``x @ head`` then
    ``x^T @ logits``, each pair timed as one."""
    n, d, v = shape
    x, head, tgt, dce = ce_inputs(n, d, v, gen)
    _, lse = fce.ce_forward(x, head, tgt)
    rows = 4 * n  # targets read, ce / lse written or lse / dce read (4 bytes)
    fwd_bytes = 2 * n * d + 2 * d * v + rows + 2 * 4 * n
    cases = [
        ("fused_ce_fwd", lambda: fce.ce_forward(x, head, tgt),
         lambda: fce.ce_fwd_reference(x, head, tgt),
         2 * n * d * v, fwd_bytes,
         "torch.matmul(x, head) bf16 (cuBLAS), K1's product",
         lambda: torch.matmul(x, head)),
        ("fused_ce_dx", lambda: fce.ce_dx(x, head, tgt, lse, dce),
         lambda: fce.ce_dx_reference(x, head, tgt, lse, dce),
         4 * n * d * v, 2 * n * d + 2 * d * v + 3 * rows + 2 * n * d,
         "(x @ head) @ head.T bf16 (cuBLAS, two products), K2's unfused",
         lambda: torch.matmul(torch.matmul(x, head), head.t())),
        ("fused_ce_dhead", lambda: fce.ce_dhead(x, head, tgt, lse, dce),
         lambda: fce.ce_dhead_reference(x, head, tgt, lse, dce),
         4 * n * d * v, 2 * n * d + 2 * d * v + 3 * rows + 2 * d * v,
         "x.T @ (x @ head) bf16 (cuBLAS, two products), K3's unfused",
         lambda: torch.matmul(x.t(), torch.matmul(x, head))),
    ]
    for name, kernel, plain, flops, nbytes, yard, yard_fn in cases:
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, reps=5, warmup=1)
        yard_ms = median_ms(yard_fn)
        bound_ms, bound_by = bound(flops, nbytes)
        print(f"{name} {list(shape)}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.4f} ms, yardstick {yard_ms:.4f} "
              f"ms ({flops / yard_ms / 1e9:.1f} TFLOP/s), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {bound_ms / ms:.3f} of it)")
        record(results, name, shape, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms, library_ms=None, yardstick=yard,
               yardstick_ms=yard_ms)


def time_attention(shape, gen, results, train: bool,
                   plain_bwd_reps: int = 3) -> None:
    """Phase 8 for K5 at one [B,S,H,hd] shape: the forward (with the lse
    the training path writes when ``train``) and, when ``train``, the dkv
    and dq kernels; each against its bound, its plain version and the
    PyTorch call (SDPA) or yardstick (SDPA's whole backward).  The plain
    backward takes ``plain_bwd_reps`` timed calls after one warm-up."""
    b, s, h, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v, do = (randn_bf16(shape, gen) for _ in range(4))
    pairs = b * h * s * (s + 1) / 2  # causal (query, key) pairs
    product = 2 * pairs * hd  # operations of one causal product
    tensor = b * s * h * hd * 2  # bytes of one [B,S,H,hd] bf16 tensor
    stats = b * h * s * 4  # bytes of lse or di
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    timed_here = {"flash_attn_fwd": dict(
        ms=median_ms(lambda: fa.flash_attention_fwd(q, k, v, with_lse=train)),
        plain_ms=median_ms(lambda: fa.attention_fwd_reference(
            q, k, v, with_lse=train), reps=5, warmup=1),
        library_ms=median_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
        **dict(zip(("bound_ms", "bound_by"), bound(
            2 * product, 4 * tensor + (stats if train else 0)))))}
    if train:
        o, lse = fa.flash_attention_fwd(q, k, v)
        di = fa._row_dot(o, do)
        leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        out_t = sdpa(*leaves, is_causal=True)
        do_t = do.transpose(1, 2)
        yard_ms = median_ms(lambda: torch.autograd.grad(
            out_t, leaves, do_t, retain_graph=True))
        plain_ms = median_ms(lambda: fa.attention_bwd_reference(
            q, k, v, o, lse, do), reps=plain_bwd_reps, warmup=1)
        for name, fn, n_products, n_out in (
                ("flash_attn_bwd_dkv",
                 lambda: fa.flash_attention_dkv(q, k, v, do, lse, di), 4, 2),
                ("flash_attn_bwd_dq",
                 lambda: fa.flash_attention_dq(q, k, v, do, lse, di), 3, 1)):
            timed_here[name] = dict(
                ms=median_ms(fn), plain_ms=plain_ms,
                plain_computes="dq, dk and dv together", library_ms=None,
                yardstick="torch.nn.functional.scaled_dot_product_attention"
                          "(is_causal=True) backward: dq, dk and dv together",
                yardstick_ms=yard_ms,
                **dict(zip(("bound_ms", "bound_by"), bound(
                    n_products * product, (4 + n_out) * tensor + 2 * stats))))
        del leaves, out_t
    for name, row in timed_here.items():
        n_products = {"flash_attn_fwd": 2, "flash_attn_bwd_dkv": 4,
                      "flash_attn_bwd_dq": 3}[name]
        lib = row["library_ms"] if row["library_ms"] is not None \
            else row["yardstick_ms"]
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print(f"{name} {list(shape)}: {row['ms']:.4f} ms "
              f"({n_products * product / row['ms'] / 1e9:.1f} TFLOP/s), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
              f"{row['bound_share']:.3f} of it)")
        form = "with lse" if train and name == "flash_attn_fwd" else None
        record(results, name, shape, form, **row)
    if train:
        both = (timed_here["flash_attn_bwd_dkv"]["ms"]
                + timed_here["flash_attn_bwd_dq"]["ms"])
        pair_ms, _ = bound(5 * product, 8 * tensor + 2 * stats)
        print(f"K5 backward (dkv + dq) {list(shape)}: {both:.4f} ms, "
              f"5-product bound {pair_ms:.4f} ms, sdpa backward {yard_ms:.4f} ms")


def report_build() -> None:
    """ptxas's lines of each kernel this process compiled (registers,
    spills, warnings and notes such as C7512, "wgmma serialized"), and the
    dynamic shared memory of the warp-specialised kernels at the paths'
    shapes."""
    for name, report in build.build_reports.items():
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "warning", "Performance", "C7512")):
                print(f"  {name}: {line.strip()}")
    sass_report()
    _, threads, smem = fa.fwd_launch_geometry(*TRAIN_ATTN[:3])
    print(f"  flash_attn_fwd: {threads} threads, {smem} bytes dynamic smem")
    for kernel in ("dkv", "dq"):
        _, threads, smem = fa.bwd_launch_geometry(kernel, *TRAIN_ATTN[:3])
        print(f"  flash_attn_bwd {kernel}: {threads} threads, {smem} bytes "
              "dynamic smem")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, d, _ in (CE_TRAIN, CE_8K_TRAIN):
        grid, threads, smem = fce.ce_fwd_launch_geometry(n, d)
        print(f"  fused_ce_fwd [n={n}, D={d}]: {grid[0]} blocks of {threads} "
              f"threads ({grid[0] / sms:.2f} waves of {sms} SMs), {smem} "
              "bytes dynamic smem")
    for n, d, v in (CE_TRAIN, CE_8K_TRAIN):
        for mode in fce.BWD_MODES:
            grid, cluster, threads, smem = fce.ce_bwd_launch_geometry(
                n, v, d, mode)
            print(f"  fused_ce_{mode} [n={n}, D={d}, V={v}]: {grid[0]} "
                  f"blocks of {threads} threads in clusters of {cluster} "
                  f"({grid[0] / sms:.2f} waves of {sms} SMs), {smem} bytes "
                  "dynamic smem")


def sass_report() -> None:
    """Each wgmma kernel this process built, from cuobjdump's SASS: its
    HGMMA instructions, the WARPGROUP.DEPBAR waits among them (one per
    HGMMA: ptxas serialised the products) and its spill instructions
    (STL, LDL)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.DEFAULT_NVCC), "cuobjdump")
    if not os.path.exists(tool):
        print("  cuobjdump not found: no SASS counts")
        return
    for name in build.build_reports:
        sass = subprocess.run(
            [tool, "-sass", str(build._library_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout
        for func in sass.split("Function : ")[1:]:
            lines = func.splitlines()
            hgmma = sum("HGMMA" in line for line in lines)
            if not hgmma:
                continue
            kernel = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?kernel(I\w+?E)?)E",
                               lines[0])
            depbar = sum("DEPBAR" in line for line in lines)
            spills = sum(bool(re.search(r"\b(STL|LDL)\b", line))
                         for line in lines)
            print(f"  {name}: {kernel.group(1) if kernel else lines[0]}: "
                  f"{hgmma} HGMMA, {depbar} DEPBAR, {spills} STL/LDL")


# kernel families: their libraries (for --kernels-only)
FAMILIES = {"flash": ("flash_attn_fwd", "flash_attn_bwd"),
            "ce": ("fused_ce_fwd", "fused_ce")}


def check_kernels(gen, results, family: str = "all") -> None:
    """Phase 3 (of one family's kernels)."""
    if family in ("all", "flash"):
        for shape in [SERVE_ATTN, MESH_ATTN, (1, 1000, 8, 64), (3, 70, 2, 64),
                      (1, 1, 1, 64), (1, 65, 2, 64), (1, 8193, 8, 64)]:
            check_flash(shape, gen, results)
        for shape in [TRAIN_ATTN, MESH_ATTN, CELL_256_ATTN,
                      (1, 8192, 8, 64), (1, 8193, 8, 64), (2, 4096, 8, 64),
                      (1, 1000, 8, 64)]:
            check_flash_bwd(shape, gen, results)
    if family in ("all", "ce"):
        for shape in [CE_TRAIN, CE_8K_TRAIN, MESH_CE, *MESH_CHECK_CE,
                      (1024, 128, 2048), (384, 384, 4096), (1000, 256, 1088)]:
            check_fused_ce(shape, gen, results)
    if family == "all":
        check_dispatch_ragged(gen, results)  # the path's plans: phase 10
    torch.cuda.empty_cache()


def time_kernels(gen, results, family: str = "all") -> None:
    """Phase 11's timings of K5 and K1-K3 (of one family)."""
    if family in ("all", "flash"):
        time_attention(SERVE_ATTN, gen, results, train=False)
        torch.cuda.empty_cache()
        time_attention(TRAIN_ATTN, gen, results, train=True)
        torch.cuda.empty_cache()
        # the plain backward goes one row at a time: 2.5 s a call here
        time_attention(CELL_256_ATTN, gen, results, train=True,
                       plain_bwd_reps=1)
        torch.cuda.empty_cache()
    if family in ("all", "ce"):
        for shape in (CE_TRAIN, CE_8K_TRAIN):
            time_fused_ce(shape, gen, results)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", nargs="?", const="all",
                    choices=["all", *FAMILIES],
                    help="phases 1-3 and the kernel timings of phase 12, of "
                         "all kernels or of one family")
    ap.add_argument("--swarm-lm-only", action="store_true",
                    help="phases 1, 13 and 15 only (no kernel is built)")
    ap.add_argument("--elastic-only", action="store_true",
                    help="phases 1 and 14 only (no kernel is built)")
    ap.add_argument("--gateway-only", action="store_true",
                    help="phases 1 and 15 only, on phase 13's servers "
                         "serving key-seeded params (no training, no "
                         "kernel is built), and the twins' decoders")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1, 2 and 17 only (the pod tier on meshes "
                         "of ranks; no kernels line)")
    ap.add_argument("--experiments-only", action="store_true",
                    help="phases 1, 2 and 16 only (the experiment drivers; "
                         "(d) on phase 13's servers serving key-seeded "
                         "params; no kernels line)")
    ap.add_argument("--ckpt-only", action="store_true",
                    help="phases 1, 2 and 18 only (sharded checkpoints and "
                         "resume on a mesh, decode_gap_eval on the expert "
                         "mesh, the macro-sim; no kernels line)")
    ap.add_argument("--tools-only", action="store_true",
                    help="phases 1 and 19 only (the operator tools; no "
                         "kernel is built, no kernels line)")
    ap.add_argument("--gate-only", action="store_true",
                    help="phases 1 and 20 only (the pre-test gate; no "
                         "kernel is built, no kernels line)")
    ap.add_argument("--profile-only", action="store_true",
                    help="phases 1 and 21 only (the step profiler and the "
                         "roofline; no kernel is built, no kernels line)")
    args = ap.parse_args()
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    if args.tools_only:
        phase("operator tools")
        tools_phase(counters, card)
        print(card)
        return 0
    if args.gate_only:
        phase("pre-test gate")
        gate_phase(counters, card)
        print(card)
        return 0
    if args.profile_only:
        phase("profiling tools")
        profile_phase(counters, card)
        print(card)
        return 0
    if args.swarm_lm_only or args.gateway_only:
        phase(f"swarm LM {SWARM_LM_NAME}")
        swarm_lm(counters, card, train=not args.gateway_only)
        swarm_lm_twins(card)
        print(card)
        return 0
    if args.elastic_only:
        phase("elastic swarm-elastic-d512")
        elastic(counters, card)
        print(card)
        return 0
    if args.mesh_only:
        phase("build")
        build.build_all(sorted(build.LIBRARIES))
        phase("mesh")
        mesh_phase(card)
        print(card)
        return 0
    if args.ckpt_only:
        phase("build")
        build.build_all(sorted(build.LIBRARIES))
        phase("checkpoints")
        ckpt_phase(counters, card)
        print(card)
        return 0
    if args.experiments_only:
        phase("build")
        build.build_all(sorted(build.LIBRARIES))
        phase("experiment drivers")
        experiments(counters, card)
        phase(f"experiment drivers (d) on a gateway of {SWARM_LM_NAME}")
        swarm_lm(counters, card, train=False, arms=False)
        print(card)
        return 0

    phase("build")
    t0 = time.perf_counter()
    libraries = FAMILIES.get(args.kernels_only, sorted(build.LIBRARIES))
    build.build_all(libraries)
    print(f"built {sorted(libraries)} in {time.perf_counter() - t0:.1f} s")
    report_build()

    phase("kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}  # kernel name -> {(shape, form): numbers measured there}
    check_kernels(gen, results, args.kernels_only or "all")
    if args.kernels_only:
        phase("timings")
        time_kernels(gen, results, args.kernels_only)
        print(card)
        return 0

    phase("small models: card against cpu")
    small_reference()
    small_train_reference(counters)

    phase("serving flagship-8k")
    plans = []  # (path, layer, x, token_for_slot) of the MoE dispatches
    launches = {"flagship-8k (one generate)": serve_flagship(counters, plans)}
    torch.cuda.empty_cache()

    for name in TRAINING:
        phase(f"training {name}")
        n_steps, counts = train(name, counters, plans)
        launches[f"{name} ({n_steps} steps)"] = counts
        torch.cuda.empty_cache()

    phase("token dispatch on the flagship's plans")
    launches["dispatch_tokens_auto (flagship plans)"] = dispatch_path(
        plans, counters, results)

    phase("swarm swarm-ffn4-h1024")
    launches["swarm-ffn4-h1024 (forward/backward RPCs)"] = swarm(counters)
    torch.cuda.empty_cache()

    phase("timings")
    time_kernels(gen, results)
    time_dispatch(plans, results)
    time_jitter_noise()

    phase(f"swarm LM {SWARM_LM_NAME}")
    (launches[f"{SWARM_LM_NAME} (train steps)"],
     launches[f"gateway {SWARM_LM_NAME} ({GATEWAY_STREAMS} streams)"]) = \
        swarm_lm(
        counters, card)
    swarm_lm_twins(card)

    phase("elastic swarm-elastic-d512")
    launches["swarm-elastic-d512 (averaging, replicas, migration, drain)"] = \
        elastic(counters, card)

    phase("experiment drivers")
    launches.update(experiments(counters, card))

    phase("mesh")
    plans.clear()  # the dispatch plans' card tensors: the ranks need room
    launches.update(mesh_phase(card))

    phase("checkpoints")
    corpus = start_corpus()  # phase 19 (e), on the host beside phase 18
    try:
        launches.update(ckpt_phase(counters, card))
    except BaseException:
        stop_tools(corpus)
        raise

    phase("operator tools")
    launches.update(tools_phase(counters, card, corpus))

    phase("pre-test gate")
    launches.update(gate_phase(counters, card))

    phase("profiling tools")
    launches.update(profile_phase(counters, card))

    kernels = []
    for name, (source, replaces, shape) in KERNELS.items():
        entries = results[name]
        for entry in entries.values():
            assert "ms" not in entry or "max_abs_err" in entry, (name, entry)
        head = entries[(shape, None)]
        assert CONTRACT_KEYS <= set(head), (name, CONTRACT_KEYS - set(head))
        paths = {path: counts[name] for path, counts in launches.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"learning_at_home_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            **head,
            "other_shapes": [e for key, e in entries.items()
                             if key != (shape, None)],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
