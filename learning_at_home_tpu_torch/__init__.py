"""learning_at_home_tpu_torch: the PyTorch and CUDA port of learning_at_home_tpu.

The JAX package beside it is the reference; this package imports none of
it.  It holds the pod-mode DMoE-Transformer (``models/``): serving
(``generate``) and training (``loss_fn``, remat, ``make_train_step``), its
routing and MoE layer (``ops/moe_dispatch.py``,
``parallel/sharded_moe.py``; router jitter draws JAX's threefry bits,
``random.py``), hand-written Hopper kernels for causal flash attention,
the fused softmax cross-entropy and the MoE token dispatch
(``ops/flash_attention.py``, ``ops/fused_ce.py``,
``ops/token_dispatch.py``, ``csrc/``), the optimizers
(``ops/fused_adafactor.py``, ``optim.py``) and a converter of parameters
and optimizer state (``convert.py``).  The swarm tier's core: the expert
zoo (``models/layers.py``), the expert server (``server/``: backends,
task pools, the device runtime, the wire handler), its client
(``client/``: ``RemoteExpert``, ``RemoteMixtureOfExperts``) and their
framework-free utilities (``utils/``: the wire, nests, checkpoints,
metrics, tracing, the sanitizer), speaking the JAX package's wire byte
for byte; the Kademlia DHT (``dht/``) and the swarm DMoE-Transformer
with its pipelined trainer; and the elastic tier: decentralized
averaging (``averaging/``), graceful drain, handoff and migration
(``server/lifecycle.py``), replicas with ``ReplicaSync`` and the native
frame pump (``native/``); the serving gateway (``gateway/``); and the
experiment drivers a user runs (``experiments/``: ``train_lm``,
``generate_lm``, ``loadgen``, ``churn_experiment`` and the rest, with
``sim/trace.py`` and ``utils/subproc.py``); and the pod tier on many
cards (``parallel/``: meshes of ``torch.distributed`` ranks with expert,
data, tensor and sequence parallelism, ring attention, the collectives
as autograd functions).  Entry points run on the CUDA card unless given
``device="cpu"``.
"""
