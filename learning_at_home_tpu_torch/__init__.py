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
and optimizer state (``convert.py``).  Entry points run on the
CUDA card unless given ``device="cpu"``.
"""
