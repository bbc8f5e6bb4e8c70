"""learning_at_home_tpu_torch: the PyTorch and CUDA port of learning_at_home_tpu.

The JAX package beside it is the reference; this package imports none of
it.  It holds the pod-mode DMoE-Transformer serving path (``models/``),
its routing and MoE layer (``ops/moe_dispatch.py``,
``parallel/sharded_moe.py``), a hand-written Hopper flash-attention kernel
(``ops/flash_attention.py``, ``csrc/``) and a parameter converter
(``convert.py``).  Entry points run on the CUDA card unless given
``device="cpu"``.
"""
