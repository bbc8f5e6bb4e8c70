"""Framework-free utilities of the port: the wire (``serialization``,
``connection``), nests (``nested``), checkpoints (``checkpoint``), the
loop helpers, metrics, tracing and the concurrency sanitizer — copies of
the JAX package's modules, each held against its original by the
``tests/test_torch_*`` suite — and ``sizing``, the port's copy of the JAX
repo's ``bench.py`` sizing with the card's constants."""
