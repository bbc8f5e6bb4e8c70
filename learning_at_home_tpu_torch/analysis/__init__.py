"""The port's share of the JAX package's ``analysis/``: ``placement.py``,
the co-activation-aware expert placement solver the macro-sim runs."""
