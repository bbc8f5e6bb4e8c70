"""The port's operator tools, the twins of the JAX repo's ``tools/``:
``lah_lint``, ``lah_verify``, ``lah_fuzz``, ``lah_rebalance`` and
``lah_top``, each run as ``python -m learning_at_home_tpu_torch.tools.<name>``
with the same flags, and ``roofline`` (the flagship step's floors on the
card's constants against a measured step).  Only lah_fuzz's live expert
and gateway hosts touch a device (the card unless ``--device cpu``)."""
