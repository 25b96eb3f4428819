"""The probes: small programs that measure one property of the card each
(the INT8 ceiling, the GEMV engines, the nibble feed, the parts of INT8
p @ V), ports of the JAX package's ``scripts/probe_*.py`` and
``roofline_probe.py``.  Run one with ``python -m dgq_tpu_torch.scripts.<name>``."""
