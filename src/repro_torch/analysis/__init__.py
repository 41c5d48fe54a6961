"""Analysis tools of the port (``repro/analysis`` in the JAX package)."""
