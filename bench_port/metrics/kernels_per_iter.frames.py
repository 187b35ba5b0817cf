"""Device kernels per refinement iteration and view in the traced slice:
the reader ``kernels_per_iter`` of ``harness/readers.py``."""
from bench_port.harness.readers import kernels_per_iter as read  # noqa: F401
