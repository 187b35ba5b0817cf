"""The hand-written kernels' share of their roofline in the traced slice:
the reader ``kernel_roofline`` of ``harness/readers.py``."""
from bench_port.harness.readers import kernel_roofline as read  # noqa: F401
