"""The share of the device's busy time in convolution kernels:
the reader ``conv_share`` of ``harness/readers.py``."""
from bench_port.harness.readers import conv_share as read  # noqa: F401
