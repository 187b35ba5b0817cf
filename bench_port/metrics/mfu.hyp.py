"""The whole step's share of the fp32 peak:
the reader ``mfu`` of ``harness/readers.py``."""
from bench_port.harness.readers import mfu as read  # noqa: F401
