"""The device's idle share in the traced slice:
the reader ``idle_share`` of ``harness/readers.py``."""
from bench_port.harness.readers import idle_share as read  # noqa: F401
