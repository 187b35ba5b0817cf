"""The benchmark of the PyTorch and CUDA port (``sdfest_torch``) on one
NVIDIA GPU.  Run from the root of a checkout::

    python3 bench_port/run.py --workload mug_procedural.frames --seed 7 \\
        --seconds 30 --trace 0

The cells, metrics and bounds are in ``BENCHMARK.json``; see
``bench_port/harness/run.py``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port.harness.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
