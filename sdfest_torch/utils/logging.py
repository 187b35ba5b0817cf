"""Training metrics logging with optional sinks (counterpart of
``sdfest_tpu/utils/logging.py``).

A CSV sink (``scalar_csv``: one ``step,name,value`` row per scalar, flushed
per line so curves survive an interrupted run) and tensorboard
(``log_dir``), imported only when configured; a missing tensorboard turns
its sink off with a message (the card's machine may lack it).  The JAX
package's wandb sink is not ported.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional


class MetricsLogger:
    """Scalar and figure logger fanning out to the configured sinks."""

    def __init__(self, config: Dict[str, Any], run_name: str):
        self._tb = None
        self._csv = None
        if config.get("scalar_csv"):
            path = str(config["scalar_csv"])
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._csv = open(path, "a", buffering=1)
            if self._csv.tell() == 0:
                self._csv.write("step,name,value\n")
        if config.get("log_dir") is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("tensorboard unavailable; tensorboard logging disabled")
            else:
                self._tb = SummaryWriter(os.path.join(config["log_dir"],
                                                      run_name))

    @property
    def active(self) -> bool:
        """Whether any sink is active."""
        return self._tb is not None or self._csv is not None

    def add_scalar(self, name: str, value: float, step: int) -> None:
        if self._csv is not None:
            self._csv.write(f"{step},{name},{value}\n")
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def close(self) -> None:
        if self._csv is not None:
            self._csv.close()
        if self._tb is not None:
            self._tb.close()


def make_logger(config: Dict[str, Any], run_name: str
                ) -> Optional[MetricsLogger]:
    """A :class:`MetricsLogger`, or None when no sink is configured."""
    logger = MetricsLogger(config, run_name)
    return logger if logger.active else None
