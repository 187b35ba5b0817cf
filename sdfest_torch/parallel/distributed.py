"""Process-group helpers for embarrassingly parallel evaluation sweeps
(counterpart of ``sdfest_tpu/parallel/distributed.py``).

Evaluation of independent meshes or frames needs no collective beyond a
barrier: every process bootstraps one ``torch.distributed`` group, takes a
deterministic share of the work list, dumps its raw results, and process 0
merges them into the statistics a single-process run computes.

The group's backend follows the device the caller names: ``"cuda"`` takes
NCCL (one GPU per process, ``cuda:<local rank>``), ``"cpu"`` takes gloo.
It is never chosen by whether a GPU happens to be present.  Without an
initialized group the process is rank 0 of 1, as a JAX process without
``jax.distributed`` is.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence

import torch
import torch.distributed as tdist

from sdfest_torch.utils.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join the process group of a multi-process run.

    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` name the group explicitly; left out, they come from
    torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  ``device`` picks the backend (``"cuda"`` -> NCCL, ``"cpu"``
    -> gloo); on CUDA the process takes ``cuda:<LOCAL_RANK>`` (the rank
    modulo the visible cards without torchrun).  A failure to join raises.
    """
    device = resolve_device(device)
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    tdist.init_process_group(
        backend=BACKENDS[device.type],
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def group_device() -> torch.device:
    """The device of the initialized group's collectives: this process's
    card under NCCL, the CPU under gloo."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a group)."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def shard_work_list(
    items: Sequence,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> List:
    """This process's deterministic round-robin share of a work list.

    Round-robin (``items[pid::n]``) balances heterogeneous per-item cost
    better than contiguous blocks when cost correlates with list order
    (datasets are usually sorted by category/size).
    """
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return list(items)[pid::n]


def partial_result_path(out_folder: str, run_name: str, process_id: int) -> str:
    """Canonical location of one process's partial evaluation results."""
    return os.path.join(out_folder, f"{run_name}_part{process_id:04d}.pkl")


def save_partial_results(path: str, results) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(results, f)


def merge_partial_results(paths: Sequence[str]) -> List:
    """Concatenate the per-file metric lists from every partial dump.

    Partial dumps are raw per-item metric dicts (NOT aggregated statistics —
    means/variances cannot be merged without the raw samples), so the merged
    list feeds the same statistics computation a single-process run uses.
    """
    merged: List = []
    for path in paths:
        with open(path, "rb") as f:
            merged.extend(pickle.load(f))
    return merged


def barrier() -> None:
    """Block until every process reaches this point; a no-op without a
    group (one process)."""
    if tdist.is_initialized():
        tdist.barrier()
