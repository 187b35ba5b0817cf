"""Multi-process evaluation sweeps (counterpart of
``sdfest_tpu/scripts/distributed_evaluation.py``).

Shards the mesh list of :mod:`sdfest_torch.scripts.rendering_evaluation`
(or the sample indices of :mod:`sdfest_torch.scripts.category_evaluation`)
across the processes of a ``torch.distributed`` group: every process
evaluates its round-robin share with the unchanged single-process machinery
and dumps its raw per-item metrics; process 0 merges them into the
statistics a single-process run computes from the same per-item metrics,
writes the merged YAML and removes the partial pickles.

The sweep exchanges no tensors (a barrier and files), so its group is a
host group under gloo whatever device evaluates (``--device``); each
process's views follow its own random stream, as in the JAX package.

Usage (one process each; or under torchrun without the three flags):
  python -m sdfest_torch.scripts.distributed_evaluation \\
      --config configs/estimation/rendering_evaluation.yaml \\
      --coordinator localhost:29500 --num_processes 2 --process_id I \\
      [--device cuda]
"""
from __future__ import annotations

import argparse
import glob as _glob
import os
import pickle
from datetime import datetime

from sdfest_torch.parallel import distributed as dist
from sdfest_torch.utils.config import (load_config_from_args,
                                       save_config_to_file)


def _merged_path(out_folder: str, prefix: str, run_name: str) -> str:
    return os.path.join(
        out_folder,
        f"{prefix}_{run_name}_"
        f"{datetime.now().strftime('%Y-%m-%d_%H-%M-%S')}_merged.yaml")


def _remove_parts(out_folder: str, run_name: str) -> None:
    for p in _glob.glob(os.path.join(out_folder, f"{run_name}_part*.pkl")):
        os.remove(p)


def run_distributed_category(config: dict, evaluator=None,
                             device="cuda") -> dict:
    """Category-level (REAL275/REDWOOD75) sweep sharded by dataset index.

    Same structure as :func:`run_distributed`: every process scores its
    index shard with :meth:`CategoryEvaluator.evaluate_indices`, process 0
    merges the raw record lists and aggregates exactly as a single-process
    run would.
    """
    from sdfest_torch.scripts.category_evaluation import CategoryEvaluator

    pid = dist.process_index()
    nproc = dist.process_count()
    out_folder = config.get("out_folder", "distributed_eval_out")
    run_name = config.get("run_name") or "category_eval"

    if evaluator is None:
        evaluator = CategoryEvaluator(config, device=device)
    indices = evaluator.default_indices()
    my_indices = dist.shard_work_list(indices)
    print(f"[process {pid}/{nproc}] evaluating {len(my_indices)} of "
          f"{len(indices)} samples", flush=True)
    records = evaluator.evaluate_indices(my_indices)

    part = dist.partial_result_path(out_folder, run_name, pid)
    dist.save_partial_results(part, records)
    dist.barrier()
    if pid != 0:
        return records

    merged = dist.merge_partial_results([
        dist.partial_result_path(out_folder, run_name, i)
        for i in range(nproc)])
    results = CategoryEvaluator.aggregate_records(merged)
    os.makedirs(out_folder, exist_ok=True)
    out_path = _merged_path(out_folder, "category_eval", run_name)
    save_config_to_file(out_path, {**config, "results": results})
    print(f"Merged results ({nproc} processes) saved to: {out_path}")
    _remove_parts(out_folder, run_name)
    return results


def run_distributed(config: dict, device="cuda") -> dict:
    """Evaluate this process's shard on ``device``; process 0 merges and
    saves.  Returns the merged statistics on process 0, this process's raw
    results else."""
    from sdfest_torch.scripts.rendering_evaluation import Evaluator, glob_exts

    if "category_configs" in config:
        return run_distributed_category(config, device=device)

    pid = dist.process_index()
    nproc = dist.process_count()
    out_folder = config.get("out_folder", "distributed_eval_out")
    run_name = config.get("run_name", "eval")

    evaluator = Evaluator(config, device=device)
    all_files = sorted(glob_exts(config["data_path"], [".obj", ".off"]))
    my_files = dist.shard_work_list(all_files)
    print(f"[process {pid}/{nproc}] evaluating {len(my_files)} of "
          f"{len(all_files)} meshes", flush=True)

    # {ablation_name or None: {views: [raw metric dicts]}}
    if config.get("ablation_configs"):
        import copy

        from sdfest_torch.utils.config import load_config

        raw = {}
        for name, overlay in config["ablation_configs"].items():
            sub = load_config(overlay, copy.deepcopy(config))
            raw[name] = evaluator.evaluate_config_raw(sub, files=my_files)
    else:
        raw = {None: evaluator.evaluate_config_raw(config, files=my_files)}

    part = dist.partial_result_path(out_folder, run_name, pid)
    dist.save_partial_results(part, raw)
    dist.barrier()
    if pid != 0:
        return raw

    # merge: concatenate raw per-file lists across processes, then compute
    # the exact statistics a single-process run computes from them
    merged: dict = {}
    for i in range(nproc):
        with open(dist.partial_result_path(out_folder, run_name, i),
                  "rb") as f:
            part_raw = pickle.load(f)
        for name, by_views in part_raw.items():
            dst = merged.setdefault(name, {})
            for views, metrics_list in by_views.items():
                dst.setdefault(views, []).extend(metrics_list)
    stats = {
        name: {
            views: Evaluator._compute_metric_statistics(metrics_list)
            for views, metrics_list in by_views.items()
        }
        for name, by_views in merged.items()
    }
    results = stats[None] if set(stats) == {None} else stats

    os.makedirs(out_folder, exist_ok=True)
    out_path = _merged_path(out_folder, "rend_eval", run_name)
    save_config_to_file(out_path, {**config, "results": results})
    print(f"Merged results ({nproc} processes) saved to: {out_path}")
    _remove_parts(out_folder, run_name)
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Multi-process evaluation sweep.")
    parser.add_argument("--config", nargs="+", required=False)
    parser.add_argument("--coordinator", default=None,
                        help="coordinator address host:port (omit under "
                        "torchrun)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="the device that evaluates; the group is gloo")
    args, _ = parser.parse_known_args(argv)
    dist.initialize_distributed(args.coordinator, args.num_processes,
                                args.process_id, device="cpu")
    config = load_config_from_args(parser, argv)
    for k in ("coordinator", "num_processes", "process_id", "device"):
        config.pop(k, None)
    run_distributed(config, device=args.device)


if __name__ == "__main__":
    main()
