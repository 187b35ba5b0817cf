"""Two-process CPU test of the port's evaluation sweeps
(``sdfest_torch/scripts/distributed_evaluation.py``), mirroring
``test_distributed_eval.py``: two OS processes in one gloo group (this file
run as a script, one PyTorch thread each) run the rendering sweep over 2
procedural meshes (``test_torch_eval.py``'s ``mesh_dir`` and
``_eval_config``: the committed mug weights at 128x96, one view) and then
the category sweep over ``test_distributed_eval.py``'s 3 in-memory samples
with stub pipelines (``test_torch_category.py``'s ``_PortPipeline``).

Each process draws its views from its own random stream, as in the JAX
package, so the single-process reference of the rendering sweep evaluates
each process's share in a fresh evaluator and computes the statistics of
the concatenated per-file metrics: the merged YAML must hold those within
1e-6.  The category records do not depend on the order, so there the
reference is one evaluator over all samples.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

WORLD = 2
CATEGORY_CONFIG = {
    "dataset": "nocs", "gt_mesh_metric": False,
    "category_configs": {"mug": None, "bowl": None},
    "run_name": "cat", "samples": 100, "seed": 0, "metrics": {},
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _category_inputs():
    """The category sweep's dataset and stub pipelines (the JAX test's)."""
    from test_eval_scripts import _category_sample, _FakeCategoryDataset
    from test_torch_category import _PortPipeline

    dataset = _FakeCategoryDataset([
        _category_sample("mug"), _category_sample("bowl"),
        _category_sample("mug", position=(0.2, 0.0, 0.3))])
    pipelines = {c: _PortPipeline([0.0, 0.0, 0.3], [0.0, 0.0, 0.0, 1.0], 0.05)
                 for c in ("mug", "bowl")}
    return dataset, pipelines


def _worker(rank: int, coordinator: str, job_path: str):
    import torch.distributed as tdist

    from sdfest_torch.parallel import distributed as dist
    from sdfest_torch.scripts.category_evaluation import CategoryEvaluator
    from sdfest_torch.scripts.distributed_evaluation import (
        run_distributed, run_distributed_category)

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.initialize_distributed(coordinator, WORLD, rank, device="cpu")
    run_distributed(job["render"], device="cpu")
    config = job["category"]
    dataset, pipelines = _category_inputs()
    run_distributed_category(config, CategoryEvaluator(
        config, dataset, pipelines, device="cpu"))
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Run both sweeps in two processes; meanwhile the single-process
    references."""
    from sdfest_torch.parallel import distributed as dist
    from sdfest_torch.scripts import make_procedural_dataset as tmpd
    from sdfest_torch.scripts.category_evaluation import CategoryEvaluator
    from sdfest_torch.scripts.rendering_evaluation import Evaluator, glob_exts
    from test_torch_eval import _eval_config

    tmp = tmp_path_factory.mktemp("sweeps")
    mesh_dir = str(tmp / "meshes")
    tmpd.generate(mesh_dir, n=WORLD, res=16, seed=777, export_meshes=True)
    render = _eval_config(mesh_dir, out_folder=str(tmp / "render"),
                          run_name="sweep", samples=500)
    category = dict(CATEGORY_CONFIG, out_folder=str(tmp / "category"))
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump({"render": render, "category": category}, f)
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), coordinator,
         str(job)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        files = sorted(glob_exts(mesh_dir, [".obj", ".off"]))
        raw = []
        for rank in range(WORLD):
            shard = dist.shard_work_list(files, rank, WORLD)
            raw += Evaluator(render, device="cpu").evaluate_config_raw(
                render, files=shard)[1]
        render_want = {1: Evaluator._compute_metric_statistics(raw)}
        dataset, pipelines = _category_inputs()
        ev = CategoryEvaluator(category, dataset, pipelines, device="cpu")
        category_want = CategoryEvaluator.aggregate_records(
            ev.evaluate_indices(ev.default_indices()))
    finally:
        torch.set_num_threads(threads)
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return dict(outs=outs, render=render, category=category,
                render_want=render_want, category_want=category_want)


def _merged(folder):
    names = os.listdir(folder)
    merged = [f for f in names if f.endswith("_merged.yaml")]
    assert len(merged) == 1, names
    assert not any(f.endswith(".pkl") for f in names), names
    with open(os.path.join(folder, merged[0])) as fh:
        return yaml.safe_load(fh)["results"]


def test_two_process_rendering_sweep(sweeps):
    """Each process evaluates 1 of the 2 meshes; the merged statistics
    (mean, var, std of every metric) within 1e-6 of the single-process
    statistics of the same per-file metrics; no partial pickle is left."""
    for out in sweeps["outs"]:
        assert "evaluating 1 of 2 meshes" in out
    got = _merged(sweeps["render"]["out_folder"])
    want = sweeps["render_want"]
    assert set(got) == set(want) == {1}
    assert set(got[1]) == set(want[1])
    for name, stats in want[1].items():
        assert set(got[1][name]) == {"mean", "var", "std"}
        for k, v in stats.items():
            assert np.isfinite(got[1][name][k])
            np.testing.assert_allclose(got[1][name][k], v, rtol=0,
                                       atol=1e-6, err_msg=f"{name} {k}")
    assert got[1]["chamfer"]["var"] > 0.0  # both shards merged


def test_two_process_category_sweep(sweeps):
    """The samples shard 2 / 1; the merged per-category results equal one
    evaluator's over all samples (means within 1e-6), with the JAX test's
    counts and correctness shares; no partial pickle is left."""
    outs = sweeps["outs"]
    assert "evaluating 2 of 3 samples" in outs[0]
    assert "evaluating 1 of 3 samples" in outs[1]
    got = _merged(sweeps["category"]["out_folder"])
    want = sweeps["category_want"]
    assert set(got) == set(want) == {"mug", "bowl", "all"}
    for cat, agg in want.items():
        assert got[cat]["count"] == agg["count"]
        assert got[cat]["failed"] == agg["failed"]
        assert got[cat]["correctness"] == agg["correctness"]
        assert set(got[cat]["means"]) == set(agg["means"])
        for name, value in agg["means"].items():
            np.testing.assert_allclose(got[cat]["means"][name], value,
                                       rtol=0, atol=1e-6, err_msg=name)
    assert got["mug"]["count"] == 2 and got["bowl"]["count"] == 1
    assert got["mug"]["correctness"]["deg_cm_5deg_5cm"] == 0.5
    assert got["bowl"]["correctness"]["deg_cm_5deg_5cm"] == 1.0


if __name__ == "__main__":
    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
