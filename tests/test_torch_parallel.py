"""Parity of the port's ``torch.distributed`` parallelism with the JAX
package's ``shard_map`` parallelism (CPU): two gloo processes against the
JAX package's 2-device mesh of the 8 virtual CPU devices
(``tests/conftest.py``).

One pair of worker processes (this file run as a script, one PyTorch thread
each; it imports nothing of JAX) computes every two-rank result of the
module: the VAE trainer's data-parallel steps, the init trainer's
data-parallel step in float64, ``sharded_refine_batch`` with and without an
ROI and a multires schedule, and the work-list helpers under a group.  The
pytest process computes the JAX references and the port's single-process
counterparts while the workers run.

``jax.random`` and ``torch.Generator`` draw different numbers, so the VAE
step feeds each rank the JAX shard's draws (``fold_in(key, shard)``) and
the JAX package's pc depth, as ``test_torch_training.py`` does.  Tolerances
are stated where they are used.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
VAE_STEPS = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the worker (one process per rank)
# ---------------------------------------------------------------------------


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def _grads(module):
    """A module's gradients as a flax tree (``p.grad`` is still set after
    the optimizer's step)."""
    from sdfest_torch.utils import weights

    return weights.torch_to_flax({k: p.grad
                                  for k, p in module.named_parameters()})


def _worker(rank: int, coordinator: str, job_path: str, out_dir: str):
    import torch.distributed as tdist

    from sdfest_torch.parallel import distributed as dist
    from sdfest_torch.parallel import mesh as pmesh
    from sdfest_torch.parallel.estimation import sharded_refine_batch
    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from sdfest_torch.training.init_trainer import InitTrainer
    from sdfest_torch.training.vae_trainer import VAETrainer
    from sdfest_torch.utils import msgpack_reader, weights

    torch.set_num_threads(1)
    dist.initialize_distributed(coordinator, WORLD, rank, device="cpu")
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    mesh = pmesh.make_mesh(device="cpu")
    out = {"rank": mesh.rank, "world": mesh.world,
           "work": dist.shard_work_list(list(range(7)))}
    # the mesh helpers: contiguous blocks, rank 0's values replicated
    rows = torch.arange(8.0).reshape(4, 2)
    out["shard"] = pmesh.shard_batch({"x": rows}, mesh)["x"]
    out["replicated"] = pmesh.replicate(torch.full((3,), float(rank)), mesh)

    vae = job["vae"]
    t = VAETrainer(vae["config"], device="cpu")
    weights.load_flax_into(t.vae, msgpack_reader.load(vae["weights"]))
    step = pmesh.shard_map_data_parallel_step(t.step, mesh)
    out["vae_metrics"], out["vae_grads"] = [], []
    for eps, quats, depth in vae["draws"]:
        out["vae_metrics"].append(step(
            torch.from_numpy(vae["mugs"]), eps=torch.from_numpy(eps),
            quats=torch.from_numpy(quats), pc_depth=torch.from_numpy(depth)))
        out["vae_grads"].append(_grads(t.vae))
    out["vae_params"] = weights.torch_to_flax(t.vae.state_dict())

    init = job["init"]
    it = InitTrainer(init["config"], latent_size=8, device="cpu")
    weights.load_flax_into(it.net, init["tree"])
    it.net.double()
    step = pmesh.shard_map_data_parallel_step(it.step, mesh)
    out["init_metrics"] = step({k: torch.from_numpy(v)
                                for k, v in init["batch"].items()})
    out["init_state"] = weights.torch_to_flax(it.net.state_dict())
    out["init_grads"] = _grads(it.net)

    refine = job["refine"]
    out["refine"] = {}
    for name, (config, kwargs) in refine["runs"].items():
        pipe = SDFPipeline(config, device="cpu")
        out["refine"][name] = sharded_refine_batch(
            pipe, {k: torch.from_numpy(v)
                   for k, v in refine["states"].items()},
            *(torch.from_numpy(v) for v in refine["views"]), mesh=mesh,
            **kwargs)
    tdist.destroy_process_group()

    # train_vae's data-parallel path, as torchrun starts it
    from sdfest_torch.scripts import train_vae

    os.environ.update(WORLD_SIZE=str(WORLD), RANK=str(rank),
                      MASTER_ADDR="localhost",
                      MASTER_PORT=str(job["train"]["port"]))
    trainer = train_vae.train(dict(job["train"]["config"]),
                              device="cpu")["trainer"]
    out["train_iteration"] = trainer.iteration
    out["train_params"] = weights.torch_to_flax(trainer.vae.state_dict())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(_numpy_tree(out), f)


# ---------------------------------------------------------------------------
# the inputs, the JAX references and the port's single-process runs
# ---------------------------------------------------------------------------


def _refine_jobs():
    """The sharded-refine scenes: 2 ranks x 2 hypotheses on
    ``test_torch_batch.py``'s scene (its 3 starts and a fourth, hypothesis
    1 moved by 5 mm), 5 iterations without culling and adaptive relaxation
    (the JAX package's CPU march), with and without an ROI and a [4, 2]
    multires schedule (the config policy's plan on the observation)."""
    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from test_torch_batch import CAMERA, PLAIN, _config, _scene

    scene = _scene(CAMERA, 3)
    states = {k: np.concatenate([v, v[1:2]]) for k, v in
              scene["states"].items()}
    states["position"][3] += np.float32(0.005)
    plain = _config(**PLAIN, max_iterations=5)
    multi = _config(**PLAIN, max_iterations=5, multires_factor=[4, 2],
                    multires_iterations=[2, 1], roi_size="auto",
                    roi_margin=8)
    pipe = SDFPipeline(multi, device="cpu")
    kwargs = dict(multires=pipe._multires_for(),
                  roi=pipe._roi_for(torch.from_numpy(scene["views"][0])))
    assert kwargs["roi"] is not None
    return dict(states=states, views=scene["views"],
                runs={"plain": (plain, {}), "roi_multires": (multi, kwargs)})


def _train_config(tmp, mugs):
    """train_vae at batch 4 (2 per rank) for 2 iterations on the module's
    4 mugs, the pc render at 64x48, a checkpoint at iteration 2."""
    from sdfest_torch.utils.presets import preset

    data = tmp / "mugs"
    data.mkdir()
    for i, mug in enumerate(mugs):
        np.save(data / f"{i:05}.npy", mug[0])
    config = preset("vae_mug_procedural")
    config.update(dataset_path=str(data), batch_size=2 * WORLD,
                  iterations=2, checkpoint_iteration=2, pc_render_width=64,
                  pc_render_height=48, model_dir=str(tmp / "vae"),
                  scalar_csv=str(tmp / "vae" / "scalars.csv"),
                  run_name="dp")
    return config


@pytest.fixture(scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):
    """Start the two workers, compute the references meanwhile, then
    collect the workers' results."""
    import jax

    from sdfest_torch.utils import msgpack_reader
    from sdfest_torch.utils.scenes import (make_mug_family_sdf,
                                           sample_mug_family)
    from test_torch_training import (
        VAE_PATH, INIT_PATH, _f64, _init_batch, _init_config,
        _jax_draws_vae, _jax_pc_depth, _vae_config)

    from sdfest_tpu.training.vae_trainer import VAETrainer as JVAETrainer

    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    mugs = np.stack([make_mug_family_sdf(64, **sample_mug_family(rng))[None]
                     for _ in range(2 * WORLD)]).astype(np.float32)
    vae_cfg = _vae_config()
    keys = jax.random.split(jax.random.PRNGKey(11), VAE_STEPS)
    draws = []
    with jax.enable_x64(False):
        jt = JVAETrainer(vae_cfg)
        for key in keys:
            shards = [_jax_draws_vae(jax.random.fold_in(key, i), 2)
                      for i in range(WORLD)]
            depth = np.concatenate([
                _jax_pc_depth(jt, mugs[2 * i:2 * i + 2], q)
                for i, (_, q) in enumerate(shards)])
            draws.append((np.concatenate([e for e, _ in shards]),
                          np.concatenate([q for _, q in shards]), depth))
    job = {
        "vae": dict(config=vae_cfg, weights=VAE_PATH, mugs=mugs,
                    draws=draws),
        "init": dict(config=_init_config(),
                     tree=_f64(msgpack_reader.load(INIT_PATH)),
                     batch=_f64(_init_batch())),
        "refine": _refine_jobs(),
        "train": dict(port=_free_port(), config=_train_config(tmp, mugs)),
    }
    job_path = tmp / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), coordinator,
         str(job_path), str(tmp)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for rank in range(WORLD)]
    try:
        refs = _references(job, keys, mugs)
    finally:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    results = []
    for rank in range(WORLD):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return dict(job=job, ranks=results, model_dir=tmp / "vae", **refs)


def _references(job, keys, mugs):
    """The JAX package's shard_map steps and sharded refine on a 2-device
    mesh, and the port's single-process counterparts."""
    import jax
    import jax.numpy as jnp

    from sdfest_torch.pipeline.pipeline import SDFPipeline
    from sdfest_torch.training.vae_trainer import VAETrainer
    from sdfest_torch.utils import msgpack_reader, weights
    from sdfest_tpu.parallel import mesh as jmesh
    from sdfest_tpu.parallel.estimation import (
        sharded_refine_batch as jsharded_refine_batch)
    from sdfest_tpu.pipeline.pipeline import SDFPipeline as JPipeline
    from sdfest_tpu.training.init_trainer import InitTrainer as JInitTrainer
    from sdfest_tpu.training.vae_trainer import VAETrainer as JVAETrainer
    from test_torch_training import _jtree

    out = {}
    vae = job["vae"]
    tree = msgpack_reader.load(vae["weights"])
    with jax.enable_x64(False):
        jt = JVAETrainer(vae["config"])
        params = _jtree(tree)
        state = {"params": params, "opt_state": jt.optimizer.init(params),
                 "iteration": jnp.zeros((), jnp.int32)}
        step = jmesh.shard_map_data_parallel_step(jt.step,
                                                  jmesh.make_mesh(WORLD))
        out["jax_vae_metrics"] = []
        for key in keys:
            state, metrics = step(state, jnp.asarray(mugs), key)
            out["jax_vae_metrics"].append(
                {k: float(v) for k, v in metrics.items()})
        out["jax_vae_params"] = jax.tree_util.tree_map(np.asarray,
                                                       state["params"])
    # the port's single process on the concatenated batch and draws
    t = VAETrainer(vae["config"], device="cpu")
    weights.load_flax_into(t.vae, tree)
    out["single_vae_grads"] = []
    for eps, quats, depth in vae["draws"]:
        t.step(torch.from_numpy(mugs), eps=torch.from_numpy(eps),
               quats=torch.from_numpy(quats),
               pc_depth=torch.from_numpy(depth))
        out["single_vae_grads"].append(_grads(t.vae))
    out["single_vae_params"] = weights.torch_to_flax(t.vae.state_dict())

    init = job["init"]
    with jax.enable_x64(True):
        jit_ = JInitTrainer(init["config"], latent_size=8)
        variables = _jtree(init["tree"])
        state = {"params": variables["params"],
                 "batch_stats": variables["batch_stats"],
                 "opt_state": jit_.optimizer.init(variables["params"]),
                 "iteration": jnp.zeros((), jnp.int32)}
        # the pmean'd gradient: the mean of each shard's gradient, each
        # shard normalizing with its own batch statistics (taken before the
        # step, which donates the state)
        grad = jax.jit(jax.grad(jit_._loss, has_aux=True))
        half = len(init["batch"]["pointset"]) // WORLD
        shards = [grad(state["params"], state["batch_stats"],
                       {k: jnp.asarray(v[i * half:(i + 1) * half])
                        for k, v in init["batch"].items()})[0]
                  for i in range(WORLD)]
        out["jax_init_grads"] = jax.tree_util.tree_map(
            lambda *g: np.mean([np.asarray(x) for x in g], axis=0), *shards)
        step = jmesh.shard_map_data_parallel_step(jit_.step,
                                                  jmesh.make_mesh(WORLD))
        new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                          init["batch"].items()})
        out["jax_init_state"] = jax.tree_util.tree_map(np.asarray, new_state)
        out["jax_init_metrics"] = {k: float(v) for k, v in metrics.items()}

    refine = job["refine"]
    out["jax_refine"], out["single_refine"] = {}, {}
    for name, (config, kwargs) in refine["runs"].items():
        jpipe = JPipeline(dict(config, fused_call=False))
        out["jax_refine"][name] = jsharded_refine_batch(
            jpipe, {k: jnp.asarray(v) for k, v in refine["states"].items()},
            *(jnp.asarray(v) for v in refine["views"]),
            mesh=jmesh.make_mesh(WORLD), **kwargs)
        pipe = SDFPipeline(config, device="cpu")
        out["single_refine"][name] = pipe.refine_batch(
            {k: torch.from_numpy(v) for k, v in refine["states"].items()},
            *(torch.from_numpy(v) for v in refine["views"]), **kwargs)
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3])
def test_work_list_helpers_equal_jax(tmp_path, n):
    from sdfest_torch.parallel import distributed as dist
    from sdfest_tpu.parallel import distributed as jdist

    items = [f"mesh_{i}.obj" for i in range(7)]
    paths = []
    for pid in range(n):
        got = dist.shard_work_list(items, pid, n)
        assert got == jdist.shard_work_list(items, pid, n)
        path = dist.partial_result_path(str(tmp_path), "run", pid)
        assert path == jdist.partial_result_path(str(tmp_path), "run", pid)
        dist.save_partial_results(path, [{"item": i} for i in got])
        paths.append(path)
    merged = dist.merge_partial_results(paths)
    assert merged == jdist.merge_partial_results(paths)
    assert sorted(m["item"] for m in merged) == items
    # without a group the process is rank 0 of 1
    assert dist.shard_work_list(items) == items


def test_two_ranks_see_their_group(runs):
    r0, r1 = runs["ranks"]
    assert (r0["rank"], r0["world"], r1["rank"], r1["world"]) == (0, 2, 1, 2)
    assert r0["work"] == [0, 2, 4, 6] and r1["work"] == [1, 3, 5]
    # shard_batch takes the contiguous block, as P("dp") splits
    np.testing.assert_array_equal(r0["shard"], [[0, 1], [2, 3]])
    np.testing.assert_array_equal(r1["shard"], [[4, 5], [6, 7]])
    # replicate broadcasts rank 0's values
    for r in (r0, r1):
        np.testing.assert_array_equal(r["replicated"], np.zeros(3))


def test_vae_data_parallel_steps_match_jax_shard_map(runs):
    """Two ranks x batch 2 of the committed mug VAE, 2 steps: the
    parameters within 1e-5 absolute of the JAX package's shard_map steps
    on its 2-device mesh (the bar of ``test_vae_trainer_adam_steps_match_
    jax``), and of the port's single process on the concatenated batch and
    draws; both ranks hold the same parameters; the first step's loss terms
    (summed over the ranks) within rtol 1e-5 of the JAX step's psum'd
    metrics (the bar of ``test_vae_trainer_loss_terms_and_gradients_match_
    jax``; the second step's are taken at parameters that differ by up to
    1e-5 already)."""
    r0, r1 = runs["ranks"]
    for path, want in _leaves(runs["jax_vae_params"]):
        np.testing.assert_allclose(_at(r0["vae_params"], path), want,
                                   atol=1e-5, err_msg=str(path))
    for path, want in _leaves(runs["single_vae_params"]):
        np.testing.assert_allclose(_at(r0["vae_params"], path), want,
                                   atol=1e-5, err_msg=str(path))
        np.testing.assert_array_equal(_at(r1["vae_params"], path),
                                      _at(r0["vae_params"], path))
    got, want = r0["vae_metrics"][0], runs["jax_vae_metrics"][0]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(got["loss_pc"]) > 0
    assert all(np.isfinite(float(v)) for m in r0["vae_metrics"]
               for v in m.values())


def test_vae_data_parallel_gradients_are_summed(runs):
    """Each step's reduced gradients (the sum over the ranks, JAX's psum)
    equal the port's single process's on the concatenated batch and draws,
    every leaf within 1e-4 of its largest magnitude (the bar of
    ``test_vae_trainer_loss_terms_and_gradients_match_jax``); both ranks
    hold the same gradients.  A mean over the ranks would be off by half:
    the parameters alone cannot show it, since Adam's update does not
    change when every gradient is scaled alike."""
    from test_torch_training import _assert_tree_close

    r0, r1 = runs["ranks"]
    assert len(r0["vae_grads"]) == len(runs["single_vae_grads"]) == VAE_STEPS
    for got, other, want in zip(r0["vae_grads"], r1["vae_grads"],
                                runs["single_vae_grads"]):
        _assert_tree_close(got, want, 1e-4)
        for path, g in _leaves(got):
            np.testing.assert_array_equal(_at(other, path), g)


def test_init_data_parallel_gradients_are_averaged(runs):
    """The reduced gradients (the mean over the ranks, JAX's pmean) in
    float64 equal the mean of the JAX package's gradients of each shard,
    each normalizing with its own batch statistics, every leaf within 1e-4
    of its largest magnitude (``_assert_grads_close``, the bar of
    ``test_init_trainer_step_matches_jax_with_flax_batchnorm``); both ranks
    hold the same gradients.  A sum over the ranks would be off by two."""
    from test_torch_training import _assert_grads_close

    r0, r1 = runs["ranks"]
    _assert_grads_close(r0["init_grads"], runs["jax_init_grads"], 1e-4)
    for path, g in _leaves(r0["init_grads"]):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(_at(r1["init_grads"], path), g)


def test_init_data_parallel_step_matches_jax_shard_map(runs):
    """Two ranks x batch 2 in float64: each rank normalizes with its local
    batch statistics; the gradients, loss terms and BatchNorm running
    statistics are averaged.  Against the JAX package's shard_map step
    (pmean): each running statistic within 1e-10 of its leaf's largest
    magnitude (the variances reach ~300; measured 1.3e-11: the batch
    statistics of the head's later layers carry the rounding of every layer
    before them), the loss terms rtol
    1e-10, the parameters after the Adam step within 1e-6 (the bar of
    ``test_init_trainer_step_matches_jax_with_flax_batchnorm``: Adam's first
    update ``lr g / (|g| + eps)`` multiplies a gradient's rounding by up to
    ``lr / (4 eps)`` = 2.5e4 where ``|g|`` is near ``eps``, so two float64
    sums in different orders part by ~1e-9 there); both ranks equal."""
    r0, r1 = runs["ranks"]
    want = runs["jax_init_state"]
    for part in ("params", "batch_stats"):
        for path, w in _leaves(want[part]):
            g = _at(r0["init_state"][part], path)
            assert g.dtype == np.float64
            tol = 1e-6 if part == "params" else 1e-10 * np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                       err_msg=f"{part} {path}")
            np.testing.assert_array_equal(_at(r1["init_state"][part], path),
                                          g)
    assert set(r0["init_metrics"]) == set(runs["jax_init_metrics"])
    for k, w in runs["jax_init_metrics"].items():
        np.testing.assert_allclose(float(r0["init_metrics"][k]), w,
                                   rtol=1e-10, err_msg=k)


def test_train_vae_data_parallel_under_torchrun_env(runs):
    """train_vae with WORLD_SIZE 2 (torchrun's variables): both ranks take
    the same 2 summed steps (equal parameters), and one writer (rank 0)
    leaves one checkpoint, the model, its config and the scalars."""
    r0, r1 = runs["ranks"]
    assert r0["train_iteration"] == r1["train_iteration"] == 2
    for path, g in _leaves(r0["train_params"]):
        np.testing.assert_array_equal(_at(r1["train_params"], path), g)
    files = sorted(os.listdir(runs["model_dir"]))
    assert files == ["2.ckpt", "2.ckpt.meta.json", "dp.msgpack", "dp.yaml",
                     "scalars.csv"], files


@pytest.mark.parametrize("name", ["plain", "roi_multires"])
def test_sharded_refine_batch_matches_jax_and_unsharded(runs, name):
    """4 hypotheses over 2 ranks, gathered to all 4 on every rank in
    hypothesis order: against the JAX package's sharded_refine_batch on its
    2-device mesh by ``_assert_matches_jax`` (loss rtol 1e-4, states 1e-4),
    and against the port's unsharded refine_batch within 1e-6."""
    from test_torch_batch import _assert_matches_jax

    r0, r1 = runs["ranks"]
    got = tuple({k: torch.from_numpy(np.asarray(v)) for k, v in part.items()}
                for part in r0["refine"][name])
    _assert_matches_jax(got, runs["jax_refine"][name])
    single = runs["single_refine"][name]
    assert got[2]["loss"].shape == (4, 5)
    for g, s, other in zip(got, single, r1["refine"][name]):
        assert set(g) == set(s)
        for k in s:
            assert g[k].shape == s[k].shape, k
            np.testing.assert_allclose(g[k].numpy(), s[k].numpy(),
                                       atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(np.asarray(other[k]),
                                          g[k].numpy())


def test_sharded_refine_batch_needs_a_multiple_of_the_ranks():
    from sdfest_torch.parallel.estimation import sharded_refine_batch
    from sdfest_torch.parallel.mesh import Mesh

    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    states = {"position": torch.zeros(3, 1, 3)}
    with pytest.raises(ValueError, match="do not divide"):
        sharded_refine_batch(None, states, None, None, None, None, None,
                             mesh=mesh)


def test_initialize_distributed_on_cuda_raises_without_cuda():
    from sdfest_torch.parallel import distributed as dist

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.initialize_distributed("localhost:1", 1, 0, device="cuda")


def test_make_hypothesis_states_equals_jax_formula():
    """Given JAX's draws, the port's formula equals JAX's
    make_hypothesis_states within 1e-6 (JAX in float32), in JAX's shapes;
    from a generator, hypothesis 0 is the estimate (its quaternion within
    1e-7: renormalized) and every quaternion is unit."""
    import jax
    import jax.numpy as jnp

    from sdfest_torch.parallel.estimation import (
        hypothesis_states_from_draws, make_hypothesis_states)
    from sdfest_tpu.ops import quaternion as jquaternion
    from sdfest_tpu.parallel.estimation import (
        make_hypothesis_states as jmake)

    n = 5
    position = np.asarray([[0.02, -0.01, -0.45]], np.float32)
    orientation = np.asarray([[0.1, 0.2, 0.0, 0.97]], np.float32)
    orientation /= np.linalg.norm(orientation)
    scale = np.asarray([0.12], np.float32)
    latent = np.linspace(-1, 1, 8, dtype=np.float32)[None]
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        want = jmake(*(jnp.asarray(x) for x in (position, orientation, scale,
                                                 latent)), n, key)
        k1, k2 = jax.random.split(key)
        pos_draws = np.array(jax.random.normal(k1, (n,) + position.shape))
        quat_draws = np.array(jquaternion.random_uniform(k2, (n,)))
    t = [torch.from_numpy(x) for x in (position, orientation, scale, latent)]
    got = hypothesis_states_from_draws(*t, torch.from_numpy(pos_draws),
                                       torch.from_numpy(quat_draws))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == np.shape(want[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, err_msg=k)
    drawn = make_hypothesis_states(*t, n, torch.Generator().manual_seed(0))
    for k in want:
        assert tuple(drawn[k].shape) == np.shape(want[k]), k
    np.testing.assert_array_equal(drawn["position"][0].numpy(), position)
    # hypothesis 0's quaternion is the estimate's, renormalized
    np.testing.assert_allclose(drawn["orientation"][0].numpy(), orientation,
                               atol=1e-7)
    np.testing.assert_allclose(torch.linalg.norm(drawn["orientation"], dim=-1)
                               .numpy(), 1.0, atol=1e-6)
    moved = drawn["position"][1:] - drawn["position"][0]
    assert float(moved.abs().max()) > 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
