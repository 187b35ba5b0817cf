"""CPU tests of the trainers' single programs: ``VAETrainer.train_step`` and
``make_chained_step``, ``InitTrainer.train_step``, ``make_chained_step`` and
``make_replay_chained_step`` (the counterparts of the JAX package's jitted
steps and ``steps_per_dispatch`` chains), the ring's device cursor, the
bodies as graphs on the stand-in backend of ``test_torch_graphs.py``, and
``steps_per_dispatch`` in the training scripts.

The chains are held against the JAX package's chained programs on its own
draws: every test recomputes the draws from the JAX package's key splits
and feeds them into the port.  The VAE runs in float32 (JAX under
``jax.enable_x64(False)``; ``tests/conftest.py`` turns x64 on for the rest
of the suite), the init network in float64 on both sides, as
``test_torch_training.py`` holds them.  Tolerances are stated where they
are used.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfest_tpu.training.init_trainer import InitTrainer as JInitTrainer
from sdfest_tpu.training.vae_trainer import VAETrainer as JVAETrainer
from sdfest_torch.datasets.generated import SDFVAEViewDataset
from sdfest_torch.models.vae import create_vae_from_config
from sdfest_torch.render import kernels
from sdfest_torch.scripts import train_init, train_vae
from sdfest_torch.training.init_trainer import InitTrainer
from sdfest_torch.training.optim import Adam
from sdfest_torch.training.vae_trainer import VAETrainer
from sdfest_torch.utils import checkpoint, graphs, msgpack_reader, weights
from sdfest_torch.utils.presets import preset
from sdfest_torch.utils.scenes import make_mug_family_sdf, sample_mug_family
from test_torch_graphs import FakeGraphs, lifted
from test_torch_train_scripts import _init_config as _script_init_config
from test_torch_train_scripts import _vae_config as _script_vae_config
from test_torch_training import (
    INIT_PATH,
    VAE_PATH,
    _f64,
    _jax_draws_vae,
    _jax_pc_depth,
    _jtree,
    _np,
)

# the VAE chain: parameters 1e-5 absolute (as
# test_vae_trainer_adam_steps_match_jax); the first step's loss terms 1e-5
# relative.  The later steps' terms 5e-5 relative: in float32 the JAX
# package computes Adam's ``1 - 0.999 ** count`` in float32 (1 - 0.999f =
# 9.99987e-4, 1.3e-5 away from 1e-3), the port in float64 rounded once, as
# the pipeline's Adam; so every update of the first step differs by 6.4e-6
# of itself, and the loss after it (which that step moved ~20x) by ~1.3e-5
VAE_PARAM_ATOL, VAE_METRIC_RTOL, VAE_LATER_RTOL = 1e-5, 1e-5, 5e-5
# an element whose gradient is float32 rounding noise takes Adam steps of up
# to lr whose sign is that noise's: at most this share of a leaf's elements
# may leave VAE_PARAM_ATOL, and by no more than lr per step
NOISE_SHARE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (as in
    ``test_torch_batch.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def vae_tree():
    return msgpack_reader.load(VAE_PATH)


@pytest.fixture(scope="module")
def mugs():
    rng = np.random.default_rng(0)
    return np.stack([make_mug_family_sdf(64, **sample_mug_family(rng))[None]
                     for _ in range(3)]).astype(np.float32)


def _vae_config(**overrides):
    config = preset("vae_mug_procedural")
    config.update(pc_render_width=64, pc_render_height=48, **overrides)
    return config


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# the VAE chain against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,tsdf", [(0, False), (999, 0.1)],
                         ids=["fresh", "across_warm_up"])
def test_vae_chained_step_matches_jax(mugs, vae_tree, monkeypatch, start,
                                      tsdf):
    """K = 3 chained steps on a dataset held on the device, against
    ``VAETrainer.make_chained_step``; from iteration 999 with a TSDF the
    third step is past the warm-up (inputs clamped, KLD weighted) inside
    the dispatch, as the JAX scan switches."""
    cfg = _vae_config(tsdf=tsdf)
    k, batch = 3, 2
    key = jax.random.PRNGKey(13)
    with jax.enable_x64(False):
        jt = JVAETrainer(cfg)
        params = _jtree(vae_tree)
        state = {"params": params, "opt_state": jt.optimizer.init(params),
                 "iteration": jnp.asarray(start, jnp.int32)}
        chained = jt.make_chained_step(jnp.asarray(mugs), batch, k)
        state, stacked = chained(state, jnp.asarray(mugs), key)
        want = jax.tree_util.tree_map(np.asarray, state["params"])
        stacked = {name: _np(v) for name, v in stacked.items()}
        # the chain's draws (vae_trainer.py:241-248) and pc renders
        indices, draws, depths = [], [], []
        for i, subkey in enumerate(jax.random.split(key, k)):
            k_idx, k_step = jax.random.split(subkey)
            idx = np.asarray(jax.random.randint(k_idx, (batch,), 0,
                                                len(mugs)))
            eps, quats = _jax_draws_vae(k_step, batch)
            x = mugs[idx]
            if tsdf and start + i > JVAETrainer.WARM_UP_ITERATIONS:
                x = np.clip(x, -tsdf, tsdf)
            indices.append(torch.from_numpy(idx.copy()))
            draws.append((torch.from_numpy(eps), torch.from_numpy(quats)))
            depths.append(torch.from_numpy(_jax_pc_depth(jt, x, quats)))
    assert int(state["iteration"]) == start + k
    t = VAETrainer(cfg, device="cpu")
    weights.load_flax_into(t.vae, vae_tree)
    t.iteration = start
    it_idx, it_draw, it_depth = iter(indices), iter(draws), iter(depths)
    monkeypatch.setattr(t, "indices", lambda n, b, g: next(it_idx))
    monkeypatch.setattr(t, "draws", lambda b, g: next(it_draw))
    monkeypatch.setattr(t, "pc_depth", lambda x, q: next(it_depth))
    got = t.make_chained_step(torch.from_numpy(mugs), batch, k)(
        torch.from_numpy(mugs))
    assert t.iteration == start + k and int(t._count) == start + k
    assert set(got) == set(stacked)
    for name, w in stacked.items():
        assert got[name].shape == (k,)
        np.testing.assert_allclose(got[name][:1].numpy(), w[:1],
                                   rtol=VAE_METRIC_RTOL, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got[name][1:].numpy(), w[1:],
                                   rtol=VAE_LATER_RTOL, atol=1e-6,
                                   err_msg=name)
    if tsdf:  # the KLD enters the loss at the third step only
        rest = got["loss"] - sum(
            cfg.get(f"{name}_weight", default) * got[f"loss_{name}"]
            for name, default in (("l2_small", 1.0), ("l2_large", 1.0),
                                  ("l1_small", 0.0), ("l1_large", 0.0),
                                  ("pc", 0.0)))
        kld = cfg.get("kld_weight", 1.0) * got["loss_kld"]
        torch.testing.assert_close(rest, torch.stack(
            [torch.zeros(()), torch.zeros(()), kld[2]]), rtol=1e-4,
            atol=1e-4 * float(got["loss"].abs().max()))
        assert float(kld[2]) > 0
    _assert_params_close(weights.torch_to_flax(t.vae.state_dict()), want,
                         VAE_PARAM_ATOL, k * cfg["learning_rate"])


def _assert_params_close(got, want, atol, steps_bound, share=NOISE_SHARE,
                         noise=lambda path: False):
    """Every leaf within ``atol``, but for at most ``share`` of its elements
    (and one) and the leaves ``noise`` names, which stay within
    ``steps_bound`` (lr per step)."""
    for path, w in msgpack_reader.leaves(want):
        d = np.abs(np.asarray(_leaf(got, path)) - np.asarray(w))
        if not noise(path):
            assert (d > atol).sum() <= max(1, share * d.size), path
        assert d.max() <= steps_bound, path


# ---------------------------------------------------------------------------
# the init chains against the JAX package's
# ---------------------------------------------------------------------------

POINTS, GEN_BATCH, TRAIN_BATCH, CAPACITY = 200, 4, 4, 8
# the init network in float64 on both sides.  The first step's losses within
# 1e-10 relative (as test_init_trainer_step_matches_jax_with_flax_
# batchnorm).  After it the two runs part by rounding noise that the
# network amplifies: a bias that feeds a training-mode BatchNorm has
# gradient 0 in exact arithmetic, so Adam steps it by the sign of rounding
# noise (at most lr per step), which moves the BatchNorms' inputs by up to
# 2 lr, and an element whose gradient is rounding noise takes steps of up
# to lr too (batches of 4 drawn from 4 rows repeat rows).  So the later
# losses and the running variances within 1e-5 relative, the running means
# within 0.1 lr per step (flax's momentum share), the parameters within
# 1e-5 absolute (1% of one Adam step) but for at most INIT_NOISE_SHARE of a
# leaf's elements and those biases, within lr per step
INIT_NOISE_SHARE = 1e-3
INIT_LOSS_RTOL, INIT_LATER_RTOL, INIT_ATOL = 1e-10, 1e-5, 1e-5


def _init_net_config():
    cfg = preset("init_mug_procedural_v3")
    cfg["head"].update(orientation_repr="discretized",
                       orientation_grid_resolution=1)
    return cfg


class _JaxBatches:
    """A generation stream for the JAX package's chains whose batches are a
    function of the key alone (the generated dataset's march and the
    port's part by up to two termination bands, more than a float64
    comparison can absorb; the views themselves are held to the JAX
    package's in test_torch_training.py)."""

    def sample_batch(self, key, n):
        """Integers scaled by powers of two: exact whatever XLA fuses."""
        k = jax.random.split(key, 5)

        def grid(kk, shape, lo, hi, scale):
            return jax.random.randint(kk, shape, lo, hi).astype(
                jnp.float32) * scale

        return {
            "pointset": grid(k[0], (n, POINTS, 3), -2 ** 10, 2 ** 10,
                             2.0 ** -14),
            "latent_shape": grid(k[1], (n, 8), -2 ** 8, 2 ** 8, 2.0 ** -7),
            "position": grid(k[2], (n, 3), -2 ** 8, 2 ** 8, 2.0 ** -12),
            "scale": grid(k[3], (n,), 2 ** 8, 2 ** 9, 2.0 ** -12),
            "orientation": jax.random.randint(k[4], (n,), 0, 576),
        }


class _PortBatches:
    """The port's side of :class:`_JaxBatches`: ``draw`` hands out the JAX
    stream's batches in order, ``views_from_draws`` passes them through."""

    def __init__(self, batches):
        self._batches = iter(batches)

    def draw(self, n, generator=None):
        return next(self._batches)

    def views_from_draws(self, draws):
        return dict(draws)


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _init_pair(tree):
    """A float64 JAX state and a float64 port trainer from ``tree``."""
    cfg = _init_net_config()
    jt = JInitTrainer(cfg, latent_size=8)
    variables = _jtree(tree)
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": jt.optimizer.init(variables["params"]),
             "iteration": jnp.zeros((), jnp.int32)}
    t = InitTrainer(cfg, latent_size=8, device="cpu")
    weights.load_flax_into(t.net, tree)
    t.net.double()
    return jt, state, t


def _assert_init_state_close(t, want, lr, steps):
    got = weights.torch_to_flax(t.net.state_dict())
    for path, w in msgpack_reader.leaves(want["batch_stats"]):
        mean = path[-1] == "mean"
        np.testing.assert_allclose(
            _leaf(got["batch_stats"], path), w,
            rtol=0 if mean else INIT_LATER_RTOL,
            atol=0.1 * steps * lr if mean else 0, err_msg=str(path))
    _assert_params_close(got["params"], want["params"], INIT_ATOL,
                         steps * lr, INIT_NOISE_SHARE,
                         lambda path: path[-2].startswith("linear_")
                         and path[-1] == "bias")
    adam = want["opt_state"][0]
    assert all(int(t.optimizer.state[p]["step"]) == int(adam.count) == steps
               for p in t.optimizer.params())


def _assert_metrics_close(got, want, n):
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == (n,)
        w = np.asarray(w)
        np.testing.assert_allclose(got[name][:1].numpy(), w[:1],
                                   rtol=INIT_LOSS_RTOL, err_msg=name)
        np.testing.assert_allclose(got[name][1:].numpy(), w[1:],
                                   rtol=INIT_LATER_RTOL, err_msg=name)


def test_init_chained_step_matches_jax():
    """K = 2 steps of generation and training, against
    ``InitTrainer.make_chained_step`` on the same stream."""
    tree = _f64(msgpack_reader.load(INIT_PATH))
    key = jax.random.PRNGKey(21)
    k = 2
    with jax.enable_x64(True):
        jt, state, t = _init_pair(tree)
        jds = _JaxBatches()
        state, stacked = jt.make_chained_step(jds, GEN_BATCH, k)(state, key)
        want = jax.tree_util.tree_map(np.asarray, state)
        batches = [_port_batch(jds.sample_batch(sk, GEN_BATCH))
                   for sk in jax.random.split(key, k)]
    got = t.make_chained_step(_PortBatches(batches), GEN_BATCH, k)()
    assert t.iteration == k
    _assert_metrics_close(got, stacked, k)
    _assert_init_state_close(t, want, t.config["learning_rate"], k)


def test_init_replay_chained_step_matches_jax():
    """K = 2 replay units of one generation batch and 2 steps each (ring
    of 8, generation batch 4), against
    ``InitTrainer.make_replay_chained_step``: the parameters, batch
    statistics, the ring's rows, cursor and fill level and the flattened
    metrics.  The ring's rows are injected as the uniforms ``(row + 0.5) /
    filled`` of JAX's ``randint(0, filled)`` draws."""
    tree = _f64(msgpack_reader.load(INIT_PATH))
    key = jax.random.PRNGKey(22)
    k, t_train = 2, 2
    with jax.enable_x64(True):
        jt, state, t = _init_pair(tree)
        jds = _JaxBatches()
        buffer = jt.init_replay_buffer(CAPACITY, POINTS, 8)
        chained = jt.make_replay_chained_step(jds, GEN_BATCH, TRAIN_BATCH,
                                              t_train, k)
        (state, buffer), stacked = chained(state, buffer, key)
        want = jax.tree_util.tree_map(np.asarray, state)
        want_ring = jax.tree_util.tree_map(np.asarray, buffer)
        batches, uniforms = [], []
        for unit, subkey in enumerate(jax.random.split(key, k)):
            kgen, ktrain = jax.random.split(subkey)
            batches.append(_port_batch(jds.sample_batch(kgen, GEN_BATCH)))
            filled = min(GEN_BATCH * (unit + 1), CAPACITY)
            for sk in jax.random.split(ktrain, t_train):
                rows = np.asarray(jax.random.randint(
                    sk, (TRAIN_BATCH,), 0, jnp.asarray(filled, jnp.int32)))
                uniforms.append(torch.from_numpy(
                    ((rows + 0.5) / filled).astype(np.float32)))
    ring = t.init_replay_buffer(CAPACITY, POINTS, 8)
    it = iter(uniforms)
    ring.uniforms = lambda n, g: next(it)
    got = t.make_replay_chained_step(_PortBatches(batches), GEN_BATCH,
                                     TRAIN_BATCH, t_train, k)(ring)
    assert t.iteration == k * t_train
    _assert_metrics_close(got, stacked, k * t_train)
    _assert_init_state_close(t, want, t.config["learning_rate"],
                             k * t_train)
    assert int(ring.cursor) == int(want_ring["cursor"]) == 0
    assert int(ring.filled) == int(want_ring["filled"]) == CAPACITY
    for name, store in ring.store.items():
        np.testing.assert_array_equal(
            store.to(torch.float32).numpy() if name == "pointset"
            else store.numpy(),
            want_ring[name].astype(np.float32) if name == "pointset"
            else want_ring[name], err_msg=name)


def test_ring_cursor_wraps_and_filled_saturates_on_the_device():
    """Three writes into a ring of twice the generation batch: the cursor
    (int32 on the device) goes 4, 0, 4, the fill level 4, 8, 8; each write
    lands at the cursor it found; row draws stay inside the filled part."""
    t = InitTrainer(_init_net_config(), latent_size=8, device="cpu")
    ring = t.init_replay_buffer(2 * GEN_BATCH, 16, 8)
    assert ring.cursor.dtype == ring.filled.dtype == torch.int32
    cursors, fills = [], []
    for i in range(3):
        batch = {"pointset": torch.full((GEN_BATCH, 16, 3), float(i + 1)),
                 "latent_shape": torch.full((GEN_BATCH, 8), float(i + 1)),
                 "position": torch.zeros(GEN_BATCH, 3),
                 "scale": torch.full((GEN_BATCH,), float(i + 1)),
                 "orientation": torch.full((GEN_BATCH,), i + 1)}
        ring.write(batch)
        cursors.append(int(ring.cursor))
        fills.append(int(ring.filled))
        if i == 0:  # half filled: draws only from the first rows
            u = torch.linspace(0.0, 1.0 - 2 ** -24, 101)
            rows = ring.rows(u)
            assert int(rows.min()) == 0 and int(rows.max()) == GEN_BATCH - 1
    assert cursors == [4, 0, 4] and fills == [4, 8, 8]
    # the third write overwrote the first batch's rows
    torch.testing.assert_close(ring.store["scale"], torch.tensor(
        [3.0] * GEN_BATCH + [2.0] * GEN_BATCH))
    assert ring.store["orientation"].tolist() == [3] * 4 + [2] * 4
    rows = ring.rows(torch.tensor([0.0, 0.49, 0.5, 1.0 - 2 ** -24]))
    assert rows.tolist() == [0, 3, 4, 7]
    with pytest.raises(ValueError, match="multiple"):
        ring.write({k: v[:3] for k, v in batch.items()})


# ---------------------------------------------------------------------------
# the bodies as graphs (the stand-in backend of test_torch_graphs.py)
# ---------------------------------------------------------------------------


@pytest.fixture()
def counted_kernels(monkeypatch):
    """The kernel wrappers with the host-read guard lifted (on the CPU they
    run their plain versions) and counting their launches as the card's
    wrappers do."""
    def counting(name, fn):
        def call(*args, **kwargs):
            kernels.KERNELS[name].launches += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in kernels.KERNELS.items():
        monkeypatch.setattr(kernels, name, counting(name, lifted(fn)))
    kernels.reset_launches()
    yield
    kernels.reset_launches()


def _graph_cache():
    return graphs.GraphCache(FakeGraphs(),
                             warm_up_runs=graphs.TRAIN_WARM_UP_RUNS)


def _vae_pair(vae_tree, **overrides):
    pair = []
    for _ in range(2):
        t = VAETrainer(_vae_config(**overrides), device="cpu")
        weights.load_flax_into(t.vae, vae_tree)
        pair.append(t)
    pair[0].graphs = _graph_cache()
    return pair


def _views_config(**overrides):
    cfg = dict(preset("init_mug_procedural_v3")["datasets"][
        "generated_dataset"]["config_dict"], width=64, height=48,
        num_points=100, orientation_repr="discretized",
        orientation_grid_resolution=1)
    cfg.update(overrides)
    return cfg


def _init_graph_pair(vae_tree):
    """Two init trainers from one seed (the first on the stand-in graph
    backend) and a generated dataset at 64x48."""
    cfg = _init_net_config()
    cfg["backbone"]["mlp_out_sizes"] = [16, 32]
    cfg["head"].update(in_size=32, mlp_out_sizes=[16])
    pair = []
    for _ in range(2):
        torch.manual_seed(0)
        pair.append(InitTrainer(cfg, latent_size=8, device="cpu"))
    pair[0].graphs = _graph_cache()
    vae = create_vae_from_config(preset("vae_mug_procedural"))
    weights.load_flax_into(vae, vae_tree)
    ds = SDFVAEViewDataset(_views_config(), vae.decoder.eval(),
                           device="cpu")
    return pair, ds


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["iteration"] == sb["iteration"]
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    for p, q in zip(a.optimizer.params(), b.optimizer.params()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key]), key


def _dispatch_twice(graph, eager, run):
    """``run(trainer, generator)`` twice on each trainer from equal
    generators: the graph's metrics, launch counts and state equal the
    eager loop's bit for bit; the first dispatch captures, the second
    replays."""
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    for turn in range(2):
        kernels.reset_launches()
        got = run(graph, gens[0])
        graph_counts = kernels.counts()
        kernels.reset_launches()
        want = run(eager, gens[1])
        assert kernels.counts() == graph_counts, turn
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (turn, k)
        _assert_same_state(graph, eager)
    assert graph.graphs.captures == 1 and graph.graphs.replays == 2
    assert graph.graphs.backend.captured == 1
    return graph_counts


@pytest.mark.parametrize("path", ["step", "chain"])
def test_vae_bodies_make_no_host_read_and_equal_eager(mugs, vae_tree,
                                                      counted_kernels, path):
    """``train_step`` and a chain of K = 2 as graphs: each body captured
    under the guard (no host read, no tensor made from host data), then
    replayed; both dispatches equal the eager loop bit for bit, and each
    replay adds the capture's launches: per step one march, one
    sample-grad and one scatter."""
    graph, eager = _vae_pair(vae_tree)
    data = torch.from_numpy(mugs)
    if path == "step":
        run = lambda t, g: t.train_step(data[:2], g)
        steps = 1
    else:
        chains = {id(t): t.make_chained_step(data, 2, 2)
                  for t in (graph, eager)}
        run = lambda t, g: chains[id(t)](data, g)
        steps = 2
    counts = _dispatch_twice(graph, eager, run)
    assert {k: v for k, v in counts["launches"].items() if v} == {
        "march": steps, "sample_grad": steps, "scatter": steps}
    assert graph.iteration == int(graph._count) == 2 * steps


@pytest.mark.parametrize("path", ["step", "chain", "replay"])
def test_init_bodies_make_no_host_read_and_equal_eager(vae_tree,
                                                       counted_kernels,
                                                       path):
    """The init trainer's ``train_step``, a chain of K = 2 generation and
    training steps and a replay chain of K = 2 units of 2 steps (ring of 8,
    generation batch 4) as graphs on the generated views: no host read in
    the captured bodies, equal to the eager loop bit for bit (parameters,
    BatchNorm statistics, Adam's state, the ring and its cursor), one march
    per generation batch."""
    (graph, eager), ds = _init_graph_pair(vae_tree)
    if path == "step":
        batch = ds.sample_batch(4, torch.Generator().manual_seed(1))
        run = lambda t, g: t.train_step(batch)
        marches = 0
    elif path == "chain":
        chains = {id(t): t.make_chained_step(ds, 4, 2)
                  for t in (graph, eager)}
        run = lambda t, g: chains[id(t)](g)
        marches = 2
    else:
        rings = {id(t): t.init_replay_buffer(8, 100, 8)
                 for t in (graph, eager)}
        chains = {id(t): t.make_replay_chained_step(ds, 4, 4, 2, 2)
                  for t in (graph, eager)}
        run = lambda t, g: chains[id(t)](rings[id(t)], g)
        marches = 2
    counts = _dispatch_twice(graph, eager, run)
    assert {k: v for k, v in counts["launches"].items() if v} == (
        {"march": marches} if marches else {})
    if path == "replay":
        ring, want = rings[id(graph)], rings[id(eager)]
        for a, b in zip(ring.tensors(), want.tensors()):
            assert torch.equal(a, b)
        assert int(ring.cursor) == 0 and int(ring.filled) == 8
        assert graph.iteration == 8


# ---------------------------------------------------------------------------
# the optimizer's state and the scripts
# ---------------------------------------------------------------------------


def test_checkpoint_of_torch_adam_loads_and_steps(tmp_path):
    """A checkpoint written with ``torch.optim.Adam`` (the trainers'
    optimizer before the count moved to the device) loads: its moments
    carry over and its float count becomes the int32 count; the next step
    is optax's third step."""
    cfg = _init_net_config()
    cfg["backbone"]["mlp_out_sizes"] = [16, 32]
    cfg["head"].update(in_size=32, mlp_out_sizes=[16])
    torch.manual_seed(0)
    t = InitTrainer(cfg, latent_size=8, device="cpu")
    old = torch.optim.Adam(t.net.parameters(), lr=1e-3)
    rng = np.random.default_rng(0)
    batch = {"pointset": torch.from_numpy(rng.normal(
        0, 0.05, (4, 50, 3)).astype(np.float32)),
        "latent_shape": torch.zeros(4, 8), "position": torch.zeros(4, 3),
        "scale": torch.ones(4), "orientation": torch.arange(4)}
    for _ in range(2):
        old.zero_grad()
        t.loss(batch)[0].backward()
        old.step()
    path = str(tmp_path / "old.ckpt")
    torch.save({"model": t.net.state_dict(), "optimizer": old.state_dict(),
                "iteration": 2}, path)
    u = InitTrainer(cfg, latent_size=8, device="cpu")
    assert checkpoint.load_checkpoint(path, u)["iteration"] == 2
    for p, q in zip(old.param_groups[0]["params"], u.optimizer.params()):
        st = u.optimizer.state[q]
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 2
        assert torch.equal(st["exp_avg"], old.state[p]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], old.state[p]["exp_avg_sq"])
    u.train_step(batch)
    assert all(int(u.optimizer.state[q]["step"]) == 3
               for q in u.optimizer.params())
    assert isinstance(u.optimizer, Adam)


def test_train_vae_chains_steps_per_dispatch(tmp_path, capsys):
    """``steps_per_dispatch: 3`` uploads the dataset and chains: 7
    iterations as dispatches of 3, 3 and 1 steps; checkpoints at 2, 4 and 6
    (inside dispatches, under their own iterations); a resume from 4 runs
    one dispatch of 3 to 7.  Past ``device_dataset_max_mb`` one step per
    dispatch."""
    config = _script_vae_config(tmp_path, steps_per_dispatch=3,
                                iterations=7, checkpoint_iteration=2)
    out = train_vae.train(copy.deepcopy(config), device="cpu")
    assert "3 steps per dispatch" in capsys.readouterr().out
    assert out["trainer"].iteration == int(out["trainer"]._count) == 7
    model_dir = tmp_path / "vae"
    assert sorted(f for f in os.listdir(model_dir) if f.endswith(".ckpt")
                  ) == ["2.ckpt", "4.ckpt", "6.ckpt"]
    assert torch.load(model_dir / "2.ckpt")["iteration"] == 2
    resumed = train_vae.train(dict(copy.deepcopy(config),
                                   checkpoint=str(model_dir / "4.ckpt")),
                              device="cpu")["trainer"]
    assert resumed.iteration == 7
    small = dict(copy.deepcopy(config), device_dataset_max_mb=1,
                 iterations=2, checkpoint_iteration=0)
    assert train_vae.train(small, device="cpu")["trainer"].iteration == 2
    assert "one step per dispatch" in capsys.readouterr().out


@pytest.mark.parametrize("replay", [False, True], ids=["fresh", "replay"])
def test_train_init_chains_steps_per_dispatch(tmp_path, replay):
    """``steps_per_dispatch: 3`` with one generated dataset: without a
    ring 5 iterations as dispatches of 3 and 2 fresh steps (checkpoints at
    2 and 4); with a ring of 16 and 2 steps per unit, 3 units per dispatch
    to 5 iterations (the last unit's second step is past the end).  A
    resume continues from the checkpoint at 4 to 7."""
    config = _script_init_config(
        tmp_path, steps_per_dispatch=3, iterations=5,
        checkpoint_iteration=2, validation_iteration=0,
        replay_buffer_size=16 if replay else 0, replay_train_steps=2)
    out = train_init.Trainer(copy.deepcopy(config), device="cpu").run()
    assert out["trainer"].iteration == (6 if replay else 5)
    model_dir = tmp_path / "init"
    assert sorted(f for f in os.listdir(model_dir) if f.endswith(".ckpt")
                  ) == ["2.ckpt", "4.ckpt"]
    assert torch.load(model_dir / "2.ckpt")["iteration"] == 2
    resumed = train_init.Trainer(dict(copy.deepcopy(config), iterations=7,
                                      resume=True), device="cpu").run()
    assert resumed["trainer"].iteration == (8 if replay else 7)


@pytest.mark.parametrize("n,m", [(6, 16), (14, 32), (4, 8), (5, 5)])
def test_decoder_resize_backward_is_the_adjoint(n, m):
    """The decoders' trilinear resize (6 -> 16, 14 -> 32, 30 -> 64 in the
    mug VAE), in a trainer's step and outside one: forward
    ``F.interpolate`` bit for bit, backward always the fixed-order adjoint
    (PyTorch's CUDA backward adds with float atomics), equal to PyTorch's
    backward within 1e-12 in float64."""
    from sdfest_torch.models.vae import fp32_convolutions
    from sdfest_torch.ops.interpolation import resize_trilinear

    g = torch.Generator().manual_seed(n)
    x = torch.randn(2, 3, n, n, n, generator=g, dtype=torch.float64)
    grad = torch.randn(2, 3, m, m, m, generator=g, dtype=torch.float64)
    xi = x.clone().requires_grad_(True)
    y = torch.nn.functional.interpolate(xi, size=(m,) * 3, mode="trilinear",
                                        align_corners=False)
    want = (y.detach(), torch.autograd.grad(y, xi, grad)[0])
    for deterministic in (True, False):
        xi = x.clone().requires_grad_(True)
        with fp32_convolutions(deterministic=deterministic):
            y = resize_trilinear(xi, m)
        assert type(y.grad_fn).__name__ == "_ResizeBackward"
        assert torch.equal(y.detach(), want[0])
        torch.testing.assert_close(torch.autograd.grad(y, xi, grad)[0],
                                   want[1], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# the optimizer's state and the scripts
# ---------------------------------------------------------------------------


def test_checkpoint_of_torch_adam_loads_and_steps(tmp_path):
    """A checkpoint written with ``torch.optim.Adam`` (the trainers'
    optimizer before the count moved to the device) loads: its moments
    carry over and its float count becomes the int32 count; the next step
    is optax's third step."""
    cfg = _init_net_config()
    cfg["backbone"]["mlp_out_sizes"] = [16, 32]
    cfg["head"].update(in_size=32, mlp_out_sizes=[16])
    torch.manual_seed(0)
    t = InitTrainer(cfg, latent_size=8, device="cpu")
    old = torch.optim.Adam(t.net.parameters(), lr=1e-3)
    rng = np.random.default_rng(0)
    batch = {"pointset": torch.from_numpy(rng.normal(
        0, 0.05, (4, 50, 3)).astype(np.float32)),
        "latent_shape": torch.zeros(4, 8), "position": torch.zeros(4, 3),
        "scale": torch.ones(4), "orientation": torch.arange(4)}
    for _ in range(2):
        old.zero_grad()
        t.loss(batch)[0].backward()
        old.step()
    path = str(tmp_path / "old.ckpt")
    torch.save({"model": t.net.state_dict(), "optimizer": old.state_dict(),
                "iteration": 2}, path)
    u = InitTrainer(cfg, latent_size=8, device="cpu")
    assert checkpoint.load_checkpoint(path, u)["iteration"] == 2
    for p, q in zip(old.param_groups[0]["params"], u.optimizer.params()):
        st = u.optimizer.state[q]
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 2
        assert torch.equal(st["exp_avg"], old.state[p]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], old.state[p]["exp_avg_sq"])
    u.train_step(batch)
    assert all(int(u.optimizer.state[q]["step"]) == 3
               for q in u.optimizer.params())
    assert isinstance(u.optimizer, Adam)


def test_train_vae_chains_steps_per_dispatch(tmp_path, capsys):
    """``steps_per_dispatch: 3`` uploads the dataset and chains: 7
    iterations as dispatches of 3, 3 and 1 steps; checkpoints at 2, 4 and 6
    (inside dispatches, under their own iterations); a resume from 4 runs
    one dispatch of 3 to 7.  Past ``device_dataset_max_mb`` one step per
    dispatch."""
    config = _script_vae_config(tmp_path, steps_per_dispatch=3,
                                iterations=7, checkpoint_iteration=2)
    out = train_vae.train(copy.deepcopy(config), device="cpu")
    assert "3 steps per dispatch" in capsys.readouterr().out
    assert out["trainer"].iteration == int(out["trainer"]._count) == 7
    model_dir = tmp_path / "vae"
    assert sorted(f for f in os.listdir(model_dir) if f.endswith(".ckpt")
                  ) == ["2.ckpt", "4.ckpt", "6.ckpt"]
    assert torch.load(model_dir / "2.ckpt")["iteration"] == 2
    resumed = train_vae.train(dict(copy.deepcopy(config),
                                   checkpoint=str(model_dir / "4.ckpt")),
                              device="cpu")["trainer"]
    assert resumed.iteration == 7
    small = dict(copy.deepcopy(config), device_dataset_max_mb=1,
                 iterations=2, checkpoint_iteration=0)
    assert train_vae.train(small, device="cpu")["trainer"].iteration == 2
    assert "one step per dispatch" in capsys.readouterr().out


@pytest.mark.parametrize("replay", [False, True], ids=["fresh", "replay"])
def test_train_init_chains_steps_per_dispatch(tmp_path, replay):
    """``steps_per_dispatch: 3`` with one generated dataset: without a
    ring 5 iterations as dispatches of 3 and 2 fresh steps (checkpoints at
    2 and 4); with a ring of 16 and 2 steps per unit, 3 units per dispatch
    to 5 iterations (the last unit's second step is past the end).  A
    resume continues from the checkpoint at 4 to 7."""
    config = _script_init_config(
        tmp_path, steps_per_dispatch=3, iterations=5,
        checkpoint_iteration=2, validation_iteration=0,
        replay_buffer_size=16 if replay else 0, replay_train_steps=2)
    out = train_init.Trainer(copy.deepcopy(config), device="cpu").run()
    assert out["trainer"].iteration == (6 if replay else 5)
    model_dir = tmp_path / "init"
    assert sorted(f for f in os.listdir(model_dir) if f.endswith(".ckpt")
                  ) == ["2.ckpt", "4.ckpt"]
    assert torch.load(model_dir / "2.ckpt")["iteration"] == 2
    resumed = train_init.Trainer(dict(copy.deepcopy(config), iterations=7,
                                      resume=True), device="cpu").run()
    assert resumed["trainer"].iteration == (8 if replay else 7)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 4), (2, 16, 8, 8, 8)])
def test_decoder_upsample_backward_is_the_adjoint(shape):
    """The decoders' 2x trilinear upsample: forward ``F.interpolate`` bit
    for bit, backward the fixed-order adjoint (PyTorch's CUDA backward adds
    with float atomics), equal to PyTorch's backward within 1e-12 in
    float64."""
    from sdfest_torch.ops.interpolation import resize_trilinear

    g = torch.Generator().manual_seed(0)
    x = torch.randn(*shape, generator=g, dtype=torch.float64)
    grad = torch.randn(*shape[:2], *(2 * s for s in shape[2:]), generator=g,
                       dtype=torch.float64)
    outs = []
    for port in (True, False):
        xi = x.clone().requires_grad_(True)
        y = (resize_trilinear(xi, 2 * shape[-1]) if port else
             torch.nn.functional.interpolate(
                 xi, size=(2 * shape[-1],) * 3, mode="trilinear",
                 align_corners=False))
        outs.append((y.detach(), torch.autograd.grad(y, xi, grad)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=1e-12)
