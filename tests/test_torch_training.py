"""Parity of the port's training path with the JAX package's (CPU): the
encoder and VAE, the VAE trainer's loss terms, gradients and Adam steps,
the init trainer's step (BatchNorm statistics included), the iterative
PointNets, the generated views, the batched ``quat_to_index`` and the
weights bridge both ways.

``jax.random`` and ``torch.Generator`` draw different numbers, so every
test recomputes the JAX package's draws from its key splits and feeds them
into the port.  The JAX references run under ``jax.enable_x64(False)``: the
package computes in float32 (``tests/conftest.py`` turns x64 on for the
rest of the suite).  Tolerances are stated where they are used.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from sdfest_tpu.datasets.generated import SDFVAEViewDataset as JDataset
from sdfest_tpu.models.pointnet import (
    GeneralizedIterativePointNet as JGeneralized,
    IterativePointNet as JIterative,
)
from sdfest_tpu.models.vae import create_vae_from_config as jcreate_vae
from sdfest_tpu.ops import quaternion as jquaternion
from sdfest_tpu.ops.so3grid_jax import quat_to_index as jquat_to_index
from sdfest_tpu.render import render_depth as jrender_depth
from sdfest_tpu.training.init_trainer import InitTrainer as JInitTrainer
from sdfest_tpu.training.vae_trainer import VAETrainer as JVAETrainer
from sdfest_torch.datasets.generated import SDFVAEViewDataset
from sdfest_torch.models.pointnet import (
    GeneralizedIterativePointNet,
    IterativePointNet,
)
from sdfest_torch.models.vae import create_vae_from_config
from sdfest_torch.ops import pointset, quaternion
from sdfest_torch.ops.so3grid import quat_to_index
from sdfest_torch.training.init_trainer import InitTrainer
from sdfest_torch.training.vae_trainer import VAETrainer
from sdfest_torch.utils import msgpack_reader, msgpack_writer, weights
from sdfest_torch.utils.presets import preset
from sdfest_torch.utils.scenes import make_mug_family_sdf, sample_mug_family

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_PATH = os.path.join(ROOT, "trained_models/mug_procedural/"
                        "mug_procedural.msgpack")
INIT_PATH = os.path.join(ROOT, "trained_models/init_mug_procedural_v3/"
                         "init_mug_procedural_v3.msgpack")
# the march of the JAX package's CPU backend (no culling, no adaptive
# relaxation) against the port's culling march: ROADMAP's march tolerance,
# hit agreement > 0.995 and |ddepth| < 5e-3 where both hit.  That bound is
# two termination bands (a ray stops where the SDF falls below threshold *
# t, 0.005 * ~0.5 on the pipeline's renders); the pc render stops at 0.01 *
# ~5, so its bound is two of its own bands
MARCH_HIT_AGREEMENT, MARCH_DEPTH_TOL = 0.995, 5e-3
PC_MARCH_DEPTH_TOL = 2 * 0.01 * 5.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (as in
    ``test_torch_batch.py``: beside the suite's other workers the default
    threads' spin-waits cost more than the ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.array(x, dtype=np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_tree_close(got, want, rel):
    """Every leaf of ``got`` within ``rel`` of its ``want`` leaf's largest
    magnitude."""
    for path, w in msgpack_reader.leaves(want):
        g = got
        for k in path:
            g = g[k]
        w = _np(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(_np(g) - w).max()) <= rel * scale, path


def _vae_config(**overrides):
    config = preset("vae_mug_procedural")
    config.update(pc_render_width=64, pc_render_height=48, **overrides)
    return config


@pytest.fixture(scope="module")
def mugs():
    rng = np.random.default_rng(0)
    return np.stack([make_mug_family_sdf(64, **sample_mug_family(rng))[None]
                     for _ in range(2)]).astype(np.float32)


@pytest.fixture(scope="module")
def vae_tree():
    return msgpack_reader.load(VAE_PATH)


# ---------------------------------------------------------------------------
# the VAE
# ---------------------------------------------------------------------------


def test_encoder_matches_flax_on_committed_weights(mugs, vae_tree):
    cfg = preset("vae_mug_procedural")
    jvae = jcreate_vae(cfg)
    with jax.enable_x64(False):
        means, log_var = jvae.apply({"params": _jtree(vae_tree)},
                                    jnp.asarray(mugs),
                                    method=jvae.encode_mean)
    vae = create_vae_from_config(cfg)
    weights.load_flax_into(vae.encoder, vae_tree["encoder"])
    with torch.no_grad():
        got_means, got_log_var = vae.encode_mean(torch.from_numpy(mugs))
    # 1e-5 absolute (means up to ~6)
    np.testing.assert_allclose(got_means.numpy(), _np(means), atol=1e-5)
    np.testing.assert_allclose(got_log_var.numpy(), _np(log_var), atol=1e-5)


@pytest.mark.parametrize("padding", [1, "SAME", "VALID"])
def test_encoder_padding_rules_match_flax(padding):
    layers = [{"type": "Conv3d", "args": {
        "in_channels": 1, "out_channels": 3, "kernel_size": 3, "stride": 2,
        "padding": padding}},
        {"type": "ReLU", "args": {}},
        {"type": "torch.nn.MaxPool3d", "args": {"kernel_size": 2}},
        {"type": "Flatten", "args": {}},
        {"type": "Linear", "args": {"in_features": 0, "out_features": 5}},
        {"type": "ReLU", "args": {}}]
    cfg = dict(preset("vae_mug_procedural"), sdf_size=16,
               encoder={"layer_infos": layers})
    jvae = jcreate_vae(cfg)
    x = np.random.default_rng(1).normal(size=(2, 1, 16, 16, 16)).astype(
        np.float32)
    with jax.enable_x64(False):
        params = jvae.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jax.random.PRNGKey(1))["params"]
        means, log_var = jvae.apply({"params": params}, jnp.asarray(x),
                                    method=jvae.encode_mean)
    vae = create_vae_from_config(cfg)
    weights.load_flax_into(vae, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = vae.encode_mean(torch.from_numpy(x))
    np.testing.assert_allclose(got[0].numpy(), _np(means), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), _np(log_var), atol=1e-5)


def test_vae_forward_with_injected_eps(mugs, vae_tree):
    cfg = preset("vae_mug_procedural")
    jvae = jcreate_vae(cfg)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(False):
        want = jvae.apply({"params": _jtree(vae_tree)}, jnp.asarray(mugs),
                          key)
        eps = _np(jax.random.normal(key, (2, 8), jnp.float32))
    vae = create_vae_from_config(cfg)
    weights.load_flax_into(vae, vae_tree)
    with torch.no_grad():
        got = vae(torch.from_numpy(mugs), eps=torch.from_numpy(eps))
    # recon, means, log_var, z: 1e-5 absolute
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5)
    torch.testing.assert_close(vae.prepare_input(got[0]), got[0])


def _jax_draws_vae(key, batch):
    """The eps and pc quaternions of ``VAETrainer._loss`` under ``key``
    (``vae_trainer.py:81``, ``:174``)."""
    key_encode, key_pc = jax.random.split(key)
    eps = _np(jax.random.normal(key_encode, (batch, 8), jnp.float32))
    quats = np.stack([_np(jquaternion.random_uniform(k))
                      for k in jax.random.split(key_pc, batch)])
    return eps, quats


def _jax_pc_depth(jt, x, quats):
    """The JAX package's pc render of each input grid (``:133-141``)."""
    return np.stack([_np(jrender_depth(
        jnp.asarray(x[b, 0]), jnp.asarray([0.0, 0.0, -5.0]),
        jnp.asarray(q), jnp.asarray(1.0), camera=jt.camera, threshold=0.01))
        for b, q in enumerate(quats)])


@pytest.mark.parametrize("iteration,tsdf", [(5, False), (1001, 0.1)],
                         ids=["warm_up", "kld_and_tsdf"])
def test_vae_trainer_loss_terms_and_gradients_match_jax(mugs, vae_tree,
                                                        iteration, tsdf):
    cfg = _vae_config(tsdf=tsdf, l1_small_weight=0.5, l1_large_weight=0.25)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        jt = JVAETrainer(cfg)
        loss_and_grad = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))
        (_, want), jgrads = loss_and_grad(_jtree(vae_tree),
                                          jnp.asarray(mugs), key,
                                          jnp.asarray(iteration))
        eps, quats = _jax_draws_vae(key, 2)
        x = np.clip(mugs, -tsdf, tsdf) if tsdf and iteration > 1000 else mugs
        depth = _jax_pc_depth(jt, x, quats)
    t = VAETrainer(cfg, device="cpu")
    weights.load_flax_into(t.vae, vae_tree)
    # the port's own pc render against the JAX package's CPU march
    own = t.pc_depth(torch.from_numpy(x), torch.from_numpy(quats)).numpy()
    assert (depth > 0).sum() > 100
    assert ((own > 0) == (depth > 0)).mean() > MARCH_HIT_AGREEMENT
    both = (own > 0) & (depth > 0)
    assert np.abs(own - depth)[both].max() < PC_MARCH_DEPTH_TOL
    loss, got = t.loss(torch.from_numpy(mugs), iteration,
                       eps=torch.from_numpy(eps),
                       quats=torch.from_numpy(quats),
                       pc_depth=torch.from_numpy(depth))
    loss.backward()
    # every term rtol 1e-5 (loss_pc on the JAX package's depth)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(got["loss_pc"].detach()) > 0
    # every leaf's gradient within 1e-4 of its largest magnitude
    grads = weights.torch_to_flax(
        {k: p.grad for k, p in t.vae.named_parameters()})
    _assert_tree_close(grads, jax.tree_util.tree_map(np.asarray, jgrads),
                       1e-4)


def test_vae_trainer_adam_steps_match_jax(mugs, vae_tree, monkeypatch):
    cfg = _vae_config()
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    with jax.enable_x64(False):
        jt = JVAETrainer(cfg)
        params = _jtree(vae_tree)
        state = {"params": params, "opt_state": jt.optimizer.init(params),
                 "iteration": jnp.zeros((), jnp.int32)}
        step = jax.jit(jt.step)
        draws, depths = [], []
        for key in keys:
            state, _ = step(state, jnp.asarray(mugs), key)
            eps, quats = _jax_draws_vae(key, 2)
            draws.append((eps, quats))
            depths.append(_jax_pc_depth(jt, mugs, quats))
        want = jax.tree_util.tree_map(np.asarray, state["params"])
    t = VAETrainer(cfg, device="cpu")
    weights.load_flax_into(t.vae, vae_tree)
    it = iter(depths)
    monkeypatch.setattr(t, "pc_depth",
                        lambda x, q: torch.from_numpy(next(it)))
    for eps, quats in draws:
        metrics = t.step(torch.from_numpy(mugs), eps=torch.from_numpy(eps),
                         quats=torch.from_numpy(quats))
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert t.iteration == 3
    # parameters after 3 Adam steps from the same state: 1e-5 absolute
    got = weights.torch_to_flax(t.vae.state_dict())
    for path, w in msgpack_reader.leaves(want):
        g = got
        for k in path:
            g = g[k]
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=str(path))


# ---------------------------------------------------------------------------
# the init network
# ---------------------------------------------------------------------------


def _init_config():
    cfg = preset("init_mug_procedural_v3")
    cfg["head"].update(orientation_repr="discretized",
                       orientation_grid_resolution=1)
    return cfg


def _init_batch(n=4, points=200, seed=2):
    rng = np.random.default_rng(seed)
    return {
        "pointset": (0.05 * rng.normal(size=(n, points, 3))).astype(
            np.float32),
        "latent_shape": rng.normal(size=(n, 8)).astype(np.float32),
        "position": (0.02 * rng.normal(size=(n, 3))).astype(np.float32),
        "scale": (0.05 + 0.01 * rng.normal(size=n)).astype(np.float32),
        "orientation": rng.integers(0, 576, size=n).astype(np.int32),
    }


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64)
        if np.asarray(x).dtype == np.float32 else np.asarray(x), tree)


def _assert_grads_close(grads, want, rel):
    """Each leaf within ``rel`` of its largest magnitude; a bias that feeds
    a training-mode BatchNorm has gradient 0 in exact arithmetic (the
    normalization removes it), so those leaves are rounding noise on both
    sides and are held to ``rel`` of the tree's largest gradient."""
    largest = max(float(np.abs(w).max())
                  for _, w in msgpack_reader.leaves(want))
    for path, w in msgpack_reader.leaves(want):
        g = grads
        for k in path:
            g = g[k]
        scale = float(np.abs(w).max())
        if path[-1] == "bias" and path[-2].startswith("linear_"):
            scale = largest
        assert float(np.abs(np.asarray(g) - w).max()) <= rel * scale, path


def test_init_trainer_step_matches_jax_with_flax_batchnorm():
    """In float64 on both sides: in float32 the batch statistics'
    ``E[x^2] - E[x]^2`` loses digits to cancellation, and two float32
    implementations that sum in different orders part by ~1e-3 in the
    backbone's gradients (the JAX package against itself in float64 too)."""
    cfg = _init_config()
    tree = _f64(msgpack_reader.load(INIT_PATH))
    batch = _f64(_init_batch())
    with jax.enable_x64(True):
        jt = JInitTrainer(cfg, latent_size=8)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = _jtree(tree)
        state = {"params": variables["params"],
                 "batch_stats": variables["batch_stats"],
                 "opt_state": jt.optimizer.init(variables["params"]),
                 "iteration": jnp.zeros((), jnp.int32)}
        jgrads, (jmetrics, _) = jax.jit(jax.grad(jt._loss, has_aux=True))(
            state["params"], state["batch_stats"], jbatch)
        new_state, _ = jax.jit(jt.step)(state, jbatch)
        new_state = jax.tree_util.tree_map(np.asarray, new_state)
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    t = InitTrainer(cfg, latent_size=8, device="cpu")
    weights.load_flax_into(t.net, tree)
    t.net.double()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = t.loss(tbatch)
    loss.backward()
    # losses rtol 1e-10
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(jmetrics[k]), rtol=1e-10, err_msg=k)
    # every leaf's gradient within 1e-4 of its largest magnitude
    _assert_grads_close(weights.torch_to_flax(
        {k: p.grad for k, p in t.net.named_parameters()}), jgrads, 1e-4)
    # the BatchNorms' running statistics after the step: 1e-6 absolute
    # (nn.BatchNorm1d would move the head's variance toward the unbiased
    # batch variance, 4/3 of flax's at batch 4)
    stats = weights.torch_to_flax(t.net.state_dict())["batch_stats"]
    for path, w in msgpack_reader.leaves(new_state["batch_stats"]):
        g = stats
        for k in path:
            g = g[k]
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=str(path))
    # the parameters after the Adam step: 1e-6 absolute
    t.optimizer.step()
    params = weights.torch_to_flax(t.net.state_dict())["params"]
    for path, w in msgpack_reader.leaves(new_state["params"]):
        g = params
        for k in path:
            g = g[k]
        np.testing.assert_allclose(g, w, atol=1e-6, err_msg=str(path))


def test_init_trainer_losses_match_jax_in_float32():
    cfg = _init_config()
    tree = msgpack_reader.load(INIT_PATH)
    batch = _init_batch()
    with jax.enable_x64(False):
        jt = JInitTrainer(cfg, latent_size=8)
        variables = _jtree(tree)
        _, (jmetrics, _) = jax.jit(jt._loss)(
            variables["params"], variables["batch_stats"],
            {k: jnp.asarray(v) for k, v in batch.items()})
    t = InitTrainer(cfg, latent_size=8, device="cpu")
    weights.load_flax_into(t.net, tree)
    with torch.no_grad():
        _, metrics = t.loss({k: torch.from_numpy(v)
                             for k, v in batch.items()})
    # rtol 1e-5, atol 1e-6 (loss_position is ~4e-3: a difference of
    # squares of positions that agree to ~1e-7)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_stock_batchnorm_would_drift_from_flax():
    """What the port's BatchNorm prevents: PyTorch's running variance moves
    toward the unbiased batch variance."""
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0))
    stock = torch.nn.BatchNorm1d(6, momentum=0.1).train()
    port = InitTrainer(_init_config(), 8, device="cpu").net.head.bn_0
    ours = type(port)(6).train()
    stock(x)
    ours(x)
    biased = x.var(0, unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * biased)
    assert not torch.allclose(stock.running_var, ours.running_var,
                              atol=1e-3)


@pytest.mark.parametrize("n, c", [(64, 8), (4096, 32)])
def test_training_batchnorm_matches_flax_batchnorm(n, c):
    """The port's training-mode BatchNorm (fused forward and backward on the
    batch's flax statistics) against flax's ``nn.BatchNorm`` in float64:
    output, the gradients of input, scale and bias, and the new running
    statistics, 1e-10 absolute."""
    import flax.linen as fnn

    from sdfest_torch.models.pointnet import BatchNorm

    rng = np.random.default_rng(n)
    x = rng.normal(0.5, 2.0, (n, c))
    dy = rng.normal(size=(n, c))
    scale, bias = rng.normal(1.0, 0.2, c), rng.normal(0.0, 0.2, c)
    mean0, var0 = rng.normal(size=c), rng.uniform(0.5, 2.0, c)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float64,
                        param_dtype=jnp.float64)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(x, scale, bias):
        y, upd = jbn.apply({"params": {"scale": scale, "bias": bias},
                            "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, upd["batch_stats"])

    (_, (jy, jstats)), jgrads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    bn = BatchNorm(c).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = bn(tx)
    y.backward(torch.from_numpy(dy))
    pairs = [(y.detach(), jy), (tx.grad, jgrads[0]),
             (bn.weight.grad, jgrads[1]), (bn.bias.grad, jgrads[2]),
             (bn.running_mean, jstats["mean"]),
             (bn.running_var, jstats["var"])]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-10)


@pytest.mark.parametrize("kind", ["iterative", "generalized"])
def test_iterative_pointnets_match_flax_in_training(kind):
    if kind == "iterative":
        jnet = JIterative(num_concat=2, in_size=3, mlp_out_sizes=[8, 16],
                          batchnorm=True)
        net = IterativePointNet(2, 3, [8, 16], True)
    else:
        jnet = JGeneralized(list_concat=[1, 2], in_size=3,
                            list_mlp_out_sizes=[[8, 16], [12, 10]],
                            batchnorm=True)
        net = GeneralizedIterativePointNet([1, 2], 3, [[8, 16], [12, 10]],
                                           True)
    # float64 on both sides (the batch statistics' cancellation, as in
    # test_init_trainer_step_matches_jax_with_flax_batchnorm)
    x = np.random.default_rng(3).normal(size=(3, 50, 3))
    with jax.enable_x64(True):
        variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              )
        variables = _jtree(_f64(variables))
        out, updates = jnet.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        evaluated = jnet.apply({"params": variables["params"],
                                "batch_stats": updates["batch_stats"]},
                               jnp.asarray(x))
    weights.load_flax_into(net, jax.tree_util.tree_map(np.asarray,
                                                       variables))
    net.double()
    got = net.train()(torch.from_numpy(x))
    # 1e-9 absolute (float64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-9)
    with torch.no_grad():
        got_eval = net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.numpy(), np.asarray(evaluated),
                               atol=1e-9)


# ---------------------------------------------------------------------------
# generated views
# ---------------------------------------------------------------------------


def _jax_draws_views(jds, key, cfg, batch):
    """The draws of ``SDFVAEViewDataset._sample_one`` for each key of
    ``split(key, batch)`` (``generated.py:231-331``), as the port's
    ``draw`` returns them."""
    cam = jds.camera
    cf = cfg["center_frac"]
    rows = []
    for k in jax.random.split(key, batch):
        keys = jax.random.split(k, 12)
        k1, k2, k3, k4 = jax.random.split(keys[6], 4)
        u = lambda kk, lo, hi, shape=(): _np(jax.random.uniform(
            kk, shape, minval=lo, maxval=hi, dtype=jnp.float32))
        rows.append({
            "latent": _np(jax.random.normal(keys[0], (1, 8), jnp.float32))[0],
            "z": u(keys[1], cfg["z_min"], cfg["z_max"]),
            "x_pix": u(keys[2], -cf * cam.width / 2, cf * cam.width / 2),
            "y_pix": u(keys[3], -cf * cam.height / 2, cf * cam.height / 2),
            "quaternion": _np(jquaternion.random_uniform(keys[4])),
            "scale": _np((cfg["extent_mean"] + cfg["extent_std"]
                          * jax.random.normal(keys[5], (), jnp.float32))
                         / 2.0),
            "warp_angle": _np(jax.random.uniform(k1, (), minval=0.0,
                                                 maxval=1.0)
                              * jnp.pi / 180.0),
            "warp_tx": _np(jax.random.uniform(k2, (), minval=-0.01,
                                              maxval=0.01) * cam.width),
            "warp_ty": _np(jax.random.uniform(k3, (), minval=-0.01,
                                              maxval=0.01) * cam.height),
            "warp_scale": u(k4, 0.999, 1.001),
            "fill": u(keys[7], cfg["mask_noise_min"], cfg["mask_noise_max"]),
            "blur": _np(jax.random.uniform(keys[8], ())),
            "norm_noise": u(keys[9], cfg["norm_noise_min"],
                            cfg["norm_noise_max"], (3,)),
            "subsample": _np(jax.random.uniform(keys[10],
                                                (cfg["num_points"],))),
        })
    return {name: torch.from_numpy(np.stack([r[name] for r in rows]))
            for name in rows[0]}


@pytest.mark.parametrize("overrides", [
    {}, {"gaussian_noise_probability": 1.0, "norm_noise": True,
         "scale_to_unit_ball": True}], ids=["v3", "blur_noise_unit_ball"])
def test_views_from_draws_match_sample_one(vae_tree, overrides):
    cfg = dict(preset("init_mug_procedural_v3")["datasets"][
        "generated_dataset"]["config_dict"], width=80, height=60,
        num_points=300, orientation_repr="discretized",
        orientation_grid_resolution=1, **overrides)
    vae_cfg = preset("vae_mug_procedural")
    key = jax.random.PRNGKey(5)
    batch = 4
    with jax.enable_x64(False):
        jvae = jcreate_vae(vae_cfg)
        jds = JDataset(cfg, jvae, _jtree(vae_tree))
        draws = _jax_draws_views(jds, key, cfg, batch)
        want = [jds._sample_one(k) for k in jax.random.split(key, batch)]
        want = {name: np.stack([np.asarray(w[name]) for w in want])
                for name in want[0]}
        sdf = jvae.apply({"params": _jtree(vae_tree)},
                         jnp.asarray(draws["latent"].numpy()),
                         method=jvae.decode)[:, 0]
        raw = []
        for b in range(batch):
            z = draws["z"][b].numpy()
            position = np.stack([draws["x_pix"][b].numpy() / jds.camera.fx
                                 * z, draws["y_pix"][b].numpy()
                                 / jds.camera.fy * z, -z])
            raw.append(_np(jrender_depth(
                sdf[b], jnp.asarray(position),
                jnp.asarray(draws["quaternion"][b].numpy()),
                1.0 / jnp.asarray(draws["scale"][b].numpy()),
                camera=jds.camera, threshold=cfg["render_threshold"])))
        raw = np.stack(raw)
    vae = create_vae_from_config(vae_cfg)
    weights.load_flax_into(vae, vae_tree)
    ds = SDFVAEViewDataset(cfg, vae.decoder, device="cpu")
    # the port's decoder and culling march against the JAX package's
    own = ds.render(draws).numpy()
    assert (raw > 0).sum() > 200
    assert ((own > 0) == (raw > 0)).mean() > MARCH_HIT_AGREEMENT
    both = (own > 0) & (raw > 0)
    assert np.abs(own - raw)[both].max() < MARCH_DEPTH_TOL
    # the augmentations, lift and labels on the JAX package's raw depth
    got = ds.views_from_depth(torch.from_numpy(raw), draws)
    # mask warp, fill and blur: the depth within 1e-6
    np.testing.assert_allclose(got["depth"].numpy(), want["depth"],
                               atol=1e-6)
    np.testing.assert_array_equal(got["depth"].numpy() != 0,
                                  want["depth"] != 0)
    # labels, exact or to the last bits of float32 arithmetic
    np.testing.assert_array_equal(got["orientation"].numpy(),
                                  want["orientation"])
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["latent_shape"].numpy(),
                                  want["latent_shape"])
    np.testing.assert_array_equal(got["quaternion"].numpy(),
                                  want["quaternion"])
    for name in ("position", "scale", "pointset"):
        np.testing.assert_allclose(got[name].numpy(), want[name],
                                   atol=1e-6, err_msg=name)
    # every subsampled point is the lift of a valid pixel (before the
    # pose normalization moved it by the centroid)
    points, valid = pointset.depth_to_pointcloud_dense(got["depth"],
                                                       ds.camera)
    centered, _ = pointset.normalize_points_masked(points, valid)
    if overrides.get("norm_noise"):
        centered = centered + draws["norm_noise"][:, None, :]
    if overrides.get("scale_to_unit_ball"):
        norms = torch.where(valid, torch.linalg.norm(centered, dim=-1), 0.0)
        centered = centered / norms.amax(-1)[:, None, None]
    for b in range(batch):
        lifted = centered[b][valid[b]]
        d = torch.abs(got["pointset"][b][:, None] - lifted[None]).amax(-1)
        assert float(d.amin(dim=1).max()) == 0.0


def test_generated_batch_is_one_decoder_call_and_one_march(vae_tree,
                                                           monkeypatch):
    from sdfest_torch.datasets import generated

    cfg = dict(preset("init_mug_procedural_v3")["datasets"][
        "generated_dataset"]["config_dict"], width=48, height=32,
        num_points=64, orientation_repr="quaternion")
    vae = create_vae_from_config(preset("vae_mug_procedural"))
    weights.load_flax_into(vae, vae_tree)
    calls = []
    real = generated.render_depth
    monkeypatch.setattr(generated, "render_depth",
                        lambda sdf, *a, **k: calls.append(sdf.shape)
                        or real(sdf, *a, **k))
    ds = SDFVAEViewDataset(cfg, vae.decoder, device="cpu")
    batch = ds.sample_batch(5, torch.Generator().manual_seed(0))
    assert calls == [(5, 64, 64, 64)]
    assert batch["pointset"].shape == (5, 64, 3)
    assert batch["orientation"].shape == (5, 4)
    assert bool(batch["valid"].all())


def test_batched_quat_to_index_matches_jax():
    q = quaternion.random_uniform((1000,), torch.Generator().manual_seed(4))
    for resol in (0, 1, 2):
        with jax.enable_x64(False):
            want = np.asarray(jquat_to_index(jnp.asarray(q.numpy()), resol))
        np.testing.assert_array_equal(quat_to_index(q, resol).numpy(), want)


def test_quaternion_helpers_match_jax():
    g = torch.Generator().manual_seed(5)
    u = torch.rand(64, 3, generator=g)
    q1, q2 = torch.randn(64, 4, generator=g), quaternion.from_uniforms(u)
    with jax.enable_x64(False):
        jn = jquaternion.normalize(jnp.asarray(q1.numpy()))
        jl = jquaternion.simple_quaternion_loss(jn, jnp.asarray(q2.numpy()))
    np.testing.assert_allclose(quaternion.normalize(q1).numpy(), _np(jn),
                               atol=1e-7)
    np.testing.assert_allclose(float(quaternion.simple_quaternion_loss(
        quaternion.normalize(q1), q2)), float(jl), rtol=1e-6)
    torch.testing.assert_close(torch.linalg.norm(q2, dim=-1),
                               torch.ones(64))


# ---------------------------------------------------------------------------
# the weights bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", [VAE_PATH, INIT_PATH], ids=["vae", "init"])
def test_flax_torch_flax_round_trip_and_writer_bytes(path):
    with open(path, "rb") as f:
        data = f.read()
    tree = msgpack_reader.msgpack_restore(data)
    back = weights.torch_to_flax(weights.flax_to_torch(tree))
    written = msgpack_writer.packb(back)
    # the writer's bytes are flax's own
    assert written == serialization.msgpack_serialize(back)
    restored = serialization.msgpack_restore(written)
    for p, w in msgpack_reader.leaves(tree):
        g = restored
        for k in p:
            g = g[k]
        np.testing.assert_array_equal(g, w)


def test_jax_training_state_resumes_in_port(tmp_path):
    """A JAX trainer's checkpoint resumes in the port: its parameters,
    batch_stats, optax Adam moments and count, and iteration carry over, so
    the port's next step is the JAX package's next step.  In float64, as
    test_init_trainer_step_matches_jax_with_flax_batchnorm (in float32,
    gradients that are rounding noise flip Adam's steps)."""
    cfg = _init_config()
    batch = _f64(_init_batch(points=64))
    with jax.enable_x64(True):
        jt = JInitTrainer(cfg, latent_size=8)
        state = _jtree(_f64(jt.init_state(jax.random.PRNGKey(0),
                                          num_points=64)))
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        state, _ = jax.jit(jt.step)(state, jbatch)
        path = str(tmp_path / "jax.ckpt")
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(state))
        next_state, _ = jax.jit(jt.step)(state, jbatch)
        want = jax.tree_util.tree_map(np.asarray, next_state)
    from sdfest_torch.utils import checkpoint

    t = InitTrainer(cfg, latent_size=8, device="cpu")
    t.net.double()
    meta = checkpoint.load_checkpoint(path, t)
    assert meta["iteration"] == t.iteration == 1
    t.step({k: torch.from_numpy(v) for k, v in batch.items()})
    got = weights.torch_to_flax(t.net.state_dict())
    for tree in ("params", "batch_stats"):
        for p, w in msgpack_reader.leaves(want[tree]):
            g = got[tree]
            for k in p:
                g = g[k]
            # 1e-7 absolute (a dead channel's gradient is rounding noise,
            # which Adam turns into steps of ~1e-9); a bias feeding a
            # training-mode BatchNorm has gradient 0 in exact arithmetic,
            # so Adam moves it by noise, at most lr = 1e-3 per step
            atol = 2e-3 if p[-2].startswith("linear_") and \
                p[-1] == "bias" and tree == "params" else 1e-7
            np.testing.assert_allclose(g, w, atol=atol, err_msg=str(p))
    adam = want["opt_state"][0]
    params = dict(t.net.named_parameters())
    assert all(int(t.optimizer.state[p]["step"]) == int(adam.count) == 2
               for p in params.values())
    for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        _assert_grads_close(weights.torch_to_flax(
            {n: t.optimizer.state[p][key] for n, p in params.items()}),
            getattr(adam, moment), 1e-6)
