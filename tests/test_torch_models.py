"""Parity of the PyTorch port's networks, weights and preset with the JAX
package (CPU), on the committed mug weights."""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml
from flax import serialization

from sdfest_tpu.models.pose_net import create_pose_net as jcreate_pose_net
from sdfest_tpu.models.vae import create_vae_from_config
from sdfest_torch.models.pose_net import create_pose_net
from sdfest_torch.models.vae import create_decoder_from_config
from sdfest_torch.utils import msgpack_reader
from sdfest_torch.utils.presets import MUG_PROCEDURAL, preset
from sdfest_torch.utils.weights import flax_to_torch, load_flax_into

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_PATH = os.path.join(ROOT, MUG_PROCEDURAL["vae"]["model"])
INIT_PATH = os.path.join(ROOT, MUG_PROCEDURAL["init"]["model"])


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_trees_equal(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("path", [VAE_PATH, INIT_PATH],
                         ids=["vae", "init_v3"])
def test_msgpack_reader_matches_flax(path):
    data = _read(path)
    got = msgpack_reader.msgpack_restore(data)
    _assert_trees_equal(got, serialization.msgpack_restore(data))


def test_committed_weights_hold_74_arrays():
    n = sum(len(list(msgpack_reader.leaves(msgpack_reader.load(p))))
            for p in (VAE_PATH, INIT_PATH))
    assert n == 74


def test_flax_to_torch_layouts():
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(3, 5)).astype(np.float32)
    conv = rng.normal(size=(3, 3, 3, 2, 4)).astype(np.float32)
    tree = {
        "params": {"a": {"kernel": dense, "bias": np.ones(5, np.float32)},
                   "c": {"kernel": conv},
                   "bn": {"scale": np.full(4, 2.0, np.float32),
                          "bias": np.zeros(4, np.float32)}},
        "batch_stats": {"bn": {"mean": np.ones(4, np.float32),
                               "var": np.full(4, 3.0, np.float32)}},
    }
    sd = flax_to_torch(tree)
    assert sorted(sd) == sorted([
        "a.weight", "a.bias", "c.weight", "bn.weight", "bn.bias",
        "bn.running_mean", "bn.running_var"])
    np.testing.assert_array_equal(sd["a.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(sd["c.weight"].numpy(),
                                  np.transpose(conv, (4, 3, 0, 1, 2)))
    np.testing.assert_array_equal(sd["bn.running_var"].numpy(), np.full(4, 3.0))
    # a flax Dense equals the torch Linear the layout map builds
    x = rng.normal(size=(7, 3)).astype(np.float32)
    lin = torch.nn.Linear(3, 5)
    lin.load_state_dict({"weight": sd["a.weight"], "bias": sd["a.bias"]})
    np.testing.assert_allclose(lin(torch.from_numpy(x)).detach().numpy(),
                               x @ dense + 1.0, atol=1e-6)


def test_decoder_matches_flax():
    cfg = MUG_PROCEDURAL["vae"]
    params = serialization.msgpack_restore(_read(VAE_PATH))
    vae = create_vae_from_config(cfg)
    z = np.random.default_rng(1).normal(size=(2, 8)).astype(np.float32)
    want = vae.apply({"params": params}, jnp.asarray(z), method=vae.decode)
    decoder = create_decoder_from_config(cfg)
    load_flax_into(decoder, msgpack_reader.load(VAE_PATH)["decoder"])
    with torch.no_grad():
        got = decoder(torch.from_numpy(z))
    assert got.shape == (2, 1, 64, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-4)


def test_pose_net_matches_flax():
    cfg = MUG_PROCEDURAL["init"]
    variables = serialization.msgpack_restore(_read(INIT_PATH))
    jnet = jcreate_pose_net(cfg, shape_dimension=8)
    x = np.random.default_rng(2).normal(scale=0.05, size=(2, 500, 3)).astype(
        np.float32)
    want = jnet.apply(variables, jnp.asarray(x), train=False)
    net = create_pose_net(cfg, shape_dimension=8).eval()
    load_flax_into(net, msgpack_reader.load(INIT_PATH))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w in zip(got[:3], want[:3]):  # latent, position, scale
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=1e-4)
    logits_g, logits_w = got[3].numpy(), np.asarray(want[3], np.float32)
    assert logits_g.shape == (2, 576)
    np.testing.assert_allclose(logits_g, logits_w, atol=1e-3)
    np.testing.assert_array_equal(logits_g.argmax(-1), logits_w.argmax(-1))


def test_quaternion_pose_head_matches_flax():
    """The quaternion orientation head, on freshly initialized flax
    weights carried over by flax_to_torch."""
    cfg = {
        "backbone_type": "VanillaPointNet",
        "backbone": {"in_size": 3, "mlp_out_sizes": [16, 16, 32],
                     "batchnorm": True, "dense": False, "residual": True},
        "head": {"in_size": 32, "mlp_out_sizes": [16], "batchnorm": True,
                 "orientation_repr": "quaternion"},
    }
    x = np.random.default_rng(3).normal(size=(2, 50, 3)).astype(np.float32)
    jnet = jcreate_pose_net(cfg, shape_dimension=4)
    variables = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jnet.apply(variables, jnp.asarray(x), train=False)
    net = create_pose_net(cfg, shape_dimension=4).eval()
    load_flax_into(net, variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(got[3].numpy(), axis=-1), 1.0, atol=1e-6)


def test_weight_loading_rejects_mismatch():
    decoder = create_decoder_from_config(MUG_PROCEDURAL["vae"])
    tree = msgpack_reader.load(VAE_PATH)["decoder"]
    del tree["conv_3"]
    with pytest.raises(ValueError, match="conv_3"):
        load_flax_into(decoder, tree)


def test_preset_matches_merged_yaml():
    base = os.path.join(ROOT, "sdfest_tpu", "configs", "estimation")
    with open(os.path.join(base, "models", "mug_procedural.yaml")) as f:
        config = yaml.safe_load(f)
    with open(os.path.join(base, "default.yaml")) as f:
        config.update(yaml.safe_load(f))
    assert preset("mug_procedural") == config
    assert preset("mug_procedural") is not MUG_PROCEDURAL
    jax.tree_util.tree_structure(config)  # plain containers only
