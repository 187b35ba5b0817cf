"""Parity of the port's real-data script with the JAX package's (CPU): the
RGB-D loaders on PNGs written here, the order of ``get_masks``' sources,
``runtime_analysis``' key structure and YAML output at a small camera, and
``main``; then the reference-layout ``.pt`` checkpoints (the repair of the
port that could not load them): a state dict built from the committed
weights with ``torch.save``, loaded by both packages, their decoders and
init networks within 1e-5, and ``~`` and the JAX package's search paths
resolved with nothing downloaded."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdfest_tpu.models.pose_net import create_pose_net as jcreate_pose_net
from sdfest_tpu.models.vae import create_vae_from_config as jcreate_vae
from sdfest_tpu.scripts import real_data as jreal
from sdfest_tpu.utils import convert_torch as jconvert
from sdfest_tpu.utils import weights as jweights
from sdfest_torch.models.pose_net import create_pose_net
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.scripts import make_procedural_dataset as tmpd
from sdfest_torch.scripts import real_data as treal
from sdfest_torch.utils import config as tconfig
from sdfest_torch.utils import convert_torch, msgpack_reader, weights
from sdfest_torch.utils.presets import MUG_PROCEDURAL, preset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_PATH = os.path.join(ROOT, MUG_PROCEDURAL["vae"]["model"])
INIT_PATH = os.path.join(ROOT, MUG_PROCEDURAL["init"]["model"])
SMALL_REDWOOD = dict(width=64, height=48, fx=52.5, fy=52.5, cx=31.95,
                     cy=23.95, pixel_center=0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (many small CPU ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_download(monkeypatch):
    """The JAX package downloads a missing ``model_url``; never here."""
    monkeypatch.setenv("SDFEST_TPU_NO_DOWNLOAD", "1")


def _png(path, array):
    Image.fromarray(array).save(path)


def _assert_rgbd_equal(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[2:] == want[2:]


@pytest.fixture(scope="module")
def mug_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("meshes")
    tmpd.generate(str(out), n=1, res=24, seed=777, export_meshes=True)
    return str(out / "00000.obj")


def test_loaders_equal_jax(tmp_path, mug_mesh):
    rng = np.random.default_rng(0)
    color = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    depth = rng.integers(0, 3000, (48, 64), dtype=np.uint16)
    # Redwood: the depth frame of the closest timestamp
    rgb_dir, depth_dir = tmp_path / "seq" / "rgb", tmp_path / "seq" / "depth"
    rgb_dir.mkdir(parents=True)
    depth_dir.mkdir()
    _png(rgb_dir / "0000300-000010021284.jpg", color)
    _png(depth_dir / "0000299-000010001000.png", depth)
    _png(depth_dir / "0000301-000010091000.png", depth // 2)
    # REAL275 and RGB-D Object (UW)
    _png(tmp_path / "0000_color.png", color)
    _png(tmp_path / "0000_depth.png", depth)
    _png(tmp_path / "apple_1_1_1.png", color)
    _png(tmp_path / "apple_1_1_1_depth.png", depth)
    for dataset, path in (
            ("redwood", rgb_dir / "0000300-000010021284.jpg"),
            ("real275", tmp_path / "0000_color.png"),
            ("rgbd_object_uw", tmp_path / "apple_1_1_1.png")):
        config = {"dataset": dataset, "input": str(path)}
        got, want = treal.load_rgbd(config), jreal.load_rgbd(config)
        _assert_rgbd_equal(got, want)
        assert got[1].dtype == np.float32 and got[1].max() > 0
    assert treal.load_rgbd({"dataset": "redwood", "input": str(
        rgb_dir / "0000300-000010021284.jpg")})[3].endswith(
        "0000299-000010001000.png")
    config = {"dataset": "synthetic", "input": mug_mesh,
              "camera": SMALL_REDWOOD}
    got, want = treal.load_rgbd(config), jreal.load_rgbd(config)
    _assert_rgbd_equal(got, want)
    assert (got[1] > 0).sum() > 50
    with pytest.raises(NotImplementedError):
        treal.load_rgbd({"dataset": "ycb", "input": "x"})


def test_get_masks_order_equals_jax(tmp_path):
    """The mask file, then the cache, then Detectron2 (absent here), then
    the valid-depth mask."""
    color = np.zeros((48, 64, 3), np.float32)
    depth = np.zeros((48, 64), np.float32)
    depth[10:20, 10:20] = 0.5
    mask_img = np.zeros((48, 64, 3), np.uint8)
    mask_img[5:9, 5:9] = 255
    _png(tmp_path / "mask.png", mask_img)
    cached = np.zeros((48, 64), bool)
    cached[30:33, 40:45] = True
    cache = tmp_path / "cache.npz"
    np.savez_compressed(cache, instances=np.asarray(
        [{"mask": cached, "category_str": "cup"}], dtype=object))
    cases = [
        ({"category": "mug", "mask_path": str(tmp_path / "mask.png")},
         str(cache), 16, "mug"),
        ({"category": "mug"}, str(cache), 15, "cup"),
        ({"category": "mug"}, str(tmp_path / "absent.npz"), 100, "mug"),
        ({}, None, 100, "unknown"),
    ]
    for config, cache_path, area, category in cases:
        got = treal.get_masks(color, depth, config, cache_path)
        want = jreal.get_masks(color, depth, config, cache_path)
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0]["mask"], want[0]["mask"])
        assert got[0]["category_str"] == want[0]["category_str"] == category
        assert got[0]["mask"].sum() == area


def _runtime_config(mug_mesh, **overrides):
    config = preset("runtime_analysis_demo")
    config.update(camera=dict(SMALL_REDWOOD), input=mug_mesh,
                  max_iterations=2, runs=1, skip_first_run=False)
    config.update(overrides)
    return config


# the JAX package's phase names and per-phase keys (scripts/real_data.py)
PHASES = {"init", "decode", "render", "render_and_losses", "losses",
          "fwd_and_backward", "backward", "full_refinement"}


def test_runtime_analysis_keys_and_yaml(tmp_path, mug_mesh):
    config = _runtime_config(mug_mesh, out_folder=str(tmp_path / "out"),
                             trace_dir=str(tmp_path / "trace"))
    results = treal.runtime_analysis(dict(config), device="cpu")
    assert set(results) == {"results_with_decode", "results_without_decode"}
    for block, phases in results.items():
        assert set(phases) == PHASES
        for name, stats in phases.items():
            assert set(stats) == {"mean", "calls_per_run", "total_per_run"}
            assert np.isfinite(stats["mean"]) and stats["mean"] >= 0
            assert stats["total_per_run"] == pytest.approx(
                stats["mean"] * stats["calls_per_run"])
        for name in ("init", "decode", "render", "render_and_losses",
                     "fwd_and_backward", "full_refinement"):
            assert phases[name]["mean"] > 0, (block, name)
    for block in results.values():
        assert block["decode"]["calls_per_run"] == 2
        assert block["full_refinement"]["calls_per_run"] == 1
    (name,) = os.listdir(tmp_path / "out")
    assert name.startswith("runtime_analysis_") and name.endswith(".yaml")
    saved = tconfig.load_config_from_file(str(tmp_path / "out" / name))
    assert saved["results_with_decode"] == results["results_with_decode"]
    assert saved["max_iterations"] == 2
    trace = tmp_path / "trace" / treal.TRACE_FILE
    assert trace.is_file() and trace.stat().st_size > 0


def test_runtime_analysis_phases_match_jax_keys(mug_mesh):
    """The JAX package's runtime analysis at the same config: the same
    blocks, phases, stats and calls per run (with shape optimization)."""
    config = _runtime_config(mug_mesh)
    want = jreal.runtime_analysis(dict(config))
    got = treal.runtime_analysis(dict(config), device="cpu")
    assert set(got) == set(want)
    for block in want:
        assert set(got[block]) == set(want[block]) == PHASES
        for phase, stats in want[block].items():
            assert set(got[block][phase]) == set(stats)
    for phase, stats in want["results_with_decode"].items():
        assert got["results_with_decode"][phase]["calls_per_run"] == (
            stats["calls_per_run"])


def test_main_runs_on_an_image(tmp_path, mug_mesh, capsys):
    """``main`` without ``measure_runtime``: one instance (the valid-depth
    mask, named for the config's category), its estimate printed; with it,
    the runtime analysis and its trace."""
    config = _runtime_config(mug_mesh, measure_runtime=False)
    path = tmp_path / "c.yaml"
    tconfig.save_config_to_file(str(path), config)
    treal.main(["--config", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "'position'" in out and "'category_str': 'cup'" in out
    treal.main(["--config", str(path), "--device", "cpu",
                "--measure_runtime", "--trace", str(tmp_path / "t")])
    assert (tmp_path / "t" / treal.TRACE_FILE).is_file()
    assert "Profiler trace written" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# reference-layout .pt checkpoints
# ---------------------------------------------------------------------------


def _reference_keys(state, config):
    """The port's state dict in the reference's keys (the inverse of the
    key map), with BatchNorm's counters as ``torch.save`` writes them."""
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        module, name = parts[:-1], parts[-1]
        leaf = module[-1]
        kind, _, index = leaf.rpartition("_")
        prefix = ".".join(module[:-1])
        if leaf in ("linear_means", "linear_log_var"):
            new = ".".join(module)
        elif leaf.startswith("features_"):
            new = f"encoder._features.{index}"
        elif kind in ("fc", "conv"):
            new = f"decoder._{kind}_layers.{index}"
        elif kind in ("linear", "bn"):
            group = "_linear_layers" if kind == "linear" else "_bn_layers"
            new = "_" + prefix + f".{group}.{index}"
        else:
            assert leaf == "final", key
            new = "_head._final_layer"
        out[f"{new}.{name}"] = value.clone()
        if name == "running_var":
            out[f"{new}.num_batches_tracked"] = torch.tensor(7)
    return out


@pytest.fixture(scope="module")
def reference_checkpoints(tmp_path_factory):
    """``mug_vae.pt`` / ``mug_init.pt`` in the reference's layout, made
    from the committed msgpack weights."""
    out = tmp_path_factory.mktemp("pt")
    vae = weights.flax_to_torch(msgpack_reader.load(VAE_PATH))
    init = weights.flax_to_torch(msgpack_reader.load(INIT_PATH))
    torch.save(_reference_keys(vae, MUG_PROCEDURAL["vae"]),
               out / "mug_vae.pt")
    torch.save(_reference_keys(init, MUG_PROCEDURAL["init"]),
               out / "mug_init.pt")
    return out


def test_key_maps_equal_jax(reference_checkpoints):
    """The port's key map gives what the JAX converter's tree gives through
    ``flax_to_torch``, for the VAE and the init network."""
    for name, cfg, fn, jfn in (
            ("mug_vae.pt", MUG_PROCEDURAL["vae"],
             convert_torch.convert_vae_state_dict,
             jconvert.convert_vae_checkpoint),
            ("mug_init.pt", MUG_PROCEDURAL["init"],
             convert_torch.convert_init_state_dict,
             jconvert.convert_init_checkpoint)):
        path = str(reference_checkpoints / name)
        got = fn(convert_torch.load_state_dict(path), cfg)
        want = weights.flax_to_torch(jfn(path, cfg))
        assert sorted(got) == sorted(want)
        for key in want:
            torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_iterative_backbone_key_map_equals_jax(tmp_path):
    cfg = {"backbone_type": "IterativePointNet",
           "backbone": {"num_concat": 1, "in_size": 3,
                        "mlp_out_sizes": [8, 16], "batchnorm": True},
           "head": {"in_size": 16, "mlp_out_sizes": [8], "batchnorm": True,
                    "orientation_repr": "quaternion"}}
    torch.manual_seed(0)
    net = create_pose_net(cfg, shape_dimension=4)
    state = {k: v for k, v in net.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    for key in state:
        if key.endswith("running_var"):
            state[key] = torch.rand_like(state[key]) + 0.5
    path = tmp_path / "iter_init.pt"
    torch.save(_reference_keys(state, cfg), path)
    got = convert_torch.init_state_dict(str(path), cfg)
    assert sorted(got) == sorted(state)
    for key in state:
        torch.testing.assert_close(got[key], state[key], rtol=0, atol=0)
    want = weights.flax_to_torch(jconvert.convert_init_checkpoint(str(path),
                                                                  cfg))
    assert sorted(want) == sorted(got)


def _configs(vae_model, init_model):
    config = preset("mug_procedural")
    config["vae"]["model"] = vae_model
    config["init"]["model"] = init_model
    return config


def test_pt_checkpoints_load_like_jax(reference_checkpoints):
    """The port's pipeline on the .pt files: its decoder within 1e-5 of the
    JAX package's conversion, its init network within 1e-5 (in float64,
    with the BatchNorms' running statistics), and both equal to the same
    weights from msgpack."""
    vae_pt = str(reference_checkpoints / "mug_vae.pt")
    init_pt = str(reference_checkpoints / "mug_init.pt")
    pipe = SDFPipeline(_configs(vae_pt, init_pt), device="cpu")
    ref = SDFPipeline(preset("mug_procedural"), device="cpu")
    for net, want in ((pipe.decoder, ref.decoder),
                      (pipe.init_network, ref.init_network)):
        got_state, want_state = net.state_dict(), want.state_dict()
        for key, value in want_state.items():
            if not key.endswith("num_batches_tracked"):
                torch.testing.assert_close(got_state[key], value, rtol=0,
                                           atol=0)
    cfg = MUG_PROCEDURAL["vae"]
    jvae = jcreate_vae(cfg)
    params = jweights.load_vae_params(dict(cfg, model=vae_pt), jvae, 64)
    z = np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32)
    want = np.asarray(jvae.apply({"params": params}, jnp.asarray(z),
                                 method=jvae.decode), np.float32)
    with torch.no_grad():
        got = pipe.decoder(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    icfg = MUG_PROCEDURAL["init"]
    jnet = jcreate_pose_net(icfg, shape_dimension=8)
    variables = jweights.load_init_variables(dict(icfg, model=init_pt), jnet,
                                             500)
    x = np.random.default_rng(1).normal(scale=0.05, size=(2, 500, 3)).astype(
        np.float32)
    # float64 on both sides: the orientation logits reach ~60, where
    # float32's rounding alone is ~4e-6
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       variables)
    jout = jnet.apply(variables, jnp.asarray(x, jnp.float64), train=False)
    net = pipe.init_network.double()
    with torch.no_grad():
        out = net(torch.from_numpy(x).double())
    for g, w in zip(out, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_model_paths_resolve_like_jax(reference_checkpoints, tmp_path,
                                      monkeypatch):
    """``~`` expands, a relative name is found in the reference's weights
    directory under the home, and a missing file raises with the JAX
    package's hint; nothing is downloaded."""
    home = tmp_path / "home"
    target = home / ".sdfest" / "model_weights"
    target.mkdir(parents=True)
    (target / "mug_vae.pt").write_bytes(
        (reference_checkpoints / "mug_vae.pt").read_bytes())
    monkeypatch.setenv("HOME", str(home))
    for model in ("~/.sdfest/model_weights/mug_vae.pt", "mug_vae.pt"):
        got = weights.resolve_model_path({"model": model})
        assert got == jweights._resolve_model_path({"model": model})
        assert os.path.samefile(got, target / "mug_vae.pt")
    assert weights.resolve_model_path({}) is None
    missing = {"model": "~/.sdfest/model_weights/bowl_vae.pt",
               "model_url": "https://example.invalid/bowl_vae.pt"}
    with pytest.raises(FileNotFoundError, match="Download it from") as got:
        weights.resolve_model_path(missing)
    with pytest.raises(FileNotFoundError) as want:
        jweights._resolve_model_path(missing)
    assert str(got.value) == str(want.value)
    cfg = MUG_PROCEDURAL["vae"]
    decoder = SDFPipeline(_configs("~/.sdfest/model_weights/mug_vae.pt",
                                   None), device="cpu").decoder
    assert decoder.fc_0.weight.shape == (20, 8)
    assert jax.tree_util.tree_leaves(jweights.load_vae_params(
        dict(cfg, model="mug_vae.pt"), jcreate_vae(cfg), 64))
