"""The port's remaining scripts against the JAX package's (CPU):
``experiments.offset_experiment``, the ``benchmark_vae`` and
``benchmark_ops`` micro-benchmarks, ``latent_explorer.LatentExplorer`` on
the committed mug VAE, and ``process_shapenet`` (the coverage of
``test_misc_scripts.py``, plus parity).  The JAX package runs in float32
here (``jax.enable_x64(False)``; ``tests/conftest.py`` turns x64 on for the
rest of the suite).  Tolerances are stated where they are used.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdfest_torch.ops.camera import Camera
from sdfest_torch.scripts import benchmark_ops, benchmark_vae
from sdfest_torch.scripts import experiments
from sdfest_torch.scripts import latent_explorer
from sdfest_torch.scripts import process_shapenet
from sdfest_torch.pipeline.synthetic import save_obj
from sdfest_torch.utils.presets import preset
from sdfest_tpu.ops.camera import Camera as JCamera
from sdfest_tpu.scripts import experiments as jexperiments
from sdfest_tpu.scripts import latent_explorer as jlatent_explorer
from sdfest_tpu.scripts import process_shapenet as jprocess_shapenet

from test_misc_scripts import _cube_obj
from test_training import tiny_vae_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_PATH = os.path.join(ROOT, "trained_models/mug_procedural/"
                        "mug_procedural.msgpack")
CAMERA = dict(width=64, height=48, fx=32, fy=32, cx=32, cy=24,
              pixel_center=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (many small CPU ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# experiments
# ---------------------------------------------------------------------------


def test_offset_experiment_recovers_pose_and_starts_as_jax():
    """200 Adam steps on the sphere at 64x48, the march of the JAX
    package's CPU backend (no culling, no adaptive relaxation) and JAX's
    start (its position draw): the target render and the first loss within
    1e-5 of JAX's, then ``test_offset_experiment_recovers_pose``'s bars
    (the loss falls below a tenth, the position error from > 0.05 to <
    0.01, the scale error below 0.005)."""
    sdf = experiments.sphere_sdf(64)
    with jax.enable_x64(False):
        noise = np.array(jax.random.normal(jax.random.PRNGKey(0), (3,)))
        want = jexperiments.offset_experiment(
            jnp.asarray(sdf), JCamera(**CAMERA), iterations=1,
            backend="xla", seed=0)
    result = experiments.offset_experiment(
        sdf, Camera(**CAMERA), iterations=200, device="cpu",
        position_noise=noise, plain=True)
    np.testing.assert_allclose(result["target"], np.asarray(want["target"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(result["losses"][0], want["losses"][0],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(result["position_error"][0],
                               want["position_error"][0], atol=1e-6)
    losses = result["losses"]
    assert losses.shape == (200,)
    assert float(losses[-1]) < 0.1 * float(losses[0])
    pos0, pos1 = result["position_error"]
    assert pos0 > 0.05 and pos1 < 0.01
    assert result["scale_error"][1] < 0.005
    assert result["final_render"].shape == (48, 64)


# ---------------------------------------------------------------------------
# micro-benchmarks
# ---------------------------------------------------------------------------


def test_benchmark_vae_smoke():
    config = tiny_vae_config(res=16)
    config["model"] = None
    results = benchmark_vae.benchmark(config, iterations=3, device="cpu")
    assert results["decode_forward_s"] > 0
    assert results["decode_forward_backward_s"] > 0
    assert results["device"] == "cpu"


def test_benchmark_ops_smoke(capsys):
    times = benchmark_ops.main(["--iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Conv3d" in out and "Linear" in out and "Trilinear" in out
    assert set(times) == {"conv3d", "linear", "trilinear"}
    assert all(t > 0 for t in times.values())


def test_benchmark_ops_conv_is_flax_same_padding():
    """The timed Conv3d keeps the 16^3 volume (flax's SAME padding)."""
    conv = torch.nn.Conv3d(8, 16, kernel_size=3, padding="same")
    assert conv(torch.zeros(1, 8, 16, 16, 16)).shape == (1, 16, 16, 16, 16)


# ---------------------------------------------------------------------------
# latent explorer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def explorers():
    config = dict(preset("vae_mug_procedural"), model=VAE_PATH)
    with jax.enable_x64(False):
        jexp = jlatent_explorer.LatentExplorer(config)
    return latent_explorer.LatentExplorer(config, device="cpu"), jexp


def _latents(n, seed=0):
    return (0.7 * np.random.default_rng(seed).normal(size=(n, 8))).astype(
        np.float32)


def test_explorer_decode_and_encode_match_jax(explorers):
    """The committed mug VAE: decoded grids and encoded means within 1e-5
    of the JAX explorer's."""
    port, jexp = explorers
    zs = _latents(2)
    with jax.enable_x64(False):
        want = jexp.decode(zs)
        want_z = jexp.encode(want[0, 0])
    got = port.decode(zs)
    assert got.shape == want.shape == (2, 1, 64, 64, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got_z = port.encode(want[0, 0])
    assert got_z.shape == (8,)
    np.testing.assert_allclose(got_z, want_z, rtol=0, atol=1e-5)


def test_explorer_sweep_and_interpolate_match_jax(explorers, tmp_path):
    """A 3-value sweep of latent dimension 2 and a 3-step interpolation
    between two decoded shapes: within 1e-5 of the JAX explorer's; a
    keyframe file loads as the latent it holds or the encoding of the SDF
    it holds."""
    port, jexp = explorers
    values = np.linspace(-1.0, 1.0, 3)
    sdfs = port.decode(_latents(2, seed=1))[:, 0]
    with jax.enable_x64(False):
        want_sweep = jexp.sweep(2, values)
        want_interp = jexp.interpolate(sdfs[0], sdfs[1], 3)
    got_sweep = port.sweep(2, values)
    assert got_sweep.shape == (3, 64, 64, 64)
    np.testing.assert_allclose(got_sweep, want_sweep, rtol=0, atol=1e-5)
    got_interp = port.interpolate(sdfs[0], sdfs[1], 3)
    np.testing.assert_allclose(got_interp, want_interp, rtol=0, atol=1e-5)
    np.save(tmp_path / "z.npy", _latents(1)[0])
    np.save(tmp_path / "sdf.npy", sdfs[0])
    np.testing.assert_array_equal(port.load_keyframe(str(tmp_path / "z.npy")),
                                  _latents(1)[0])
    np.testing.assert_allclose(port.load_keyframe(str(tmp_path / "sdf.npy")),
                               port.encode(sdfs[0]), atol=0)


def test_explorer_animate_matches_jax(explorers):
    """2 keyframes, 2 frames per segment, half a turn: the JAX explorer's
    frame count and 320x240 shape, each frame's hit mask (shaded > 0)
    agreeing on > 0.995 of the pixels (the port's CPU march culls and
    over-relaxes; JAX's CPU march does neither)."""
    port, jexp = explorers
    keyframes = list(_latents(2, seed=2))
    with jax.enable_x64(False):
        want = jexp.animate(keyframes, 2, turn=0.5)
    got = port.animate(keyframes, 2, turn=0.5)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == np.shape(w) == (240, 320)
        assert (g > 0).sum() > 500
        assert ((g > 0) == (np.asarray(w) > 0)).mean() > 0.995


# ---------------------------------------------------------------------------
# process_shapenet
# ---------------------------------------------------------------------------


def _shapenet_tree(tmp_path, names=("modelA", "modelB")):
    """``test_misc_scripts.py``'s tree with its cube turned by a generic
    rotation: on the axis-aligned cube the voxelizer's rays run along the
    faces' diagonals, cross two triangles' shared edge, and the parity
    there depends on the compiler's FMAs (``test_torch_mesh.py``), so the
    two packages' libraries may read those cells differently."""
    from scipy.spatial.transform import Rotation

    rot = Rotation.from_euler("XYZ", [17, -29, 41], degrees=True)
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float64)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]])
    inp = tmp_path / "shapenet"
    for name in names:
        d = inp / name / "models"
        d.mkdir(parents=True)
        save_obj(str(d / "model_normalized.obj"), rot.apply(v), f)
    return inp


def test_process_shapenet_converts_paired_outputs_as_jax(tmp_path):
    """Paired %05d.obj / .npy outputs (the turned cube: negative at the
    centre, positive at the padded corner); the SDFs within 1e-6 of the
    JAX script's."""
    inp = _shapenet_tree(tmp_path)
    out, jout = tmp_path / "out", tmp_path / "jout"
    n = process_shapenet.process(str(inp), str(out), resolution=16,
                                 padding=2, jobs=1)
    assert n == jprocess_shapenet.process(str(inp), str(jout), resolution=16,
                                          padding=2, jobs=1) == 2
    for i in range(2):
        assert os.path.exists(out / f"{i:05}.obj")
        sdf = np.load(out / f"{i:05}.npy")
        assert sdf.shape == (16, 16, 16)
        assert sdf[8, 8, 8] < 0 and sdf[0, 0, 0] > 0
        np.testing.assert_allclose(sdf, np.load(jout / f"{i:05}.npy"),
                                   rtol=0, atol=1e-6)


def test_process_shapenet_filter_json(tmp_path):
    inp = _shapenet_tree(tmp_path)
    selection = tmp_path / "good_meshes.json"
    selection.write_text(json.dumps({"modelA": True, "modelB": False}))
    out = tmp_path / "filtered"
    n = process_shapenet.process(str(inp), str(out), resolution=16,
                                 padding=2, filter_json=str(selection),
                                 jobs=1)
    assert n == 1
    assert os.path.exists(out / "00000.npy")
    assert not os.path.exists(out / "00001.npy")


def test_process_shapenet_reference_final_meshes_format(tmp_path):
    synset = "03797390"
    inp = tmp_path / "my_shapenet_root" / synset
    for name in ("keepme", "dropme"):
        d = inp / name / "models"
        d.mkdir(parents=True)
        _cube_obj(str(d / "model_normalized.obj"))
    selection = tmp_path / "final_meshes.json"
    selection.write_text(json.dumps({
        f"./data/shapenet/{synset}/": [
            f"./data/shapenet/{synset}/keepme/models/model_normalized.obj",
        ],
    }))
    frags = process_shapenet.load_filter(str(selection))
    assert frags == jprocess_shapenet.load_filter(str(selection)) == {
        f"{synset}/keepme/models/model_normalized.obj"}
    out = tmp_path / "filtered"
    n = process_shapenet.process(str(inp), str(out), resolution=16,
                                 padding=2, filter_json=str(selection),
                                 jobs=1)
    assert n == 1
    assert os.path.exists(out / "00000.npy")
    assert not os.path.exists(out / "00001.npy")


def test_shipped_final_meshes_load_as_in_jax():
    path = os.path.join(ROOT, "final_meshes.json")
    frags = process_shapenet.load_filter(path)
    assert frags == jprocess_shapenet.load_filter(path)
    assert len(frags) == 286 + 98 + 114 + 365 + 68 + 31


def test_process_shapenet_review_sheet(tmp_path):
    pytest.importorskip("matplotlib")
    inp = _shapenet_tree(tmp_path)
    sheet = tmp_path / "sheet.png"
    template = tmp_path / "good_meshes.json"
    n = process_shapenet.review_sheet(str(inp), str(sheet), str(template),
                                      cols=2)
    assert n == 2
    assert sheet.exists() and sheet.stat().st_size > 0
    selection = json.loads(template.read_text())
    assert len(selection) == 2 and all(selection.values())


def test_process_shapenet_main_converts(tmp_path):
    inp = _shapenet_tree(tmp_path, names=("modelA",))
    out = tmp_path / "cli"
    process_shapenet.main(["--inp_folder", str(inp), "--out_folder",
                           str(out), "--resolution", "16", "--jobs", "1"])
    assert sorted(os.listdir(out)) == ["00000.npy", "00000.obj"]
