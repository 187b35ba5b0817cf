"""The port's training scripts on the CPU: the presets against the JAX
package's resolved YAML, the YAML includes and command lines, a 3-step
``train_vae.train`` and a 2-unit replay ``train_init`` run with checkpoint,
resume and model export, and the exported models read back by both
packages."""
import copy
import os
import sys
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from sdfest_tpu.models.pose_net import create_pose_net as jcreate_pose_net
from sdfest_tpu.models.vae import create_vae_from_config as jcreate_vae
from sdfest_tpu.utils import config as jconfig
from sdfest_tpu.utils import weights as jweights
from sdfest_torch.pipeline.pipeline import SDFPipeline
from sdfest_torch.scripts import make_procedural_dataset, train_init, train_vae
from sdfest_torch.utils import checkpoint
from sdfest_torch.utils import config as tconfig
from sdfest_torch.utils import msgpack_reader
from sdfest_torch.utils.logging import make_logger
from sdfest_torch.utils.presets import preset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET_YAML = {
    "vae_mug_procedural": "configs/vae/mug_procedural.yaml",
    "init_mug_procedural_v3": "configs/init/mug_procedural_v3.yaml",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread while this module runs (as in
    ``test_torch_batch.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(PRESET_YAML))
def test_training_presets_match_resolved_yaml(name):
    path = os.path.join(ROOT, "sdfest_tpu", PRESET_YAML[name])
    assert preset(name) == jconfig.load_config_from_file(path)


@pytest.mark.parametrize("name", sorted(PRESET_YAML))
def test_yaml_includes_match_jax(name):
    """The port resolves the JAX package's configs (file and namespaced
    includes) by their package-relative names, as that package does."""
    assert tconfig.load_config_from_file(PRESET_YAML[name]) == \
        jconfig.load_config_from_file(PRESET_YAML[name])


def test_command_line_overrides_match_jax(tmp_path):
    child = tmp_path / "child.yaml"
    child.write_text("a: 1\nb: {c: 2, d: 3}\n")
    parent = tmp_path / "parent.yaml"
    parent.write_text("config:\n  - child.yaml\n  - sub: child.yaml\n"
                      "b: {d: 4}\n")
    argv = ["--config", str(parent), "--b.c", "1e-4", "--e", "[1, 2]",
            "--flag", "--x.y=z"]
    import argparse

    def parser():
        p = argparse.ArgumentParser()
        p.add_argument("--config", nargs="+")
        return p

    got = tconfig.load_config_from_args(parser(), argv)
    assert got == jconfig.load_config_from_args(parser(), argv)
    assert got["b"] == {"c": 1e-4, "d": 4} and got["sub"]["a"] == 1


def _mug_data(path, n):
    make_procedural_dataset.generate(str(path), n, res=64, seed=1)
    return str(path)


def _vae_config(tmp_path, **overrides):
    config = preset("vae_mug_procedural")
    config.update(
        dataset_path=_mug_data(tmp_path / "mugs", 4), batch_size=2,
        iterations=3, checkpoint_iteration=2, pc_render_width=64,
        pc_render_height=48, model_dir=str(tmp_path / "vae"),
        scalar_csv=str(tmp_path / "vae" / "scalars.csv"))
    config.update(overrides)
    return config


def test_train_vae_steps_resume_and_export(tmp_path):
    config = _vae_config(tmp_path)
    out = train_vae.train(copy.deepcopy(config), device="cpu")
    trainer = out["trainer"]
    assert trainer.iteration == 3
    assert os.path.exists(tmp_path / "vae" / "2.ckpt.meta.json")
    # resume from the checkpoint at 2: one more step to 3
    resumed = train_vae.train(
        dict(copy.deepcopy(config), checkpoint=str(tmp_path / "vae"
                                                   / "2.ckpt")),
        device="cpu")["trainer"]
    assert resumed.iteration == 3
    # the exported msgpack (the resumed run's, written last) reads back
    # exactly in the JAX package
    jvae = jcreate_vae(config)
    template = jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64, 64)),
                         jax.random.PRNGKey(1))["params"]
    got = jweights.load_params(out["model"], template)
    state = resumed.vae.state_dict()
    np.testing.assert_array_equal(
        np.asarray(got["decoder"]["conv_0"]["kernel"]),
        state["decoder.conv_0.weight"].numpy().transpose(2, 3, 4, 1, 0))
    np.testing.assert_array_equal(
        np.asarray(got["encoder"]["linear_means"]["kernel"]),
        state["encoder.linear_means.weight"].numpy().T)
    with open(out["config"]) as f:
        saved = yaml.safe_load(f)
    assert saved["model"] == "./mug_procedural.msgpack"
    # and the port's pipeline estimates with it
    pipe_config = preset("mug_procedural")
    pipe_config["vae"]["model"] = out["model"]
    pipe = SDFPipeline(pipe_config, device="cpu")
    for k, v in pipe.decoder.state_dict().items():
        torch.testing.assert_close(v, state["decoder." + k], rtol=0, atol=0)
    rows = open(tmp_path / "vae" / "scalars.csv").read().splitlines()
    assert rows[0] == "step,name,value"


def test_train_vae_benchmark_and_main(tmp_path, capsys):
    config = _vae_config(tmp_path)
    assert train_vae.benchmark(config, steps=1, device="cpu") > 0
    train_vae.main(["--preset", "vae_mug_procedural", "--device", "cpu",
                    "--dataset_path", config["dataset_path"],
                    "--batch_size", "2", "--iterations", "1",
                    "--pc_weight", "0", "--model_dir",
                    str(tmp_path / "main"), "--run_name", "m",
                    "--scalar_csv", ""])
    assert os.path.exists(tmp_path / "main" / "m.msgpack")
    assert "train step:" in capsys.readouterr().out


def _init_config(tmp_path, **overrides):
    config = preset("init_mug_procedural_v3")
    for group in ("datasets", "validation_datasets"):
        for spec in config[group].values():
            spec["config_dict"].update(width=64, height=48)
    config.update(
        num_points=100, batch_size=4, replay_buffer_size=16,
        replay_train_steps=3, replay_train_batch=8, iterations=6,
        checkpoint_iteration=3, validation_iteration=3,
        validation_batches=1, model_dir=str(tmp_path / "init"),
        scalar_csv=str(tmp_path / "init" / "scalars.csv"))
    config["backbone"]["mlp_out_sizes"] = [16, 32]
    config["head"].update(in_size=32, mlp_out_sizes=[16])
    config.update(overrides)
    return config


def test_train_init_replay_units_resume_and_export(tmp_path, capsys):
    config = _init_config(tmp_path)
    out = train_init.Trainer(copy.deepcopy(config), device="cpu").run()
    trainer = out["trainer"]
    assert trainer.iteration == 6  # 2 units of 3 steps
    text = capsys.readouterr().out
    assert "orientation_ce" in text and "Validation" in text
    assert sorted(f for f in os.listdir(tmp_path / "init")
                  if f.endswith(".ckpt")) == ["3.ckpt", "6.ckpt"]
    # resume: the latest checkpoint, then 3 more steps
    resumed = train_init.Trainer(dict(copy.deepcopy(config), iterations=9),
                                 device="cpu").run()
    assert "Resumed from" in capsys.readouterr().out
    assert resumed["trainer"].iteration == 9
    # the exported params and batch_stats (the resumed run's, written last)
    # read back exactly in the JAX package
    jnet = jcreate_pose_net(config, shape_dimension=8)
    template = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 100, 3)))
    got = jweights.load_params(out["model"], template)
    state = resumed["trainer"].net.state_dict()
    np.testing.assert_array_equal(
        np.asarray(got["batch_stats"]["head"]["bn_0"]["var"]),
        state["head.bn_0.running_var"].numpy())
    np.testing.assert_array_equal(
        np.asarray(got["params"]["backbone"]["linear_1"]["kernel"]),
        state["backbone.linear_1.weight"].numpy().T)
    # the port's pipeline loads it with the config saved beside it
    pipe_config = preset("mug_procedural")
    with open(out["config"]) as f:
        pipe_config["init"] = dict(yaml.safe_load(f), model=out["model"])
    pipe = SDFPipeline(pipe_config, device="cpu")
    torch.testing.assert_close(pipe.init_network.state_dict()[
        "head.bn_0.running_var"], state["head.bn_0.running_var"])


def _redwood_tree(tmp_path, frames):
    """The Redwood fixture of ``test_datasets.py`` with ``frames``
    annotations of its one frame."""
    import json

    from test_datasets import _make_redwood_fixture

    root_dir, ann_dir, _, _ = _make_redwood_fixture(tmp_path)
    with open(ann_dir / "annotations.json") as f:
        anns = json.load(f)
    anns["seq1"]["pose_anns"] *= frames
    with open(ann_dir / "annotations.json", "w") as f:
        json.dump(anns, f)
    return root_dir, ann_dir


def test_train_init_datasets_seeds_and_real_data(tmp_path):
    config = _init_config(tmp_path, replay_buffer_size=0, iterations=2,
                          validation_iteration=0, checkpoint_iteration=0)
    trainer = train_init.Trainer(copy.deepcopy(config), device="cpu")
    # zero-probability NOCS datasets are skipped; the fresh stream trains
    assert trainer.run()["trainer"].iteration == 2
    assert train_init.data_seed("generated_dataset") == \
        zlib.crc32(b"generated_dataset") % 2 ** 31
    assert trainer.benchmark(steps=1) > 0
    # a real-data dataset beside the generated one: a Redwood tree of 4
    # annotated frames, batched on the host without a latent target
    root_dir, ann_dir = _redwood_tree(tmp_path, frames=4)
    config["datasets"]["camera_train"] = {
        "type": "AnnotatedRedwoodDataset", "probability": 0.5,
        "config_dict": {"root_dir": str(root_dir), "ann_dir": str(ann_dir),
                        "normalize_pointcloud": True,
                        "mask_pointcloud": True, "remap_y_axis": "y",
                        "remap_x_axis": "-z"}}
    config.update(iterations=4, validation_iteration=2)
    config["validation_datasets"] = {"redwood": config["datasets"][
        "camera_train"]}
    real = train_init.Trainer(copy.deepcopy(config), device="cpu")
    # the trainer's dataset config (its orientation representation and
    # category written in)
    batch = next(real._create_dataset(
        "camera_train", real._init_config["datasets"]["camera_train"]))
    assert set(batch) == {"pointset", "position", "scale", "orientation",
                          "quaternion"}
    assert batch["pointset"].shape == (4, 100, 3)
    assert batch["orientation"].dtype == torch.int64  # the grid cell
    assert real.run()["trainer"].iteration == 4


def test_train_init_trains_on_a_nocs_tree(tmp_path):
    """A NOCS dataset (the miniature tree of ``test_torch_datasets.py``:
    one ``real_train`` instance whose pose comes from its NOCS map) as the
    only data source, at a batch of 1; a batch larger than the dataset
    raises instead of waiting forever for a batch."""
    from test_torch_datasets import _write_frame

    _write_frame(tmp_path / "nocs", "real_train", with_nocs_map=True)
    config = _init_config(tmp_path, replay_buffer_size=0, iterations=2,
                          validation_iteration=0, checkpoint_iteration=0,
                          batch_size=1)
    config["datasets"] = {"real_train": {
        "type": "NOCSDataset", "probability": 1.0,
        "config_dict": {"root_dir": str(tmp_path / "nocs"),
                        "split": "real_train", "mask_pointcloud": True,
                        "normalize_pointcloud": True, "remap_y_axis": "y",
                        "remap_x_axis": "-z"}}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "joblib", None)  # preprocess in one process
        out = train_init.Trainer(copy.deepcopy(config), device="cpu").run()
    assert out["trainer"].iteration == 2
    config["batch_size"] = 2
    with pytest.raises(ValueError, match="fewer than a batch of 2"):
        train_init.Trainer(copy.deepcopy(config), device="cpu").run()


def test_train_init_main_from_yaml_includes(tmp_path):
    """``--config`` resolves the JAX package's v3 YAML and its includes as
    data; dotted flags shrink it."""
    train_init.main([
        "--config", "configs/init/mug_procedural_v3.yaml", "--device", "cpu",
        "--iterations", "2", "--replay_buffer_size", "8",
        "--replay_train_steps", "2", "--replay_train_batch", "4",
        "--batch_size", "4", "--num_points", "50",
        "--datasets.generated_dataset.config_dict.width", "64",
        "--datasets.generated_dataset.config_dict.height", "48",
        "--validation_iteration", "0", "--resume", "false",
        "--backbone.mlp_out_sizes", "[8, 16]", "--head.in_size", "16",
        "--head.mlp_out_sizes", "[8]", "--model_dir", str(tmp_path / "m"),
        "--scalar_csv", str(tmp_path / "m" / "s.csv")])
    tree = msgpack_reader.load(str(tmp_path / "m"
                                   / "init_mug_procedural_v3.msgpack"))
    assert tree["params"]["head"]["final"]["kernel"].shape == (8, 8 + 4 + 576)


def test_checkpoint_meta_logger_and_csv_trim(tmp_path):
    logger = make_logger({"scalar_csv": str(tmp_path / "s.csv")}, "r")
    for step in (20, 40, 60):
        logger.add_scalar("loss", float(step), step)
    logger.close()
    assert make_logger({}, "r") is None
    train_init._trim_scalar_csv(str(tmp_path / "s.csv"), 40)
    assert open(tmp_path / "s.csv").read().splitlines() == [
        "step,name,value", "20,loss,20.0", "40,loss,40.0"]

    class Holder:
        def __init__(self):
            self.iteration = 7

        def state_dict(self):
            return {"iteration": self.iteration}

    checkpoint.save_checkpoint(str(tmp_path / "c" / "7.ckpt"), Holder(), 7,
                               "run")
    with open(tmp_path / "c" / "7.ckpt.meta.json") as f:
        assert yaml.safe_load(f) == {"iteration": 7, "run_name": "run",
                                     "epoch": 0}


def test_rendering_evaluation_main_reads_yaml_includes(monkeypatch):
    """The evaluation script's command line resolves the JAX package's
    evaluation config and its includes as that package does."""
    from sdfest_torch.scripts import rendering_evaluation

    seen = {}

    class Capture:
        def __init__(self, config, device):
            seen.update(config=config, device=device)

        def run(self):
            seen["ran"] = True

    monkeypatch.setattr(rendering_evaluation, "Evaluator", Capture)
    path = "configs/estimation/rendering_evaluation_mug_procedural.yaml"
    rendering_evaluation.main(["--config", path, "--device", "cpu",
                               "--num_views", "[1]"])
    want = jconfig.load_config_from_file(path)
    want["num_views"] = [1]
    assert seen == {"config": want, "device": "cpu", "ran": True}
