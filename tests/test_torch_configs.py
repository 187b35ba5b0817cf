"""The port's own configs: ``sdfest_torch/configs/`` is a byte-for-byte copy
of ``sdfest_tpu/configs/``, the port resolves its configs there, and no port
module builds a path into the JAX package's directory."""
import os
import re

import pytest

from sdfest_torch.scripts import category_evaluation as tce
from sdfest_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, JAX = (os.path.join(ROOT, p, "configs")
             for p in ("sdfest_torch", "sdfest_tpu"))


def _files(base):
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, files in os.walk(base) for f in files)


def test_both_trees_list_the_same_files():
    files = _files(PORT)
    assert files == _files(JAX)
    assert len(files) == 68


@pytest.mark.parametrize("subdir", ["estimation", "init", "vae"])
def test_configs_are_byte_copies(subdir):
    files = _files(os.path.join(JAX, subdir))
    assert files
    for name in files:
        with open(os.path.join(PORT, subdir, name), "rb") as f:
            got = f.read()
        with open(os.path.join(JAX, subdir, name), "rb") as f:
            assert got == f.read(), name


def test_configs_resolve_inside_the_port(tmp_path, monkeypatch):
    """Repository-relative names resolve to the port's copy from any
    working directory, and the category evaluation reads the port's
    estimation configs."""
    monkeypatch.chdir(tmp_path)
    path = tconfig.resolve_path("configs/vae/mug_procedural.yaml")
    assert path == os.path.join(PORT, "vae", "mug_procedural.yaml")
    assert tce._ESTIMATION_CONFIG_DIR == os.path.join(PORT, "estimation")
    config = tconfig.load_config_from_file(
        "configs/estimation/real275_evaluation.yaml")
    # its include (./real275.yaml) resolved beside it
    assert config["max_iterations"] == 30
    assert config["camera"]["fx"] == 591.0125


def test_no_port_module_builds_a_path_into_the_jax_package():
    """No string of the port names the JAX package's directory as a path
    component: ``"sdfest_tpu/..."`` or a ``"sdfest_tpu",`` argument of a
    path join (docstrings name its modules as ``sdfest_tpu/...`` for
    reference, and metric names as ``sdfest_tpu.pipeline.metrics.<f>``)."""
    pattern = re.compile(r"""["']sdfest_tpu(["']\s*,|[/\\])""")
    hits = []
    for d, _, files in os.walk(os.path.join(ROOT, "sdfest_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    for i, line in enumerate(fh, 1):
                        if pattern.search(line):
                            hits.append(f"{f}:{i}: {line.strip()}")
    assert not hits, hits
