"""What a run loads: nothing of JAX or of the JAX package (compared by
whole top-level names; the port's name begins with the JAX package's), and
a reference that imports nothing of the port."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "sdfest_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'bench_port/tests')\n"
            "from conftest import small_cell, run_small\n"
            "run_small(small_cell('mug_procedural.frames'))\n"
            "run_small(small_cell('mug_procedural.vae_train'))\n"
            "import bench_port.control")
    names = loaded_after(code)
    assert "sdfest_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after("import bench_port.reference.estimate, "
                         "bench_port.reference.train")
    assert not names & (FORBIDDEN | {"sdfest_torch"})


def test_no_source_of_the_reference_names_the_port():
    ref = os.path.join(ROOT, "bench_port", "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""]
                    if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"sdfest_torch"}, \
                    (name, m)
