"""Parity of the port's host C++ library (``sdfest_torch/native``) with the
JAX package's (CPU): marching tetrahedra on the same grids, the voxelizer on
an icosphere bit for bit, the ``mesh_to_sdf`` round trip, and the port
building its own copy of the source without loading the JAX package's
library."""
import os
import subprocess
import sys

import numpy as np
import pytest

from sdfest_tpu.native import api as jnative
from sdfest_tpu.ops import sdf_utils as jsdf_utils
from sdfest_tpu.pipeline import synthetic as jsynthetic
from sdfest_torch import native
from sdfest_torch.native import api as tnative
from sdfest_torch.ops import marching_cubes as tmc
from sdfest_torch.ops import sdf_utils as tsdf_utils
from sdfest_torch.pipeline import synthetic as tsynthetic
from sdfest_torch.utils import scenes as tscenes

from conftest import make_box_sdf, make_sphere_sdf
from test_native import _icosphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grids():
    rng = np.random.default_rng(0)
    noisy = make_sphere_sdf(24, 0.6) + 0.05 * rng.standard_normal(
        (24, 24, 24)).astype(np.float32)
    return {"sphere": make_sphere_sdf(32, 0.5), "box": make_box_sdf(33),
            "mug": tscenes.make_mug_sdf(32), "noisy": noisy}


@pytest.mark.parametrize("name", sorted(_grids()))
def test_native_marching_tetrahedra_equals_jax(name):
    grid = _grids()[name]
    for level in (0.0, 0.02):
        got = tnative.marching_tetrahedra(grid, level)
        want = jnative.marching_tetrahedra(grid, level)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_marching_cubes_takes_the_native_path(monkeypatch):
    """``marching_cubes`` returns the native surface (scaled by the
    spacing); with the library off, the numpy path's."""
    grid = make_sphere_sdf(24, 0.5)
    verts, faces = tmc.marching_cubes(grid, 0.0, spacing=(0.5, 0.5, 0.5))
    nat = tnative.marching_tetrahedra(grid, 0.0)
    np.testing.assert_array_equal(faces, nat[1])
    np.testing.assert_array_equal(verts, nat[0] * 0.5)
    monkeypatch.setattr(tnative, "available", lambda: False)
    verts, faces = tmc.marching_cubes(grid, 0.0)
    np.testing.assert_array_equal(faces,
                                  tmc.marching_tetrahedra_np(grid, 0.0)[1])


@pytest.mark.parametrize("res", [32, 64])
def test_voxelize_icosphere_equals_jax(res):
    verts, faces = _icosphere(3, radius=0.5)
    got = tnative.voxelize_mesh(verts, faces, res=res)
    assert got.dtype == np.float32 and got.shape == (res,) * 3
    np.testing.assert_array_equal(got,
                                  jnative.voxelize_mesh(verts, faces, res=res))


def _sign_agreement(grid, level, vertices, to_index, back):
    """Sign of ``back`` (``mesh_to_sdf`` of the surface of ``grid`` at
    ``level``, whose ``vertices`` map to ``grid``'s index space by the
    affine ``to_index``) against ``grid - level``: each cell of ``back``
    mapped through mesh_to_sdf's stretch to the unit cube back into
    ``grid``'s index space and sampled there (trilinear), on the cells more
    than 2 of ``grid``'s voxels from the surface.  Returns (cells compared,
    cells that disagree)."""
    from scipy.ndimage import map_coordinates

    res = grid.shape[0]
    lo, hi = vertices.min(axis=0), vertices.max(axis=0)
    coords = np.linspace(-1.0, 1.0, back.shape[0])
    stretched = np.stack(np.meshgrid(coords, coords, coords, indexing="ij"),
                         axis=-1)
    idx = to_index(stretched * np.max(hi - lo) / 2.0 + (lo + hi) / 2.0)
    inside = np.all((idx >= 0) & (idx <= res - 1), axis=-1)
    vals = map_coordinates(grid, idx.reshape(-1, 3).T, order=1).reshape(
        back.shape) - level
    far = inside & (np.abs(vals) > 2 * 2.0 / (res - 1))
    return int(far.sum()), int((np.sign(vals[far]) != np.sign(back[far])).sum())


def test_mesh_to_sdf_round_trip():
    """A procedural mug grid -> mesh -> grid: the sign agrees with the grid
    on every compared cell more than 2 voxels from the surface, and the JAX
    package voxelizes the same mesh to the same grid (within 1e-6: its
    library is built with ``-march=native``, whose fused multiply-adds move
    the last bits of a few cells)."""
    res = 32
    grid = tscenes.make_mug_sdf(res)
    mesh = tsdf_utils.mesh_from_sdf(grid, level=0.0)
    back = tsdf_utils.mesh_to_sdf(mesh, res)
    want = jsdf_utils.mesh_to_sdf(
        jsynthetic.Mesh(vertices=mesh.vertices, faces=mesh.faces), res)
    np.testing.assert_allclose(back, want, rtol=0, atol=1e-6)
    # mesh_from_sdf puts index i at 2 i / res - 1
    compared, disagree = _sign_agreement(
        grid, 0.0, mesh.vertices, lambda v: (v + 1.0) * res / 2.0, back)
    assert compared > 5000 and disagree == 0


def test_port_builds_its_own_library():
    """The port compiles its own copy of the source into its build tree
    (keyed by source and flags) and never loads the JAX package's library
    or imports the JAX package."""
    assert native.SOURCE.startswith(os.path.join(ROOT, "sdfest_torch"))
    with open(native.SOURCE) as f, open(os.path.join(
            ROOT, "sdfest_tpu/native/src/sdfest_native.cpp")) as g:
        ours, theirs = f.read(), g.read()
    body = ours[ours.index("#include"):]
    assert body == theirs[theirs.index("#include"):]
    assert native.library_path().startswith(
        os.path.join(ROOT, "sdfest_torch", "_build", "native-"))
    code = (
        "import sys\n"
        "for m in ('jax', 'sdfest_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from sdfest_torch.native import api\n"
        "from sdfest_torch.ops.sdf_utils import mesh_to_sdf\n"
        "assert api.available()\n"
        "api.marching_tetrahedra(np.linspace(-1, 1, 27, dtype=np.float32)"
        ".reshape(3, 3, 3), 0.0)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'sdfest_tpu' not in maps, 'the JAX library is loaded'\n"
        "assert 'libsdfest_native.so' in maps\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source that does not compile raises with the compiler's output;
    nothing falls back."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="host library build failed"):
        native.load()
    with pytest.raises(RuntimeError, match="host library build failed"):
        tnative.available()
