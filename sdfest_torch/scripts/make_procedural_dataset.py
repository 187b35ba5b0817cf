"""Generate a procedural SDF data set: ``python -m
sdfest_torch.scripts.make_procedural_dataset --out data/mugs --n 1000``
(counterpart of ``sdfest_tpu/scripts/make_procedural_dataset.py``).

Writes ``{out}/00000.npy ...`` (one SDF grid per shape, the layout of the
JAX package's ``SDFDataset``) plus a ``params.json`` recording the
per-sample generator parameters, so the exact set is reproducible from the
seed alone.  ``--export_meshes`` also writes each shape's isosurface as
``{out}/00000.obj``: the held-out sets of the rendering evaluation
(:mod:`sdfest_torch.scripts.rendering_evaluation`) are made this way, e.g.
``--seed 777 --export_meshes``.  The meshes come from the port's numpy
marching tetrahedra; the JAX package's script takes its host C++ library
instead where that is built, whose meshes differ slightly.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from sdfest_torch.utils.scenes import (
    make_bowl_family_sdf,
    make_mug_family_sdf,
    sample_bowl_family,
    sample_mug_family,
)

FAMILIES = {
    "mug": (make_mug_family_sdf, sample_mug_family),
    "bowl": (make_bowl_family_sdf, sample_bowl_family),
}


def generate(out: str, n: int, res: int = 64, seed: int = 0,
             dtype: str = "float16", export_meshes: bool = False,
             category: str = "mug") -> list:
    """Write ``n`` shape-family SDF grids to ``out``; returns the params list.

    ``float16`` storage halves the footprint; values span ~[-2, 2] with a
    surface band ~1/res, well inside fp16 range/precision (SDFDataset
    casts back to float32 on load).
    """
    make_sdf, sample_params = FAMILIES[category]
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    all_params = []
    for i in range(n):
        params = sample_params(rng)
        sdf = make_sdf(res, **params)
        np.save(os.path.join(out, f"{i:05d}.npy"), sdf.astype(dtype))
        if export_meshes:
            # .obj alongside: the rendering_evaluation harness consumes
            # meshes, so held-out eval sets are generated with this flag
            from sdfest_torch.ops.sdf_utils import mesh_from_sdf
            from sdfest_torch.pipeline.synthetic import save_obj

            mesh = mesh_from_sdf(sdf, complete_mesh=True)
            if mesh is not None:
                save_obj(
                    os.path.join(out, f"{i:05d}.obj"),
                    mesh.vertices,
                    mesh.faces,
                )
        all_params.append(params)
    with open(os.path.join(out, "params.json"), "w") as f:
        json.dump(
            {"seed": seed, "res": res, "n": n, "category": category,
             "params": all_params},
            f,
        )
    return all_params


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Generate a procedural mug-family SDF dataset."
    )
    parser.add_argument("--out", required=True, help="output folder")
    parser.add_argument("--n", type=int, default=1000)
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--export_meshes", action="store_true",
        help="also write %%05d.obj isosurface meshes (held-out eval sets)",
    )
    parser.add_argument(
        "--category", choices=sorted(FAMILIES), default="mug",
        help="procedural shape family",
    )
    args = parser.parse_args()
    generate(args.out, args.n, args.res, args.seed,
             export_meshes=args.export_meshes, category=args.category)
    print(f"Wrote {args.n} {args.res}^3 SDF grids to {args.out}")


if __name__ == "__main__":
    main()
