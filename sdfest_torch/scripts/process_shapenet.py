"""Preprocess ShapeNet meshes into paired obj + SDF-grid training files
(counterpart of ``sdfest_tpu/scripts/process_shapenet.py``).

Walks a ShapeNet category directory for ``.obj`` meshes, converts each to a
voxelized SDF with the port's ``mesh_to_sdf`` (the host C++ voxelizer of
:mod:`sdfest_torch.native`, numpy where it is absent), and writes paired
``%05d.obj`` / ``%05d.npy`` outputs.  Selection decisions are honored via
``good_meshes.json`` / ``final_meshes.json`` files (the reference ships its
paper's final selection as ``final_meshes.json``); multiprocess conversion
via joblib when it is installed.  ``--review_sheet`` writes an indexed
contact sheet and a selection template instead (headless curation; needs
matplotlib).

Usage:
  python -m sdfest_torch.scripts.process_shapenet \\
      --inp_folder <shapenet_cat> --out_folder <out> [--resolution 64] \\
      [--padding 2] [--filter_json final_meshes.json]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np

from sdfest_torch.ops.sdf_utils import mesh_to_sdf
from sdfest_torch.pipeline.synthetic import Mesh, save_obj


def find_meshes(inp_folder: str) -> List[str]:
    """All .obj files below the input folder (recursive, sorted)."""
    return sorted(
        glob.glob(os.path.join(inp_folder, "**", "*.obj"), recursive=True)
    )


def load_filter(filter_json: Optional[str]) -> Optional[set]:
    """Load a mesh-selection json.

    Three formats are accepted:

    - ``{path_fragment: bool}`` — the ``good_meshes.json`` template written
      by ``--review_sheet`` (keep entries that are true);
    - ``{category_dir: [mesh_path, ...]}`` — the reference's curated
      ``final_meshes.json`` (shipped at the repo root).  The kept
      fragments are normalized to ``<synset>/<model>/...`` suffixes so
      they match regardless of where the user's ShapeNet root lives;
    - a plain list of path fragments.
    """
    if filter_json is None or not os.path.exists(filter_json):
        return None
    with open(filter_json) as f:
        data = json.load(f)
    if isinstance(data, dict):
        fragments = set()
        for key, value in data.items():
            if isinstance(value, (list, tuple)):
                synset = os.path.basename(os.path.normpath(key))
                for path in value:
                    rel = os.path.relpath(path, key)
                    fragments.add(os.path.join(synset, rel))
            elif value:
                fragments.add(key)
        return fragments
    return set(data)


def _convert_one(index: int, mesh_path: str, out_folder: str,
                 resolution: int, padding: int) -> bool:
    mesh = Mesh(path=mesh_path, scale=1.0, rel_scale=True)
    if len(mesh.vertices) == 0 or len(mesh.faces) == 0:
        print(f"Empty mesh {mesh_path}. Skipping.")
        return False
    sdf = mesh_to_sdf(mesh, resolution, padding)
    if sdf is None:
        return False
    save_obj(
        os.path.join(out_folder, f"{index:05}.obj"), mesh.vertices, mesh.faces
    )
    np.save(os.path.join(out_folder, f"{index:05}.npy"), sdf)
    return True


def process(
    inp_folder: str,
    out_folder: str,
    resolution: int = 64,
    padding: int = 2,
    filter_json: Optional[str] = None,
    jobs: int = -1,
) -> int:
    """Convert all (selected) meshes; returns the number converted."""
    os.makedirs(out_folder, exist_ok=True)
    mesh_paths = find_meshes(inp_folder)
    selection = load_filter(filter_json)
    if selection is not None:
        mesh_paths = [
            p for p in mesh_paths if any(frag in p for frag in selection)
        ]
    print(f"Converting {len(mesh_paths)} meshes -> {out_folder}")
    try:
        from joblib import Parallel, delayed
    except ImportError:  # an optional dependency: convert in this process
        Parallel = None
    if Parallel is not None and jobs != 1:
        results = Parallel(n_jobs=jobs)(
            delayed(_convert_one)(i, p, out_folder, resolution, padding)
            for i, p in enumerate(mesh_paths)
        )
    else:
        results = [
            _convert_one(i, p, out_folder, resolution, padding)
            for i, p in enumerate(mesh_paths)
        ]
    converted = sum(bool(r) for r in results)
    print(f"Converted {converted}/{len(mesh_paths)} meshes.")
    return converted


def review_sheet(
    inp_folder: str, sheet_path: str, selection_json: str, cols: int = 8
) -> int:
    """Headless replacement for the reference's interactive keep/remove GUI:
    render every candidate mesh into an
    indexed contact sheet and write a ``good_meshes.json`` template (all
    true).  Curate by eyeballing the sheet and flipping entries to false,
    then run the conversion with ``--filter_json``.
    """
    from sdfest_torch.ops.sdf_vis import agg_pyplot, plot_mesh

    plt = agg_pyplot()

    mesh_paths = find_meshes(inp_folder)
    if not mesh_paths:
        print(f"No meshes under {inp_folder}")
        return 0
    rows = (len(mesh_paths) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.4 * rows))
    axes = np.atleast_1d(axes).reshape(rows, cols)
    selection = {}
    for i, path in enumerate(mesh_paths):
        frag = os.path.relpath(path, inp_folder)
        selection[frag] = True
        ax = axes[i // cols, i % cols]
        try:
            mesh = Mesh(path=path, scale=1.0, rel_scale=True, center=True)
            mesh.scale = 0.1
            plot_mesh(mesh, camera_distance=0.3, plot_object=ax)
        except Exception as e:  # never lose the whole sheet to one mesh
            ax.text(0.5, 0.5, f"load failed\n{e}", ha="center", fontsize=5)
        ax.set_title(f"{i}: {frag[:28]}", fontsize=5)
        ax.axis("off")
    for j in range(len(mesh_paths), rows * cols):
        axes[j // cols, j % cols].axis("off")
    fig.tight_layout()
    fig.savefig(sheet_path, dpi=110)
    plt.close(fig)
    with open(selection_json, "w") as f:
        json.dump(selection, f, indent=1)
    print(f"Review sheet: {sheet_path}; selection template: {selection_json}")
    return len(mesh_paths)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Preprocess ShapeNet meshes.")
    parser.add_argument("--inp_folder", required=True)
    parser.add_argument("--out_folder", required=False, default=None)
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--padding", type=int, default=2)
    parser.add_argument("--filter_json", default=None)
    parser.add_argument("--jobs", type=int, default=-1)
    parser.add_argument(
        "--review_sheet", metavar="PNG", default=None,
        help="write an indexed contact sheet of all meshes + a "
        "good_meshes.json template instead of converting (headless "
        "keep/remove curation)",
    )
    args = parser.parse_args(argv)
    if args.review_sheet:
        review_sheet(
            args.inp_folder,
            args.review_sheet,
            os.path.join(
                os.path.dirname(args.review_sheet) or ".", "good_meshes.json"
            ),
        )
        return
    if args.out_folder is None:
        parser.error("--out_folder is required for conversion")
    process(
        args.inp_folder,
        args.out_folder,
        args.resolution,
        args.padding,
        args.filter_json,
        args.jobs,
    )


if __name__ == "__main__":
    main()
