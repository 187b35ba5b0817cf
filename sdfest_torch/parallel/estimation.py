"""Hypothesis-parallel estimation over a process group (counterpart of
``sdfest_tpu/parallel/estimation.py``).

Refinement instances (hypotheses) are independent, so each rank refines its
contiguous share of them with :meth:`SDFPipeline.refine_batch` (one launch of
each kernel per view and iteration for its whole share) and the results are
gathered back to all ``N`` hypotheses on every rank: the JAX package's
outputs are global arrays, so these match them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as tdist

from sdfest_torch.ops import quaternion
from sdfest_torch.parallel.mesh import Mesh, _tree_map, local_block, make_mesh


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x``'s blocks from every rank, concatenated in rank order along the
    leading axis, on ``x``'s device."""
    if not mesh.distributed:
        return x
    flag = x.dtype == torch.bool
    y = (x.to(torch.uint8) if flag else x).to(mesh.device).contiguous()
    parts = [torch.empty_like(y) for _ in range(mesh.world)]
    tdist.all_gather(parts, y, group=mesh.group)
    out = torch.cat(parts).to(x.device)
    return out.to(torch.bool) if flag else out


def sharded_refine_batch(
    pipeline,
    states: Dict[str, torch.Tensor],
    depth_images: torch.Tensor,
    points: torch.Tensor,
    point_masks: torch.Tensor,
    camera_positions: torch.Tensor,
    camera_orientations: torch.Tensor,
    mesh: Optional[Mesh] = None,
    shape_optimization: bool = True,
    roi=None,
    multires=None,
):
    """Run :meth:`SDFPipeline.refine_batch` with the hypotheses split over
    the ranks of ``mesh`` (default: :func:`make_mesh` on the pipeline's
    device).

    Each rank refines its contiguous block of the ``N`` hypotheses of
    ``states`` against the shared views, then the final states, the best
    states and the log are gathered so that every rank holds all ``N``, in
    hypothesis order.  ``N`` must be a multiple of the mesh's size.
    ``roi``/``multires`` as in :meth:`SDFPipeline.refine_batch`
    (``pipeline._roi_for(depth_images)`` / ``pipeline._multires_for()``
    apply the config policy).

    Returns ``(final_states, best, log)`` in ``refine_batch``'s shapes.
    """
    if mesh is None:
        mesh = make_mesh(device=pipeline.device)
    n = states["position"].shape[0]
    if n % mesh.world:
        raise ValueError(f"{n} hypotheses do not divide over {mesh.world} "
                         "ranks")
    mine = {k: local_block(torch.as_tensor(v), mesh)
            for k, v in states.items()}
    out = pipeline.refine_batch(
        mine, depth_images, points, point_masks, camera_positions,
        camera_orientations, shape_optimization=shape_optimization, roi=roi,
        multires=multires)
    return _tree_map(lambda x: _all_gather(x, mesh), out)


def hypothesis_states_from_draws(
    position: torch.Tensor,
    orientation: torch.Tensor,
    scale: torch.Tensor,
    latent: torch.Tensor,
    position_draws: torch.Tensor,
    quaternion_draws: torch.Tensor,
    position_noise: float = 0.02,
    orientation_noise: float = 0.1,
) -> Dict[str, torch.Tensor]:
    """:func:`make_hypothesis_states` given its draws: standard normals
    ``(N,) + position.shape`` and uniform unit quaternions ``(N, 4)``
    (``estimation.py:77-108``'s formula)."""
    n = quaternion_draws.shape[0]
    blend = torch.cat([
        torch.zeros(1, 1, dtype=orientation.dtype, device=orientation.device),
        torch.full((n - 1, 1), orientation_noise, dtype=orientation.dtype,
                   device=orientation.device)])
    quats = ((1.0 - blend) * orientation.reshape(-1, 4).repeat(n, 1)
             + blend * quaternion_draws.to(orientation))
    quats = quats / torch.linalg.norm(quats, dim=-1, keepdim=True)
    pos_noise = position_noise * position_draws.to(position)
    pos_noise[0] = 0.0
    return {
        "position": position[None] + pos_noise,
        "orientation": quats[:, None, :] if orientation.ndim == 2 else quats,
        "scale": scale[None].repeat((n,) + (1,) * scale.ndim),
        "latent": latent[None].repeat((n,) + (1,) * latent.ndim),
    }


def make_hypothesis_states(
    position: torch.Tensor,
    orientation: torch.Tensor,
    scale: torch.Tensor,
    latent: torch.Tensor,
    num_hypotheses: int,
    generator: Optional[torch.Generator] = None,
    position_noise: float = 0.02,
    orientation_noise: float = 0.1,
) -> Dict[str, torch.Tensor]:
    """Expand one initial estimate into ``num_hypotheses`` perturbed ones.

    The first hypothesis is the unperturbed estimate; the rest add Gaussian
    position noise and a blend toward a random rotation (weight
    ``orientation_noise``), drawn from ``generator`` (on the estimate's
    device) where the JAX package takes a key.
    """
    dev = position.device
    position_draws = torch.randn((num_hypotheses,) + tuple(position.shape),
                                 generator=generator, device=dev,
                                 dtype=position.dtype)
    quaternion_draws = quaternion.random_uniform((num_hypotheses,),
                                                 generator, dev)
    return hypothesis_states_from_draws(
        position, orientation, scale, latent, position_draws,
        quaternion_draws, position_noise, orientation_noise)
