"""Load the reference's PyTorch checkpoints into the port's modules
(counterpart of ``sdfest_tpu/utils/convert_torch.py``).

The released SDFEst weights (``{category}_vae.pt`` / ``{category}_init.pt``)
are PyTorch state dicts of the reference's ``SDFVAE`` and ``SDFPoseNet``.
The port's modules are PyTorch modules too, so every tensor keeps its
layout (``Linear`` ``(out, in)``, ``Conv3d`` ``(out, in, kD, kH, kW)``,
BatchNorm ``weight``/``bias``/``running_*``); only the keys change, by the
JAX package's key map:

- ``encoder._features.{i}`` -> ``encoder.features_{i}`` (its Conv3d and
  Linear layers), ``encoder.linear_means`` / ``linear_log_var`` unchanged;
- ``decoder._fc_layers.{i}`` -> ``decoder.fc_{i}``,
  ``decoder._conv_layers.{i}`` -> ``decoder.conv_{i}``;
- ``_backbone._linear_layers.{i}`` / ``._bn_layers.{i}`` ->
  ``backbone.linear_{i}`` / ``backbone.bn_{i}`` (an ``IterativePointNet``
  backbone: ``_backbone.pointnet_{1,2}.…`` -> ``backbone.pointnet_{1,2}.…``),
  the same under ``_head`` -> ``head``, and ``_head._final_layer`` ->
  ``head.final``.
"""
from __future__ import annotations

from typing import Dict

import torch

StateDict = Dict[str, torch.Tensor]


def load_state_dict(path: str) -> StateDict:
    """A reference checkpoint's state dict (bare, or under ``"model"``), on
    the CPU.  Only tensors and containers are unpickled
    (``weights_only``)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    if not isinstance(state, dict) or not all(
            torch.is_tensor(v) for v in state.values()):
        raise ValueError(f"Unrecognized checkpoint format in {path}")
    return dict(state)


def _layer(sd: StateDict, src: str, dst: str, out: StateDict,
           names=("weight", "bias")) -> None:
    for name in names:
        out[f"{dst}.{name}"] = sd[f"{src}.{name}"]


def convert_vae_state_dict(sd: StateDict, vae_config: dict) -> StateDict:
    """A reference ``SDFVAE`` state dict in the keys of the port's
    :class:`sdfest_torch.models.vae.SDFVAE`."""
    out: StateDict = {}
    for i, info in enumerate(vae_config["encoder"]["layer_infos"]):
        if info["type"].split(".")[-1].lower() in ("conv3d", "linear"):
            _layer(sd, f"encoder._features.{i}", f"encoder.features_{i}", out)
    for name in ("linear_means", "linear_log_var"):
        _layer(sd, f"encoder.{name}", f"encoder.{name}", out)
    _convert_decoder(sd, vae_config, "decoder.", out)
    return out


def _convert_decoder(sd: StateDict, vae_config: dict, dst: str,
                     out: StateDict) -> None:
    for i in range(len(vae_config["decoder"]["fc_layers"])):
        _layer(sd, f"decoder._fc_layers.{i}", f"{dst}fc_{i}", out)
    for i in range(len(vae_config["decoder"]["conv_layers"])):
        _layer(sd, f"decoder._conv_layers.{i}", f"{dst}conv_{i}", out)


def _convert_pointnet(sd: StateDict, src: str, dst: str,
                      out: StateDict) -> None:
    i = 0
    while f"{src}._linear_layers.{i}.weight" in sd:
        _layer(sd, f"{src}._linear_layers.{i}", f"{dst}.linear_{i}", out)
        if f"{src}._bn_layers.{i}.weight" in sd:
            _layer(sd, f"{src}._bn_layers.{i}", f"{dst}.bn_{i}", out,
                   ("weight", "bias", "running_mean", "running_var"))
        i += 1


def convert_init_state_dict(sd: StateDict, init_config: dict) -> StateDict:
    """A reference ``SDFPoseNet`` state dict in the keys of the port's
    :class:`sdfest_torch.models.pose_net.SDFPoseNet`."""
    out: StateDict = {}
    backbone_type = init_config.get("backbone_type", "VanillaPointNet")
    if backbone_type == "VanillaPointNet":
        _convert_pointnet(sd, "_backbone", "backbone", out)
    elif backbone_type == "IterativePointNet":
        for sub in ("pointnet_1", "pointnet_2"):
            _convert_pointnet(sd, f"_backbone.{sub}", f"backbone.{sub}", out)
    else:
        raise NotImplementedError(
            f"Conversion for {backbone_type} not implemented.")
    _convert_pointnet(sd, "_head", "head", out)
    _layer(sd, "_head._final_layer", "head.final", out)
    return out


def decoder_state_dict(path: str, vae_config: dict) -> StateDict:
    """The decoder's part of a reference ``*_vae.pt`` checkpoint, in the
    keys of :class:`sdfest_torch.models.vae.SDFDecoder`."""
    out: StateDict = {}
    _convert_decoder(load_state_dict(path), vae_config, "", out)
    return out


def init_state_dict(path: str, init_config: dict) -> StateDict:
    """A reference ``*_init.pt`` checkpoint in the port's keys."""
    return convert_init_state_dict(load_state_dict(path), init_config)

