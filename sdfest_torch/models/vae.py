"""SDF VAE decoder (counterpart of ``SDFDecoder`` in
``sdfest_tpu/models/vae.py``).

FC stack -> reshape to ``(N, C, D, D, D)`` -> before each Conv3d a trilinear
resize to the layer's ``in_size`` when needed -> VALID (unpadded) Conv3d ->
ReLU where configured.  The convolutions run in full fp32 on any device
(:func:`fp32_convolutions`).  Submodule names follow flax (``fc_i``, ``conv_i``)
so :func:`sdfest_torch.utils.weights.flax_to_torch` maps the committed
weights directly.  The encoder is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Union

import torch
from torch import nn

from sdfest_torch.ops.interpolation import resize_trilinear


def fp32_convolutions():
    """A context in which cuDNN convolutions run in full fp32.

    By PyTorch's default a float32 cuDNN convolution may run in TF32, which
    keeps about three significant digits (on an H100 with PyTorch 2.11 the
    mug decoder then differs from the CPU's by 2.6e-4).  This sets cuDNN's
    legacy ``allow_tf32`` switch off for the block, which PyTorch 2.11
    honours for convolutions; the ``fp32_precision`` argument of
    ``cudnn.flags`` sets the generic CUDA precision, which the convolutions
    do not read.  Every other cuDNN flag
    keeps its value, and all are restored on exit: no global flag changes
    for the rest of the process.
    """
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       benchmark_limit=cudnn.benchmark_limit,
                       deterministic=cudnn.deterministic, allow_tf32=False)


class SDFDecoder(nn.Module):
    """Latent ``(N, L)`` -> SDF grid ``(N, 1, D, D, D)``."""

    def __init__(
        self,
        volume_size: int,
        latent_size: int,
        fc_layers: Sequence[Dict[str, Any]],
        conv_layers: Sequence[Dict[str, Any]],
        tsdf: Union[bool, float] = False,
    ):
        super().__init__()
        if fc_layers[-1]["out"] != (
            conv_layers[0]["in_channels"] * conv_layers[0]["in_size"] ** 3
        ):
            raise ValueError("last fc layer must fill the first conv input")
        for i, conv in enumerate(conv_layers[:-1]):
            if conv["out_channels"] != conv_layers[i + 1]["in_channels"]:
                raise ValueError(f"conv_{i} channels do not chain")
        if conv_layers[-1]["out_channels"] != 1:
            raise ValueError("the last conv layer must output one channel")
        self.volume_size = volume_size
        self.conv_layers = [dict(c) for c in conv_layers]
        self.tsdf = tsdf
        in_features = latent_size
        for i, fc in enumerate(fc_layers):
            self.add_module(f"fc_{i}", nn.Linear(in_features, fc["out"]))
            in_features = fc["out"]
        self.num_fc = len(fc_layers)
        for i, conv in enumerate(conv_layers):
            self.add_module(f"conv_{i}", nn.Conv3d(
                conv["in_channels"], conv["out_channels"],
                conv["kernel_size"], padding=0,
            ))

    def forward(self, z: torch.Tensor, enforce_tsdf: bool = False
                ) -> torch.Tensor:
        out = z
        for i in range(self.num_fc):
            out = torch.relu(getattr(self, f"fc_{i}")(out))
        c0 = self.conv_layers[0]
        out = out.reshape(-1, c0["in_channels"], c0["in_size"], c0["in_size"],
                          c0["in_size"])
        with fp32_convolutions():
            for i, info in enumerate(self.conv_layers):
                if out.shape[2] != info["in_size"]:
                    out = resize_trilinear(out, info["in_size"])
                out = getattr(self, f"conv_{i}")(out)
                if info["relu"]:
                    out = torch.relu(out)
        if out.shape[2] != self.volume_size:
            out = resize_trilinear(out, self.volume_size)
        if self.tsdf is not False and enforce_tsdf:
            out = torch.clamp(out, -self.tsdf, self.tsdf)
        return out


def create_decoder_from_config(config: Dict[str, Any]) -> SDFDecoder:
    """Build the decoder of a reference-format VAE config dict."""
    tsdf = config.get("tsdf", False)
    if isinstance(tsdf, str):
        raise NotImplementedError("string tsdf values are not ported yet")
    return SDFDecoder(
        volume_size=config.get("sdf_size", 64),
        latent_size=config["latent_size"],
        fc_layers=config["decoder"]["fc_layers"],
        conv_layers=config["decoder"]["conv_layers"],
        tsdf=tsdf,
    )
