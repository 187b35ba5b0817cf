"""SDF VAE (counterpart of ``sdfest_tpu/models/vae.py``).

Decoder: FC stack -> reshape to ``(N, C, D, D, D)`` -> before each Conv3d a
trilinear resize to the layer's ``in_size`` when needed -> VALID (unpadded)
Conv3d -> ReLU where configured.  Encoder: the config's ``layer_infos``
(Conv3d, ReLU, Flatten, MaxPool3d, Linear) on ``(N, 1, D, D, D)``, then the
``linear_means`` / ``linear_log_var`` heads.  The convolutions run in full
fp32 on any device (:func:`fp32_convolutions`; a training step and an
estimate's shape optimization run their backward under it too).
Submodule names follow flax (``encoder.features_i``, ``decoder.fc_i``,
``decoder.conv_i``), so :func:`sdfest_torch.utils.weights.flax_to_torch`
maps the committed weights directly.  Randomness is an explicit ``eps``
or ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sdfest_torch.ops.interpolation import resize_trilinear
from sdfest_torch.utils.misc import str_to_tsdf


def fp32_convolutions(deterministic: Optional[bool] = None):
    """A context in which cuDNN convolutions run in full fp32 (and, with
    ``deterministic``, only cuDNN's deterministic algorithms).  cuDNN reads
    the flags when a convolution runs, its backward included, so every
    gradient the port takes through the decoder is taken inside
    ``fp32_convolutions(deterministic=True)``: the trainers' steps and the
    estimate's iterations with shape optimization.  Two runs of either then
    agree bit for bit.

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
    if deterministic is None:
        deterministic = cudnn.deterministic
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       benchmark_limit=cudnn.benchmark_limit,
                       deterministic=deterministic, allow_tf32=False)


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
        self.latent_size = latent_size
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


def _to_tuple3(v) -> Tuple[int, int, int]:
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v, v)


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``"SAME"`` padding of one axis: output ``ceil(size /
    stride)``, the odd pad element at the end."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SDFEncoder(nn.Module):
    """SDF ``(N, 1, D, D, D)`` -> ``(means, log_var)``, each ``(N, L)``.

    Layers ``{"type": ..., "args": ...}`` as in ``sdfest_tpu``: Conv3d
    (``padding`` an int, a triple or flax's ``"SAME"`` / ``"VALID"``), ReLU,
    Flatten, MaxPool3d (VALID windows), Linear.  The layout is NCDHW
    throughout, so Flatten is PyTorch's own: flax moves the channels first
    before it flattens, and the dense weights need no permutation.
    """

    def __init__(self, volume_size: int, latent_size: int,
                 layer_infos: Sequence[Dict[str, Any]]):
        super().__init__()
        self.layers = []  # (kind, module name or args)
        channels, size = 1, volume_size
        features = None
        for i, info in enumerate(layer_infos):
            kind = info["type"].split(".")[-1].lower()
            args = info.get("args", {})
            if kind == "conv3d":
                k = _to_tuple3(args.get("kernel_size", 3))
                s = _to_tuple3(args.get("stride", 1))
                pad = args.get("padding", 0)
                if isinstance(pad, str):
                    if pad.upper() == "SAME":
                        pads = [_same_padding(size, k[a], s[a])
                                for a in range(3)]
                    elif pad.upper() == "VALID":
                        pads = [(0, 0)] * 3
                    else:
                        raise ValueError(f"unsupported padding {pad}")
                else:
                    pads = [(p, p) for p in _to_tuple3(pad)]
                self.add_module(f"features_{i}", nn.Conv3d(
                    channels, args["out_channels"], k, stride=s))
                # F.pad takes the last axis first
                self.layers.append(("conv", f"features_{i}", tuple(
                    p for lo_hi in reversed(pads) for p in lo_hi)))
                channels = args["out_channels"]
                size = (size + sum(pads[0]) - k[0]) // s[0] + 1
            elif kind == "relu":
                self.layers.append(("relu",))
            elif kind == "flatten":
                self.layers.append(("flatten",))
                features = channels * size ** 3
            elif kind == "maxpool3d":
                k = _to_tuple3(args.get("kernel_size", 2))
                s = _to_tuple3(args.get("stride", args.get("kernel_size", 2)))
                self.layers.append(("maxpool", k, s))
                size = (size - k[0]) // s[0] + 1
            elif kind == "linear":
                self.add_module(f"features_{i}", nn.Linear(
                    features, args["out_features"]))
                self.layers.append(("linear", f"features_{i}"))
                features = args["out_features"]
            else:
                raise ValueError(
                    f"Unsupported encoder layer type {info['type']}")
        if features is None:
            raise ValueError("the encoder's layers must flatten")
        self.linear_means = nn.Linear(features, latent_size)
        self.linear_log_var = nn.Linear(features, latent_size)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = x
        with fp32_convolutions():
            for layer in self.layers:
                kind = layer[0]
                if kind == "conv":
                    if any(layer[2]):
                        out = F.pad(out, layer[2])
                    out = getattr(self, layer[1])(out)
                elif kind == "relu":
                    out = torch.relu(out)
                elif kind == "flatten":
                    out = out.reshape(out.shape[0], -1)
                elif kind == "maxpool":
                    out = F.max_pool3d(out, layer[1], layer[2])
                else:
                    out = getattr(self, layer[1])(out)
        return self.linear_means(out), self.linear_log_var(out)


class SDFVAE(nn.Module):
    """VAE over ``(N, 1, D, D, D)`` SDF grids: ``forward`` returns
    ``(recon, means, log_var, z)`` as the JAX package's ``__call__``."""

    def __init__(self, sdf_size: int, latent_size: int,
                 encoder: Dict[str, Any], decoder: Dict[str, Any],
                 tsdf: Union[bool, float] = False):
        super().__init__()
        self.sdf_size = sdf_size
        self.latent_size = latent_size
        self.tsdf = tsdf
        self.encoder = SDFEncoder(sdf_size, latent_size,
                                  encoder["layer_infos"])
        self.decoder = SDFDecoder(sdf_size, latent_size,
                                  decoder["fc_layers"],
                                  decoder["conv_layers"], tsdf)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                enforce_tsdf: bool = False):
        z, means, log_var = self.encode(x, eps, generator)
        return self.decoder(z, enforce_tsdf), means, log_var, z

    def encode(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Reparameterized ``(z, means, log_var)``; ``eps`` (``(N, L)``)
        or standard normals from ``generator``."""
        means, log_var = self.encoder(x)
        std = torch.exp(0.5 * log_var)
        if eps is None:
            eps = torch.randn(means.shape, generator=generator,
                              device=means.device)
        return eps * std + means, means, log_var

    def encode_mean(self, x: torch.Tensor):
        """Deterministic encoding ``(means, log_var)``."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor, enforce_tsdf: bool = False
               ) -> torch.Tensor:
        """Latents ``(N, L)`` -> SDFs ``(N, 1, D, D, D)``."""
        return self.decoder(z, enforce_tsdf)

    def sample(self, n: int = 1, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        device = next(self.parameters()).device
        return torch.randn(n, self.latent_size, generator=generator,
                           device=device)

    def inference(self, n: int = 1,
                  generator: Optional[torch.Generator] = None,
                  enforce_tsdf: bool = False):
        """``(decoded prior samples, their latents)``."""
        z = self.sample(n, generator)
        return self.decoder(z, enforce_tsdf), z

    def prepare_input(self, sdfs: torch.Tensor) -> torch.Tensor:
        """Truncate SDF inputs to the configured TSDF band."""
        if self.tsdf is False:
            return sdfs
        return torch.clamp(sdfs, -self.tsdf, self.tsdf)


def create_vae_from_config(config: Dict[str, Any]) -> SDFVAE:
    """Build an :class:`SDFVAE` from a reference-format VAE config dict."""
    return SDFVAE(
        sdf_size=config.get("sdf_size", 64),
        latent_size=config["latent_size"],
        encoder=config["encoder"],
        decoder=config["decoder"],
        tsdf=str_to_tsdf(config.get("tsdf", False)),
    )


def create_decoder_from_config(config: Dict[str, Any]) -> SDFDecoder:
    """Build the decoder of a reference-format VAE config dict."""
    return SDFDecoder(
        volume_size=config.get("sdf_size", 64),
        latent_size=config["latent_size"],
        fc_layers=config["decoder"]["fc_layers"],
        conv_layers=config["decoder"]["conv_layers"],
        tsdf=str_to_tsdf(config.get("tsdf", False)),
    )
