"""The reference's networks and their weights: the shape VAE (FC stack and
3-D convolutions with trilinear resizes; a strided convolutional encoder),
the init network (a dense, residual PointNet with batch norm and a pose
head over a discretized SO(3) grid), the grid's cell quaternions and a
reader of flax's msgpack weight files.

Plain PyTorch, written from the configurations' layer lists.  The
convolutions and products run in full fp32 unless ``tf32`` asks for the
tensor cores' TF32 (the control's precision).
"""
from __future__ import annotations

import contextlib
import struct
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bench_port.reference import ops


class _RoundTF32(torch.autograd.Function):
    """Round float32 to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as the tensor cores' conversion), in the forward and for the
    incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Linear(nn.Linear):
    """A dense layer whose operands round to TF32 when ``tf32`` is set (the
    control), whatever kernel the library picks."""

    tf32 = False

    def forward(self, x):
        if not self.tf32:
            return super().forward(x)
        return F.linear(_RoundTF32.apply(x), _RoundTF32.apply(self.weight),
                        self.bias)


class Conv3d(nn.Conv3d):
    """A 3-D convolution whose operands round to TF32 when ``tf32`` is
    set."""

    tf32 = False

    def forward(self, x):
        if not self.tf32:
            return super().forward(x)
        return self._conv_forward(_RoundTF32.apply(x),
                                  _RoundTF32.apply(self.weight), self.bias)


def set_tf32(module: nn.Module, on: bool) -> nn.Module:
    """Round the operands of every dense layer and convolution of
    ``module`` to TF32 (or not)."""
    for m in module.modules():
        if isinstance(m, (Linear, Conv3d)):
            m.tf32 = on
    return module


@contextlib.contextmanager
def precision(tf32: bool):
    """cuDNN convolutions and cuBLAS products in fp32 (TF32 off) or in
    TF32, with cuDNN's deterministic algorithms; the flags are restored on
    exit."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=tf32):
            yield
    finally:
        matmul.allow_tf32 = old


class Decoder(nn.Module):
    """Latent ``(N, L)`` -> SDF ``(N, 1, D, D, D)``."""

    def __init__(self, latent_size: int, fc_layers, conv_layers,
                 volume_size: int = 64):
        super().__init__()
        self.volume_size = volume_size
        self.conv_layers = [dict(c) for c in conv_layers]
        n_in = latent_size
        for i, fc in enumerate(fc_layers):
            self.add_module(f"fc_{i}", Linear(n_in, fc["out"]))
            n_in = fc["out"]
        self.num_fc = len(fc_layers)
        for i, c in enumerate(conv_layers):
            self.add_module(f"conv_{i}", Conv3d(
                c["in_channels"], c["out_channels"], c["kernel_size"]))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        out = z
        for i in range(self.num_fc):
            out = torch.relu(getattr(self, f"fc_{i}")(out))
        c0 = self.conv_layers[0]
        out = out.reshape(-1, c0["in_channels"], *(c0["in_size"],) * 3)
        for i, info in enumerate(self.conv_layers):
            if out.shape[2] != info["in_size"]:
                out = ops.Resize.apply(out, info["in_size"])
            out = getattr(self, f"conv_{i}")(out)
            if info["relu"]:
                out = torch.relu(out)
        if out.shape[2] != self.volume_size:
            out = ops.Resize.apply(out, self.volume_size)
        return out


class Encoder(nn.Module):
    """SDF ``(N, 1, D, D, D)`` -> ``(means, log_var)`` through unpadded
    strided convolutions, ReLUs and a flatten."""

    def __init__(self, latent_size: int, layer_infos, volume_size: int = 64):
        super().__init__()
        self.layers = []
        channels, size = 1, volume_size
        for i, info in enumerate(layer_infos):
            kind = info["type"].split(".")[-1].lower()
            args = info.get("args", {})
            if kind == "conv3d":
                k, s = args.get("kernel_size", 3), args.get("stride", 1)
                if args.get("padding", 0) not in (0, "VALID"):
                    raise ValueError("the reference encoder has no padding")
                self.add_module(f"features_{i}", Conv3d(
                    channels, args["out_channels"], k, stride=s))
                self.layers.append(("conv", f"features_{i}"))
                channels = args["out_channels"]
                size = (size - k) // s + 1
            elif kind == "relu":
                self.layers.append(("relu",))
            elif kind == "flatten":
                self.layers.append(("flatten",))
            else:
                raise ValueError(f"layer {info['type']} is not in the "
                                 "reference encoder")
        features = channels * size ** 3
        self.linear_means = Linear(features, latent_size)
        self.linear_log_var = Linear(features, latent_size)

    def forward(self, x):
        out = x
        for layer in self.layers:
            if layer[0] == "conv":
                out = getattr(self, layer[1])(out)
            elif layer[0] == "relu":
                out = torch.relu(out)
            else:
                out = out.reshape(out.shape[0], -1)
        return self.linear_means(out), self.linear_log_var(out)


class VAE(nn.Module):
    def __init__(self, config: Dict[str, Any]):
        super().__init__()
        latent = config["latent_size"]
        self.latent_size = latent
        self.encoder = Encoder(latent, config["encoder"]["layer_infos"])
        self.decoder = Decoder(latent, config["decoder"]["fc_layers"],
                               config["decoder"]["conv_layers"])

    def forward(self, x, eps):
        means, log_var = self.encoder(x)
        z = eps * torch.exp(0.5 * log_var) + means
        return self.decoder(z), means, log_var


class _Norm(nn.Module):
    """Batch norm with its running statistics (inference)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-5)


class PointNet(nn.Module):
    """Per-point MLP with batch norm, dense max-pool concatenation and
    residual adds; ``(N, M, 3)`` -> ``(N, F)``."""

    def __init__(self, in_size: int, mlp_out_sizes: Sequence[int],
                 batchnorm: bool = True, residual: bool = True,
                 dense: bool = True):
        super().__init__()
        if not (batchnorm and residual and dense):
            raise ValueError("the reference PointNet is the dense, residual "
                             "one with batch norm")
        self.num_layers = len(mlp_out_sizes)
        n_in = in_size
        for i, n_out in enumerate(mlp_out_sizes):
            self.add_module(f"linear_{i}", Linear(n_in, n_out))
            self.add_module(f"bn_{i}", _Norm(n_out))
            n_in = 2 * n_out

    def forward(self, x):
        n, m, _ = x.shape
        out = prev = x.reshape(n * m, -1)
        for i in range(self.num_layers):
            out = torch.relu(getattr(self, f"bn_{i}")(
                getattr(self, f"linear_{i}")(out)))
            out_max = torch.amax(out.reshape(n, m, -1), dim=1)
            if i != self.num_layers - 1:
                out = torch.cat([out, out_max[:, None, :].expand(
                    n, m, -1).reshape(n * m, -1)], dim=-1)
            if prev.shape == out.shape:
                out = prev + out
            prev = out
        return torch.amax(out.reshape(n, m, -1), dim=1)


class PoseHead(nn.Module):
    """Feature -> ``(latent, position, scale, orientation logits)``."""

    def __init__(self, in_size: int, mlp_out_sizes: Sequence[int],
                 shape_dimension: int, n_cells: int):
        super().__init__()
        self.d = shape_dimension
        self.num_layers = len(mlp_out_sizes)
        n_in = in_size
        for i, n_out in enumerate(mlp_out_sizes):
            self.add_module(f"linear_{i}", Linear(n_in, n_out))
            self.add_module(f"bn_{i}", _Norm(n_out))
            n_in = n_out
        self.final = Linear(n_in, shape_dimension + 4 + n_cells)

    def forward(self, x):
        out = x
        for i in range(self.num_layers):
            out = torch.relu(getattr(self, f"bn_{i}")(
                getattr(self, f"linear_{i}")(out)))
        out = self.final(out)
        d = self.d
        return out[:, :d], out[:, d:d + 3], out[:, d + 3], out[:, d + 4:]


class InitNet(nn.Module):
    def __init__(self, init_config: Dict[str, Any], latent_size: int):
        super().__init__()
        if init_config["backbone_type"] != "VanillaPointNet" or \
                init_config["head"]["orientation_repr"] != "discretized":
            raise ValueError("the reference init network is the vanilla "
                             "PointNet with a discretized head")
        self.backbone = PointNet(**init_config["backbone"])
        head = init_config["head"]
        self.head = PoseHead(head["in_size"], head["mlp_out_sizes"],
                             latent_size,
                             so3_cells(head["orientation_grid_resolution"]))

    def forward(self, x):
        return self.head(self.backbone(x))


# ---------------------------------------------------------------------------
# the SO(3) grid (Hopf fibration: S^1 x nested HEALPix S^2)
# ---------------------------------------------------------------------------

_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _compress_bits(v):
    v = v.astype(np.uint32) & np.uint32(0x55555555)
    v = (v | (v >> 1)) & np.uint32(0x33333333)
    v = (v | (v >> 2)) & np.uint32(0x0F0F0F0F)
    v = (v | (v >> 4)) & np.uint32(0x00FF00FF)
    v = (v | (v >> 8)) & np.uint32(0x0000FFFF)
    return v


def _pix2ang_nest(nside: int, ipix):
    ipix = np.asarray(ipix, dtype=np.int64)
    npface = nside * nside
    face = ipix // npface
    ipf = ipix % npface
    ix = _compress_bits(ipf.astype(np.uint32)).astype(np.int64)
    iy = _compress_bits((ipf >> 1).astype(np.uint32)).astype(np.int64)
    jr = _JRLL[face] * nside - ix - iy - 1
    north, south = jr < nside, jr > 3 * nside
    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    z = np.where(north, 1.0 - nr * nr / (3.0 * npface),
                 np.where(south, -1.0 + nr * nr / (3.0 * npface),
                          (2 * nside - jr) * 2.0 / (3.0 * nside)))
    kshift = np.where(north | south, 0, (jr - nside) & 1)
    jp = (_JPLL[face] * nr + ix - iy + 1 + kshift) // 2
    jp = np.where(jp > 4 * nside, jp - 4 * nside, jp)
    jp = np.where(jp < 1, jp + 4 * nside, jp)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = (jp - (kshift + 1) * 0.5) * (np.pi / (2.0 * nr))
    return theta, phi


def so3_cells(resol: int) -> int:
    return 6 * 2 ** resol * 12 * 4 ** resol


def so3_quaternions(resol: int) -> np.ndarray:
    """Cell-centre quaternions ``(cells, 4)`` (x >= 0), cell index
    ``s1 * n_s2 + s2``."""
    n1 = 6 * 2 ** resol
    s1 = np.linspace(0, 2 * np.pi, n1, endpoint=False) + np.pi / n1
    nside = 2 ** resol
    theta2, phi2 = _pix2ang_nest(nside, np.arange(12 * nside * nside))
    n2 = len(theta2)
    psi = np.repeat(s1, n2)
    theta = np.tile(theta2, n1)
    phi = np.tile(phi2, n1)
    ht = theta / 2.0
    q = np.stack([np.cos(ht) * np.sin(psi / 2),
                  np.sin(ht) * np.cos(phi + psi / 2),
                  np.sin(ht) * np.sin(phi + psi / 2),
                  np.cos(ht) * np.cos(psi / 2)], axis=-1)
    q[q[:, 0] < 0] *= -1
    return q


# ---------------------------------------------------------------------------
# flax msgpack weights
# ---------------------------------------------------------------------------


class _Msgpack:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n):
        out = self.data[self.pos:self.pos + n].tobytes()
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {self.read(): self.read() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self.unpack(nums[b])
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.take(self.unpack(strs[b])).decode()
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(
                self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            n = self.unpack(">H" if b == 0xDE else ">I")
            return {self.read(): self.read() for _ in range(n)}
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")


def _ext(code: int, data: bytes):
    if code not in (1, 3):
        raise ValueError(f"unsupported msgpack extension {code}")
    shape, dtype, raw = _Msgpack(data).read()
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(tuple(shape))
    return arr.copy() if code == 1 else arr[()]


def load_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return _Msgpack(f.read()).read()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def flax_state(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch state dict of a flax tree: dense kernels transposed, conv
    kernels ``(kD, kH, kW, in, out)`` -> ``(out, in, kD, kH, kW)``, batch
    norm's scale and statistics renamed."""
    colls = [tree[k] for k in ("params", "batch_stats") if k in tree] \
        if "params" in tree else [tree]
    state = {}
    for coll in colls:
        for path, arr in _leaves(coll):
            name, arr = path[-1], np.asarray(arr)
            if name == "kernel":
                arr = arr.T if arr.ndim == 2 else np.transpose(
                    arr, (4, 3, 0, 1, 2))
                name = "weight"
            else:
                name = {"bias": "bias", "scale": "weight",
                        "mean": "running_mean", "var": "running_var"}[name]
            state[".".join(path[:-1] + (name,))] = torch.from_numpy(
                np.array(arr, order="C"))
    return state


def load_into(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    result = module.load_state_dict(state, strict=False)
    if result.missing_keys or result.unexpected_keys:
        raise ValueError(f"weight mismatch: missing {result.missing_keys}, "
                         f"unexpected {result.unexpected_keys}")
