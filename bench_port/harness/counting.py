"""The yardstick's arithmetic: the bytes each hand-written kernel's launch
must move, from its launch's shapes alone, and the model FLOPs of the
decoder, the encoder and the init network's PointNet, from the
configuration's widths.  They count the work, not any implementation of
it, so a kernel that is replaced, fused or split is measured against the
same numbers.

Bytes: what the kernel's interface must read and write whatever its
inputs hold; the grid cells a launch touches depend on the data (the rays'
paths, the masked rows) and are left out, so each count is a lower bound.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

# NVIDIA H100 SXM (data sheet): HBM3 bytes/s and dense fp32 FLOP/s outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

FLOAT = 4


def kernel_bytes(kernel: str, rows: int, batch: int, res: int = 64) -> int:
    """Bytes one launch must move.

    - ``march``: ``rows`` ray directions in (12 bytes each, shared by the
      hypotheses), a depth out per ray and hypothesis, and each
      hypothesis's pose (14 floats);
    - ``sample``: per row and hypothesis the point (12 bytes) and the mask
      in, the value out;
    - ``sample_grad``: the point and the mask in, the value and the
      3-vector gradient out;
    - ``scatter``: the point and the cotangent in per row, and each
      hypothesis's whole ``res^3`` grid out.
    """
    if kernel == "march":
        return rows * 3 * FLOAT + batch * rows * FLOAT + batch * 14 * FLOAT
    if kernel == "sample":
        return batch * rows * (3 + 2) * FLOAT
    if kernel == "sample_grad":
        return batch * rows * (3 + 5) * FLOAT
    if kernel == "scatter":
        return batch * rows * (3 + 1) * FLOAT + batch * res ** 3 * FLOAT
    raise KeyError(kernel)


def bound_seconds(launches: Dict[str, List[Tuple[int, int, int]]],
                  res: int = 64) -> float:
    """The least time of ``launches`` (kernel -> ``[(rows, batch,
    count), ...]``) at the HBM's bandwidth."""
    total = sum(count * kernel_bytes(k, rows, batch, res)
                for k, shapes in launches.items()
                for rows, batch, count in shapes)
    return total / HBM_BYTES_PER_S


# ---------------------------------------------------------------------------
# model FLOPs (2 per multiply-add)
# ---------------------------------------------------------------------------


def decoder_macs(vae: Dict) -> List[int]:
    """Multiply-adds per layer of one decode: the FC stack, then each
    unpadded convolution at its ``in_size``."""
    out, n_in = [], vae["latent_size"]
    for fc in vae["decoder"]["fc_layers"]:
        out.append(n_in * fc["out"])
        n_in = fc["out"]
    for c in vae["decoder"]["conv_layers"]:
        k = c["kernel_size"]
        size = c["in_size"] - k + 1
        out.append(size ** 3 * c["out_channels"] * c["in_channels"] * k ** 3)
    return out


def encoder_macs(vae: Dict, volume: int = 64) -> List[int]:
    """Multiply-adds per layer of one encode: the strided unpadded
    convolutions, then the two linear heads."""
    out, channels, size = [], 1, volume
    for info in vae["encoder"]["layer_infos"]:
        if info["type"].split(".")[-1].lower() != "conv3d":
            continue
        a = info["args"]
        k, s = a.get("kernel_size", 3), a.get("stride", 1)
        size = (size - k) // s + 1
        out.append(size ** 3 * a["out_channels"] * channels * k ** 3)
        channels = a["out_channels"]
    out.append(2 * channels * size ** 3 * vae["latent_size"])
    return out


def pointnet_macs(init: Dict, latent_size: int, n_points: int) -> int:
    """Multiply-adds of the init network on one set of ``n_points``: the
    per-point MLP (each layer after the first reads its input beside the
    set's max-pooled feature, twice its width) and the pose head."""
    bb = init["backbone"]
    per_point, n_in = 0, bb["in_size"]
    for n_out in bb["mlp_out_sizes"]:
        per_point += n_in * n_out
        n_in = 2 * n_out if bb.get("dense") else n_out
    head = init["head"]
    per_set, n_in = 0, head["in_size"]
    for n_out in head["mlp_out_sizes"]:
        per_set += n_in * n_out
        n_in = n_out
    res = head["orientation_grid_resolution"]
    cells = 6 * 2 ** res * 12 * 4 ** res
    per_set += n_in * (latent_size + 4 + cells)
    return n_points * per_point + per_set


def estimate_flops(vae: Dict, init: Dict, n_points: int, decodes: int,
                   init_sets: int) -> float:
    """FLOPs of refinement iterations that decode ``decodes`` latents and
    take the gradient to each (the decoder's weights are frozen: its
    backward computes activation gradients only, as many multiply-adds as
    the forward), and of ``init_sets`` init network passes."""
    dec = sum(decoder_macs(vae))
    return 2.0 * (2 * dec * decodes
                  + pointnet_macs(init, vae["latent_size"], n_points)
                  * init_sets)


def train_flops(vae: Dict, samples: int) -> float:
    """FLOPs of VAE training steps over ``samples`` grids: forward,
    weight gradients and activation gradients of the encoder and the
    decoder; the encoder's first layer needs no gradient of its input."""
    dec = sum(decoder_macs(vae))
    enc = encoder_macs(vae)
    per = 3 * dec + 3 * sum(enc) - enc[0]
    return 2.0 * per * samples


def mfu(flops: float, seconds: float) -> float:
    """Percent of the fp32 peak."""
    return 100.0 * flops / seconds / FP32_FLOP_PER_S if seconds else math.nan
