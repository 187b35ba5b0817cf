"""Micro-benchmarks of the VAE's building-block ops (counterpart of
``sdfest_tpu/scripts/benchmark_ops.py``): Conv3d 16x16^3 c8->c16 k3 (SAME
padding), Linear 64x2048->2048 and the port's ``resize_trilinear`` 16->32 on
8x4 channels.  The layers are PyTorch's ``nn.Conv3d``/``nn.Linear``, as the
JAX script times flax's layers.

Each timed call gets a distinct input (scaled by ``1 + 1e-4 i``), the sums
of the outputs accumulate on the device, and the host clock reads around a
device synchronize.

Usage: python -m sdfest_torch.scripts.benchmark_ops [--iters 100]
    [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch
from torch import nn

from sdfest_torch.models.vae import fp32_convolutions
from sdfest_torch.ops.interpolation import resize_trilinear
from sdfest_torch.utils.device import resolve_device, synchronize


def sweep_time(fn, x0: torch.Tensor, iters: int) -> float:
    """Mean seconds per call over ``iters`` distinct scaled inputs (after
    one warm-up sweep)."""
    scales = 1.0 + 1e-4 * torch.arange(iters, dtype=x0.dtype,
                                       device=x0.device)

    def run(x):
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        for s in scales:
            acc = acc + torch.sum(fn(x * s))
        return acc

    with torch.no_grad():
        run(x0)
        synchronize(x0.device)
        t0 = time.perf_counter()
        run(x0 * 1.0001)
        synchronize(x0.device)
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator().manual_seed(0)
    times = {}

    x3d = torch.randn(16, 8, 16, 16, 16, generator=g).to(dev)  # NCDHW
    conv = nn.Conv3d(8, 16, kernel_size=3, padding="same").to(dev)
    with fp32_convolutions():
        times["conv3d"] = t = sweep_time(conv, x3d, args.iters)
    print(f"Conv3d 16x16^3 c8->c16 k3: {t * 1000:.3f} ms")

    xlin = torch.randn(64, 2048, generator=g).to(dev)
    dense = nn.Linear(2048, 2048).to(dev)
    times["linear"] = t = sweep_time(dense, xlin, args.iters)
    print(f"Linear 64x2048->2048: {t * 1000:.3f} ms")

    xvol = torch.randn(8, 4, 16, 16, 16, generator=g).to(dev)
    times["trilinear"] = t = sweep_time(lambda x: resize_trilinear(x, 32),
                                        xvol, args.iters)
    print(f"Trilinear upsample 16->32 (8x4ch): {t * 1000:.3f} ms")

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}")
    return times


if __name__ == "__main__":
    main()
