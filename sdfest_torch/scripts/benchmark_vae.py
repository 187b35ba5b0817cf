"""Micro-benchmark of the VAE decoder's forward and forward+backward
latency (counterpart of ``sdfest_tpu/scripts/benchmark_vae.py``).

Each timed call decodes a distinct latent (each output feeds the next
call's input), and the host clock reads around a device synchronize; the
convolutions run in full fp32 (``fp32_convolutions``), as in the pipeline.

Usage: python -m sdfest_torch.scripts.benchmark_vae --config <vae.yaml> \\
    [--iterations 1000] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch

from sdfest_torch.models.vae import create_vae_from_config, fp32_convolutions
from sdfest_torch.utils import weights as weight_utils
from sdfest_torch.utils.config import load_config_from_args
from sdfest_torch.utils.device import resolve_device, synchronize


def benchmark(config: dict, iterations: int = 1000, device="cuda") -> dict:
    """Time decode fwd and fwd+bwd on ``device``; returns per-call
    seconds."""
    dev = resolve_device(device)
    vae = weight_utils.load_vae_params(config, create_vae_from_config(
        config)).to(dev).eval()
    z0 = torch.zeros(1, config["latent_size"], device=dev)

    def forward(z):
        with torch.no_grad():
            return z + 1e-6 * torch.sum(vae.decode(z))

    def forward_backward(z):
        z = z.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(torch.sum(vae.decode(z) ** 2), z)
        return z.detach() + 1e-6 * grad

    def timed(step, n):
        x = step(z0)
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            x = step(x)
        synchronize(dev)
        return (time.perf_counter() - t0) / n

    with fp32_convolutions():
        fwd = timed(forward, iterations)
        fwd_bwd = timed(forward_backward, iterations)
    results = {
        "decode_forward_s": fwd,
        "decode_forward_backward_s": fwd_bwd,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    print(f"Forward pass: {fwd * 1000:.3f} ms")
    print(f"Forward + backward pass: {fwd_bwd * 1000:.3f} ms")
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Benchmark VAE latency.")
    parser.add_argument("--config", nargs="+", required=False)
    parser.add_argument("--iterations", type=int, default=1000)
    parser.add_argument("--device", default="cuda")
    config = load_config_from_args(parser, argv)
    benchmark(config, config.get("iterations", 1000), config["device"])


if __name__ == "__main__":
    main()
