"""The program's own spans and device marks over a cell's calls: the
stages of a refinement iteration or a VAE training step, the device's
host-starved idle share, and the device's gaps by the program span the
host was in.  Run from the root of a checkout::

    python3 bench_port/span_window.py --workload mug_procedural.hyp8 \\
        --seed 7 --seconds 10

The cell is set up as a benchmark run sets it up, runs an untraced window
of ``--seconds`` (the rate that tracing's cost is read against), then the
span window (``harness/spans.py``).  The ``trace:`` lines go to the log;
the last line of standard output is the readings as JSON, in ms and %.
Runs on the card only; the benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port.harness import cell as cell_mod  # noqa: E402
from bench_port.harness import drivers, spans  # noqa: E402
from bench_port.harness.run import card_line, log  # noqa: E402


def measure(cell, seed: int, seconds: float, device,
            span_seconds: float = spans.SPAN_WINDOW_S) -> dict:
    """Set up ``cell``, run its untraced window and its span window, and
    return the span window's readings (empty without device marks)."""
    import torch

    driver = drivers.KINDS[cell.kind](cell, seed, device)
    if device.type == "cuda":
        from sdfest_torch.render import _build

        _build.build()
    driver.setup()
    log(f"setup: card {card_line()}")
    w = driver.window(seconds)
    win = spans.window(driver, w, span_seconds)
    driver.release()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return spans.readings(win, "train" if cell.kind == "vae_train"
                          else "hyp")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    cell = cell_mod.resolve(args.workload, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    out = measure(cell, args.seed, args.seconds, device)
    log(f"span window: done in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
