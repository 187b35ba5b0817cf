"""Readings that set the limits of ``correct``: the program's numbers on
many seeds, the control's, and for a training cell the planted faults'.

    python3 bench_port/control.py --workload mug_procedural.frames \\
        --program 101 102 103 --control 201 202 203 --seconds 3

For each ``--program`` seed the cell's own inputs are made, the program
runs a short window at the cell's load and the run's own check compares it
with the reference (one pipeline serves every seed).  For each
``--control`` seed the reference itself is put in the program's place,
computed in TF32 (the precision below the configurations' fp32 without
TF32), and checked the same way; a training cell also reads its planted
faults there: half of each batch left out (the mean taken over the rest)
and a step that leaves the state unchanged.  Runs on the card only; the
benchmark's own runs never run this.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from bench_port.harness import cell as cell_mod  # noqa: E402
from bench_port.harness import drivers  # noqa: E402
from bench_port.reference import estimate as ref_estimate  # noqa: E402
from bench_port.reference import train as ref_train  # noqa: E402


def program_readings(cell, seeds, seconds, device):
    pipe = None
    out = []
    for seed in seeds:
        d = drivers.KINDS[cell.kind](cell, seed, device)
        if cell.kind == "vae_train":
            d.setup()
        else:
            d.setup(pipe=pipe)
            pipe = d.pipe
        d.window(seconds)
        gaps = d.check()
        print(f"program seed {seed}: " + " ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in gaps.items()), flush=True)
        out.append(gaps)
        if cell.kind == "vae_train":
            d.release()
    return out


def control_readings(cell, seeds, device, root):
    out = []
    for seed in seeds:
        d = drivers.KINDS[cell.kind](cell, seed, device)
        if cell.kind == "vae_train":
            found = _train_control(d, device)
        else:
            found = _estimate_control(d, root, device)
        for label, gaps in found.items():
            print(f"{label} seed {seed}: " + " ".join(
                f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                for k, v in gaps.items()), flush=True)
        out.append(found)
    return out


def _estimate_control(d, root, device):
    d.est_config = d.estimation_config()
    d.make_inputs()
    ref = ref_estimate.Estimate(d.est_config, root, device)
    ctrl = ref_estimate.Estimate(d.est_config, root, device, tf32=True)
    worst = {"step_gap": 0.0, "loss_gap": 0.0}
    n = int(d.traffic["checked_calls"])
    for i in range(n):
        f = d.order[i % len(d.order)]
        if d.cell.kind == "hypotheses":
            depth, points, mask, starts = d.items[f]
            start = {k: starts[k][:, 0] for k in ref_estimate.STATE_KEYS}
            phases = [(1, int(d.est_config["max_iterations"]), None)]
            answer, log = ctrl.run(start, depth[0], points=points[0],
                                   point_mask=mask[0], phases=phases)
            got = ref.follow(depth[0], log, answer, start=start,
                             points=points[0], point_mask=mask[0],
                             phases=phases)
        else:
            n_pts = d.est_config.get("num_input_points", 2500)
            u = torch.rand(n_pts, generator=torch.Generator(
                device=device).manual_seed(d.call_seeds[i]), device=device)
            depth, mask = d.frames["depth"][f], d.frames["mask"][f]
            answer, log = ctrl.run({"uniforms": u}, depth, mask)
            got = ref.follow(depth, log, answer, mask=mask, uniforms=u)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    return {"control": worst}


def _train_control(d, device):
    d.make_inputs()
    cfg = d.train_config
    draws = d.draws()
    ref = ref_train.follow(cfg, d.start, d.data, draws)
    out = {}
    for label, kw in (("control", dict(tf32=True)),
                      ("fault half_batch", dict(fault="half_batch")),
                      ("fault unchanged", dict(fault="unchanged"))):
        other = ref_train.follow(cfg, d.start, d.data, draws, **kw)
        out[label] = ref_train.compare(other, ref, d.start)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    root = os.getcwd()
    cell = cell_mod.resolve(args.workload, root)
    if not torch.cuda.is_available():
        print("the control's readings need a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    program_readings(cell, args.program, args.seconds, device)
    control_readings(cell, args.control, device, root)
    print(f"readings took {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
