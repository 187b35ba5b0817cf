"""The per-layer metrics' readers, one function per family; each file
``metrics/<name>.py`` names the one it reads with (``read = ...``).

Each takes a :class:`harness.trace.Slice` and returns the metric's value,
or ``None`` where the slice holds nothing to read.  Device times come from
the profiler's trace; a wall time comes from the untraced window
(``Slice.wall_s``), since the profiler slows every graph node's launch and
so stretches the traced slice's own wall.
"""
from __future__ import annotations

from bench_port.harness import counting

# cuDNN's forward, data- and weight-gradient kernels and their layout
# transforms
CONV = r"(?i)conv|cudnn|xmma_(fprop|dgrad|wgrad)|wgrad|dgrad|fprop"
HAND_KERNELS = (r"\b(march|march_warm|sample|sample_grad|scatter|"
                r"scatter_count|scatter_alloc|scatter_place)_kernel\b")


def idle_share(sl):
    """The device's idle share: 1 - the union of the intervals in which a
    kernel, copy or set ran in the slice, over the wall time the same
    calls took in the untraced window."""
    if not sl.wall_s or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)


def kernel_roofline(sl):
    """The hand-written kernels' share of their roofline: the least time
    of their launches (the bytes each must move, from the launch shapes,
    at the HBM's bandwidth: ``harness/counting.py``) over the union of
    their device intervals (the scatter's stages overlap under dependent
    launch, so they are joined, not summed)."""
    busy = sl.union_s(sl.kernels(HAND_KERNELS))
    launches = sl.work.get("launches")
    if not busy or not launches:
        return None
    return 100.0 * counting.bound_seconds(launches) / busy


def mfu(sl):
    """The whole step's share of the fp32 peak: the model FLOPs of the
    slice's work from the configuration's widths (``harness/counting.py``:
    an estimate's decodes with their activation gradients and its init
    network passes, or a VAE training step's forward and gradients) over
    the wall time the same calls took in the untraced window."""
    w = sl.work
    if not sl.wall_s:
        return None
    if w.get("train_samples"):
        flops = counting.train_flops(w["model"], w["train_samples"])
    elif w.get("decodes"):
        m = w["model"]
        flops = counting.estimate_flops(m["vae"], m["init"],
                                        w["init_points"], w["decodes"],
                                        w["init_sets"])
    else:
        return None
    return counting.mfu(flops, sl.wall_s)


def kernels_per_iter(sl):
    """Device kernels launched per refinement iteration and view (every
    hypothesis of a batch shares an iteration's launches): the glue around
    the decoder and the hand-written kernels."""
    n = sl.work.get("iterations", 0) * sl.work.get("views", 1)
    kernels = sl.kernels()
    if not n or not kernels:
        return None
    return len(kernels) / n


def conv_share(sl):
    """The share of the device's busy time in convolution kernels, found
    by their names (``CONV``)."""
    busy = sl.busy_s
    conv = sl.kernels(CONV)
    if not busy or not conv:
        return None
    return 100.0 * sl.union_s(conv) / busy
