"""The yardstick's counts against hand counts from the shapes and the
configuration's widths."""
import json
import os

import pytest

from conftest import ROOT

from bench_port.harness import counting


def mug():
    with open(os.path.join(ROOT, "bench_port/configs/mug_procedural.json")) \
            as f:
        return json.load(f)


@pytest.mark.parametrize("kernel,rows,batch,expected", [
    # 640x480 rays: 12-byte directions in, a 4-byte depth out, a pose
    ("march", 307200, 1, 307200 * 12 + 307200 * 4 + 56),
    ("march", 307200, 8, 307200 * 12 + 8 * 307200 * 4 + 8 * 56),
    # a 12-byte point and a mask in and a value out per row
    ("sample", 307200, 1, 307200 * 20),
    # a point and a mask in, a value and a 3-vector out per row
    ("sample_grad", 614400, 8, 8 * 614400 * 32),
    # a point and a cotangent in per row, the whole 64^3 grid out
    ("scatter", 614400, 1, 614400 * 16 + 64 ** 3 * 4),
])
def test_kernel_bytes(kernel, rows, batch, expected):
    assert counting.kernel_bytes(kernel, rows, batch) == expected


def test_bound_seconds_sums_launches():
    launches = {"sample": [(100, 1, 3)], "scatter": [(100, 2, 1)]}
    b = 3 * 2000 + (2 * 1600 + 2 * 64 ** 3 * 4)
    assert counting.bound_seconds(launches) == pytest.approx(b / 3.35e12)


def test_decoder_macs_from_the_widths():
    # FC 8 -> 20 -> 50 -> 8192; convs at 8, 16, 32 (k 3) and 64 (k 1)
    fc = [8 * 20, 20 * 50, 50 * 8192]
    conv = [6 ** 3 * 16 * 16 * 27, 14 ** 3 * 8 * 16 * 27,
            30 ** 3 * 4 * 8 * 27, 64 ** 3 * 1 * 4 * 1]
    assert counting.decoder_macs(mug()["estimation"]["vae"]) == fc + conv
    assert 2 * sum(fc + conv) == pytest.approx(71.5e6, rel=0.01)


def test_encoder_macs_from_the_widths():
    # stride-2 k3 convs 64 -> 31 -> 15 -> 7, then two heads of 5488 -> 8
    expected = [31 ** 3 * 4 * 1 * 27, 15 ** 3 * 8 * 4 * 27,
                7 ** 3 * 16 * 8 * 27, 2 * 16 * 7 ** 3 * 8]
    assert counting.encoder_macs(mug()["training"]) == expected


def test_pointnet_macs_from_the_widths():
    init = mug()["estimation"]["init"]
    per_point = 3 * 128 + 3 * (256 * 128) + 256 * 1024
    per_set = 1024 * 512 + 512 * 256 + 256 * 128 + 128 * (8 + 4 + 576)
    assert counting.pointnet_macs(init, 8, 2500) == \
        2500 * per_point + per_set


def test_flop_totals():
    m = mug()
    dec = sum(counting.decoder_macs(m["estimation"]["vae"]))
    enc = counting.encoder_macs(m["training"])
    assert counting.estimate_flops(m["estimation"]["vae"],
                                   m["estimation"]["init"], 2500, 50, 0) \
        == 2.0 * 2 * dec * 50
    assert counting.train_flops(m["training"], 8) == \
        2.0 * 8 * (3 * dec + 3 * sum(enc) - enc[0])
    assert counting.mfu(67e12, 1.0) == pytest.approx(100.0)


def test_readers_take_the_wall_from_the_untraced_window():
    from bench_port.harness import readers
    from bench_port.harness.trace import Slice

    # 0.09 s of device work in two calls; the profiler stretched the slice
    # to 0.4 s, the same calls took 0.1 s untraced
    device = [("march_kernel", 0.0, 0.03, "kernel"),
              ("cudnn_conv", 0.02, 0.05, "kernel"),
              ("add", 0.3, 0.34, "kernel")]
    work = {"launches": {"march": [(1000, 1, 2)]}, "iterations": 2,
            "train_samples": 8, "model": mug()["training"]}
    sl = Slice(0.4, device, [], work, wall_s=0.1)
    assert readers.idle_share(sl) == pytest.approx(10.0)
    assert readers.mfu(sl) == pytest.approx(counting.mfu(
        counting.train_flops(mug()["training"], 8), 0.1))
    assert readers.conv_share(sl) == pytest.approx(100 * 0.03 / 0.09)
    assert readers.kernels_per_iter(sl) == 1.5
    assert readers.kernel_roofline(sl) == pytest.approx(
        100 * counting.bound_seconds(work["launches"]) / 0.03)
    empty = Slice(0.4, [], [], {}, wall_s=0.0)
    for read in (readers.idle_share, readers.mfu, readers.conv_share,
                 readers.kernels_per_iter, readers.kernel_roofline):
        assert read(empty) is None


def test_untraced_wall_takes_each_calls_item_mean():
    from bench_port.harness import drivers

    d = drivers.Frames.__new__(drivers.Frames)
    d.order = [2, 0, 1]
    w = {"walls": {2: [0.5, 0.7], 0: [1.0]}}
    # calls 3, 4, 5 run items 2, 0 and 1; item 1 has no interval in the
    # window, so it takes the mean of all
    assert d.untraced_wall(w, [3, 4, 5]) == pytest.approx(
        0.6 + 1.0 + (0.5 + 0.7 + 1.0) / 3)
