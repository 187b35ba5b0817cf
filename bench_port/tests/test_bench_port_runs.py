"""Whole runs of every cell on the CPU at a small size: the result line's
keys, the reference's agreement with the port (``__call__``,
``refine_batch`` and a VAE step: bit for bit here, where both run the
plain PyTorch operations), and a cell, a traffic mix and a per-layer
metric added as new files only."""
import json
import os
import shutil

import pytest

from conftest import CELLS, ROOT, run_small, small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_run_line_and_reference_agreement(name):
    cell = small_cell(name)
    out = run_small(cell)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in out["checks"].values():
        assert c["value"] == 0.0  # the same plain operations on both sides
    json.dumps(out)


def test_traced_line_has_breakdown_and_window():
    out = run_small(small_cell("mug_procedural.hyp8"), trace=True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device here: the readers of device time find nothing, and say so
    assert "idle_share.hyp" not in out["metrics"]
    assert out["metrics"]["mfu.hyp"]["value"] > 0


def test_a_cell_added_by_files_alone(tmp_path):
    bench = tmp_path / "bench_port"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "bench_port", sub), bench / sub)
    os.symlink(os.path.join(ROOT, "trained_models"),
               tmp_path / "trained_models")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    before = {p: os.path.getmtime(os.path.join(ROOT, "bench_port", p))
              for p in ("harness/run.py", "harness/drivers.py",
                        "harness/cell.py")}
    # new files: a configuration, a traffic mix and a metric
    with open(bench / "configs" / "mug_procedural.json") as f:
        cfg = json.load(f)
    cfg["views"]["z_min"], cfg["views"]["z_max"] = 0.3, 0.4
    (bench / "configs" / "mug_near.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "two_frames.json").write_text(json.dumps(
        {"kind": "frames", "pool": 2, "checked_calls": 1, "trace_calls": 1,
         "limits": {"step_gap": 1e-3, "loss_gap": 1e-5}}))
    (bench / "metrics" / "calls_traced.py").write_text(
        "def read(sl):\n    return float(sl.work['calls'])\n")
    # new entries
    spec["configs"].append({"name": "mug_near", "source": "x",
                            "file": "bench_port/configs/mug_near.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "mug_near.two_frames",
                              "config": "mug_near", "traffic": "two_frames",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["mug_near.two_frames"]})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls",
                              "better": "higher", "source": "program_counter",
                              "layer": "pipeline call",
                              "moves": "frames_per_s",
                              "workloads": ["mug_near.two_frames"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = small_cell("mug_near.two_frames", root=str(tmp_path),
                      bench_dir=str(bench))
    out = run_small(cell, trace=True)
    assert out["correct"] is True
    assert out["metrics"]["calls_traced"]["value"] == 1.0
    after = {p: os.path.getmtime(os.path.join(ROOT, "bench_port", p))
             for p in before}
    assert after == before
