"""``BENCHMARK.json`` against the benchmark's contract, and every cell
resolved from it and the files named after its parts."""
import json
import os
import re

import pytest

import conftest
from conftest import BENCH_CELLS, CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "bench_port/run.py"]
    assert s["paths"] == ["bench_port"]
    assert 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_keep_to_the_contract():
    s = spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert c["file"].startswith("bench_port/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
    names = [c["name"] for c in s["configs"]]
    cells = s["workloads"]
    assert 1 <= len(cells) <= 24
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in cells}


def test_every_cell_reports_setup_another_metric_and_a_layer():
    s = spec()
    for w in s["workloads"]:
        e2e = [m["name"] for m in s["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in s["per_layer"]
                  if w["name"] in m.get("workloads", [])]
        assert layers
        for m in layers:  # each moves a metric its cell reports
            assert m["moves"] in e2e


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    from bench_port.harness import cell as cell_mod
    from bench_port.harness import drivers

    c = cell_mod.resolve(name, ROOT, spec=conftest.spec())
    assert c.kind in drivers.KINDS
    assert c.per_layer and c.end_to_end
    for m in c.per_layer:
        assert callable(cell_mod.metric_reader(m["name"]))
    assert set(c.traffic["limits"]) <= {"step_gap", "loss_gap", "grad_gap",
                                        "change_gap"}


def test_planned_cells_are_not_in_the_benchmark():
    assert set(BENCH_CELLS) == {"mug_procedural.hyp8",
                                "mug_procedural.vae_train"}
    assert not set(conftest.FRAME_CELLS) & set(BENCH_CELLS)


def test_unknown_cell_is_refused():
    from bench_port.harness import cell as cell_mod

    with pytest.raises(KeyError):
        cell_mod.resolve("no_such.cell", ROOT)
