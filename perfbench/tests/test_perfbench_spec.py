"""BENCHMARK.json against the benchmark's contract, and each cell's files
found by name."""

import json
import re

import pytest

from perfbench import harness
from perfbench.tests.tiny import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells at this length fits its time
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", METRICS + SPEC["configs"]
                         + SPEC["workloads"], ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.match(entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_entry_keys_and_bounds():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in names
        moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/configs/")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    spec = harness.Spec()
    w = spec.cell(cell)
    config = spec.config(w["config"])
    assert len(config["source"]) <= 200 and "params" in config
    traffic = spec.traffic(w["traffic"])
    params = harness.run_params(config, traffic)
    assert params["NITER"] % params["NCHUNKS"] == 0
    assert set(spec.check(cell)["limits"]) == {"power_gap", "moments_gap"}
    for m in spec.metrics(cell, False) + spec.metrics(cell, True):
        assert callable(spec.reader(m["name"]))
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell, niter, nchunks", [
    ("flagship256.iid", 262144, 16), ("flagship256.temporal", 65536, 16),
    ("flagship256.sweep", 2000, 2)])
def test_run_sizes(cell, niter, nchunks):
    spec = harness.Spec()
    w = spec.cell(cell)
    p = harness.run_params(spec.config(w["config"]),
                           spec.traffic(w["traffic"]))
    assert (p["NITER"], p["NCHUNKS"]) == (niter, nchunks)
    assert p["PRECISION"] == "default" and p["SYNTH"] == "auto"
    assert p["MC_NOISE"] == "mixed" and p["L0"] == float("inf")


def test_sweep_points_in_turn():
    spec = harness.Spec()
    traffic = spec.traffic("sweep")
    p = harness.run_params(spec.config("flagship256"), traffic)
    zeniths = [harness.point_params(p, traffic, i)["ZENITH_ANGLE"]
               for i in range(6)]
    assert zeniths == [0, 30, 45, 60, 0, 30]
    assert harness.point(spec.traffic("iid"), 5) is None
    assert harness.point_params(p, spec.traffic("iid"), 5) is p
