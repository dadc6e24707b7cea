"""A copy of the benchmark in a temporary folder with a configuration,
traffic mixes (a sweep among them), their cells, their checks and a
per-layer metric added as new files and entries only: what a later change
adds, at a size the CPU runs in a second."""

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

CELLS = ("tiny.tiny_iid", "tiny.tiny_temporal", "tiny.tiny_sweep")
#: The end-to-end rate of each tiny mix.
RATE = {"tiny_iid": "realizations_per_s", "tiny_temporal": "steps_per_s",
        "tiny_sweep": "points_per_s", "tiny_iid_gauss": "realizations_per_s",
        "tiny_temporal_gauss": "steps_per_s"}
#: Cells of the same configuration on Box-Muller noise.
GAUSS = ("tiny.tiny_iid_gauss", "tiny.tiny_temporal_gauss")
#: The tiny cells' limits: the CPU program computes fp32 products, a few
#: 1e-7 of the mean power from the float64 reference.
LIMITS = {"power_gap": 1e-4, "moments_gap": 1e-9}

METRIC = '''"""runs_in_window: the run() calls of the window."""


def read(record):
    return float(len(record["window"].runs))
'''


def make(tmp):
    """The copy under ``tmp``; returns ``(root, base)`` for
    ``harness.Spec``."""
    root = Path(tmp)
    base = root / "perfbench"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((base / "configs" / "flagship256.json").read_text())
    cfg["params"].update(NPXLS=32, D_GROUND=0.2, DSUBAP=0.05)
    (base / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (base / "traffic" / "tiny_iid.json").write_text(json.dumps({
        "unit": "realizations", "params": {"TEMPORAL": False},
        "niter": {"product": 32 * 32 * 64, "grid_power": 2},
        "chunk": {"product": 32 * 32 * 16, "grid_power": 2,
                  "max": 16384}}))
    (base / "traffic" / "tiny_temporal.json").write_text(json.dumps({
        "unit": "steps",
        "params": {"TEMPORAL": True, "TEMPORAL_SYNTH": "ar", "DT": 0.001},
        "niter": {"product": 32 * 256, "grid_power": 1}, "chunks": 4}))
    (base / "traffic" / "tiny_sweep.json").write_text(json.dumps({
        "unit": "points",
        "params": {"TEMPORAL": False, "NITER": 128, "NCHUNKS": 2},
        "points": [{"ZENITH_ANGLE": 0}, {"ZENITH_ANGLE": 45}]}))
    for mix, noise in (("tiny_iid", "MC_NOISE"),
                       ("tiny_temporal", "TEMPORAL_NOISE")):
        t = json.loads((base / "traffic" / f"{mix}.json").read_text())
        t["params"][noise] = "gauss"
        (base / "traffic" / f"{mix}_gauss.json").write_text(json.dumps(t))
    (base / "metrics" / "runs_in_window.py").write_text(METRIC)
    spec["configs"].append({"name": "tiny", "source": "a test's own",
                            "file": "perfbench/configs/tiny.json",
                            "reduced": [], "why": "CPU tests"})
    for cell in CELLS + GAUSS:
        spec["workloads"].append({"name": cell, "config": "tiny",
                                  "traffic": cell.split(".")[1],
                                  "chips": 1, "why": "CPU tests"})
        (base / "checks" / f"{cell}.json").write_text(json.dumps({
            "sample": {"runs": 2, "draws_per_chunk": 8,
                       "steps_per_chunk": 16},
            "limits": LIMITS}))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" not in m or m["name"] == "run_p90_ms":
            continue
        rate = m["moves"] if "moves" in m else m["name"]
        m["workloads"] += [c for c in CELLS + GAUSS
                           if rate in ("setup_s", RATE[c.split(".")[1]])]
    spec["end_to_end"].append({"name": "runs_in_window", "unit": "runs",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": list(CELLS + GAUSS)})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, base
