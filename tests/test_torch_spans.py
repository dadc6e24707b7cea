"""The port's spans (``utils.profiling.StageTimer``) on small CPU runs.

* An iid run and a temporal AR run record one ``fast.run`` with the
  seed as its run id, one ``fast.enqueue`` a chunk, and one each of
  ``fast.logamp``, ``fast.store`` and ``fast.wait`` (and of
  ``fast.ar_start`` on the AR route); every span nests
  inside its run's ``fast.run`` and carries its seed; each name's self
  time is at most its total, and a parent's total is its self time plus
  its children's, to the clock's resolution; the power series is the
  same, bit for bit, with and without a recording.
* ``recording()`` returns the records and keeps none after it closes;
  recordings do not nest.
* Under ``torch.profiler`` each span opens ``record_function`` of its
  name, whose record lies inside the span's stamps: the spans run on the
  profiler's clock. ``profiling.trace`` writes ``fast.run`` and
  ``fast.logamp`` into its file.
* ``sim.timings`` keeps the set-up stages and has no ``mc_run``.
* ``scripts/torch_span_window.py`` puts each device gap down to the
  innermost span holding its midpoint, ``outside`` where none does, and
  the parts sum to the window's idle.
"""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch.utils import profiling
from fast_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Children of each span name in the run path.
CHILDREN = {"fast.run": ("fast.ar_start", "fast.logamp", "fast.enqueue",
                         "fast.store"),
            "fast.store": ("fast.wait",)}


def small_params(**overrides):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": 64, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "DSUBAP": 0.1, "H_TURB": h,
        "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 3,
        "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


MODES = {"iid": {},
         "temporal_ar": {"TEMPORAL": True, "TEMPORAL_SYNTH": "ar",
                         "DT": 0.001, "NCHUNKS": 4}}


@pytest.fixture(scope="module", params=sorted(MODES))
def sim(request):
    return fast_tpu_torch.Fast(small_params(**MODES[request.param]),
                               device="cpu")


def test_run_records_its_spans(sim):
    sim.set_seed(11)
    plain = np.asarray(sim.run().power)
    before = {k: dict(v) for k, v in sim.profile.totals.items()}
    seeds = (11, 12)
    powers = []
    with sim.profile.recording() as recs:
        for s in seeds:
            sim.set_seed(s)
            powers.append(np.asarray(sim.run().power))
    np.testing.assert_array_equal(powers[0], plain)

    names = [r.name for r in recs]
    for name, count in (("fast.run", 1), ("fast.logamp", 1),
                        ("fast.enqueue", sim.Nchunks), ("fast.store", 1),
                        ("fast.wait", 1),
                        ("fast.ar_start", int(sim.temporal))):
        assert names.count(name) == count * len(seeds), name
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["fast.run"] * len(seeds)
    assert [r.run for r in roots] == list(seeds)
    for r in recs:
        assert r.start <= r.end
        p = r
        while p.parent is not None:  # up to its run's root
            p = by_id[p.parent]
            assert p.start <= r.start and r.end <= p.end
        assert p.name == "fast.run" and r.run == p.run

    # the totals over the recorded runs alone, and their closure
    tot = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
           for k, v in sim.profile.totals.items()}
    assert tot["fast.run"]["count"] == len(seeds)
    wall = sum(r.end - r.start for r in roots) / 1e9
    assert tot["fast.run"]["total_s"] == pytest.approx(wall, abs=1e-6)
    for name, t in tot.items():
        assert 0 <= t["self_s"] <= t["total_s"] + 1e-9, name
    for parent, kids in CHILDREN.items():
        assert tot[parent]["total_s"] == pytest.approx(
            tot[parent]["self_s"]
            + sum(tot[k]["total_s"] for k in kids if k in tot),
            abs=1e-6)


def test_recording_keeps_nothing_after_it_closes(sim):
    with sim.profile.recording() as recs:
        sim.run()
        with pytest.raises(RuntimeError):
            with StageTimer.recording():
                pass
    n = len(recs)
    assert n >= 5 and StageTimer._sink is None
    sim.run()
    assert len(recs) == n


def test_set_up_records_its_stages_and_no_run_stage():
    with StageTimer.recording() as recs:
        sim = fast_tpu_torch.Fast(small_params(), device="cpu")
    stages = ("init_geometry", "init_masks", "init_pupils", "link_budget",
              "powerspec", "device_constants")
    assert [r.name for r in recs] == ["fast." + s for s in stages]
    assert all(r.run is None and r.parent is None for r in recs)
    sim.run()
    assert set(sim.timings) == set(stages)


def test_spans_are_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    sim = fast_tpu_torch.Fast(small_params(), device="cpu")
    with StageTimer.recording() as recs:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sim.run()
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            marks.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert {r.name for r in recs} == set(marks)
    slack = 50_000  # ns: the profiler's own clock reads its TSC
    for r in recs:
        # each span holds its own record_function's record
        assert any(r.start - slack <= s and e <= r.end + slack
                   for s, e in marks[r.name]), r


def test_trace_names_the_run_spans(tmp_path):
    sim = fast_tpu_torch.Fast(small_params(), device="cpu")
    with profiling.trace(tmp_path):
        sim.run()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fast.run", "fast.logamp", "fast.enqueue", "fast.wait"} <= names


def _span_window():
    spec = importlib.util.spec_from_file_location(
        "torch_span_window", os.path.join(REPO, "scripts",
                                          "torch_span_window.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_goes_to_the_innermost_span():
    us = 1000  # ns
    dev = [(a * us, b * us, "k") for a, b in
           ((10, 20), (40, 50), (52, 56), (90, 95))]
    spans = [profiling.Span(i, name, a * us, b * us, parent, 7)
             for i, name, a, b, parent in (
                 (2, "fast.logamp", 2, 12, 1),
                 (3, "fast.enqueue", 25, 45, 1),
                 (5, "fast.wait", 62, 95, 4),
                 (4, "fast.store", 60, 96, 1),
                 (1, "fast.run", 0, 96, None))]
    parts = _span_window().idle_by_span(dev, spans, 0, 100 * us)
    assert parts == pytest.approx({
        "fast.wait": 34e-6, "fast.enqueue": 20e-6, "fast.logamp": 10e-6,
        "outside": 5e-6, "fast.run": 2e-6})
    busy = sum(b - a for a, b, _ in dev) / 1e9
    assert sum(parts.values()) == pytest.approx(100e-6 - busy)
