"""The 16-layer time series of the benchmark (``temporal512_16l``) and
the AR route past ``FUSED_MAX_LAYERS`` layers, on small CPU runs.

* The configuration, found by name through ``perfbench.harness``, is the
  fixture link at 512² through ``HV57_Bufton_profile(16)`` written out
  as numbers, its run 8,192 steps in 2 chunks; 16 layers take K5.
* A temporal AR run of ``Fast`` through K5's route (its plain version
  on the CPU: 10 layers, so that the last block of ``STREAM_LAYERS`` is
  ragged) gives the powers of the benchmark's float64 replay
  (``perfbench.reference.plain.ar_powers``) at the check's picked steps,
  from the same seed; the bfloat16 control does not.
* The spans and counters of the route: ``fast.temporal_logamp`` inside
  ``fast.powerspec`` with ``TEMPORAL`` on only, ``fast.ar_start`` once a
  run, ``ar_kernel`` and ``ar_layer_blocks``.
* The readers ``temporal_logamp_s`` and ``ar_roofline`` on synthetic
  records, None without their key or trace.
"""

import numpy as np
import pytest
import torch

import fast_tpu
import fast_tpu_torch
from fast_tpu_torch.ops import ar_flow
from fast_tpu_torch.utils.profiling import StageTimer
from perfbench import check, harness
from perfbench.counts.bounds import PEAKS, ar_bound
from perfbench.reference import plain
from perfbench.reference.setup.host import HostSetup

torch.set_num_threads(1)

CELL = "temporal512_16l.temporal8k"
SEED = 2 ** 33 + 4321


@pytest.fixture(scope="module")
def spec():
    return harness.Spec()


def cell_params(spec):
    w = spec.cell(CELL)
    return harness.run_params(spec.config(w["config"]),
                              spec.traffic(w["traffic"]))


def small_params(spec, nlayers, **overrides):
    """The cell's parameters at a CPU size: a 48² grid, a 22 px pupil,
    ``nlayers`` layers of HV57/Bufton, 64 steps in 2 chunks (the layers
    whose wind wraps the grid in fewer steps boil)."""
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(nlayers)
    p = cell_params(spec)
    p.update(NPXLS=48, D_GROUND=0.2, DSUBAP=0.05, NITER=64, NCHUNKS=2,
             H_TURB=list(h), CN2_TURB=list(cn2), WIND_SPD=list(w),
             WIND_DIR=list(np.arange(nlayers) * (360.0 / nlayers)))
    p.update(overrides)
    return p


def test_configuration_is_the_16_layer_fixture_link(spec):
    p = cell_params(spec)
    assert (p["NPXLS"], p["NITER"], p["NCHUNKS"]) == (512, 8192, 2)
    assert p["TEMPORAL"] and p["TEMPORAL_SYNTH"] == "ar"
    assert p["DT"] == 0.001 and p["TEMPORAL_ALPHA"] == "auto"
    for profile in (fast_tpu.turbulence_models.HV57_Bufton_profile,
                    fast_tpu_torch.turbulence_models.HV57_Bufton_profile):
        for key, want in zip(("H_TURB", "CN2_TURB", "WIND_SPD"),
                             profile(16)):
            np.testing.assert_allclose(p[key], np.asarray(want), rtol=1e-15,
                                       atol=0)
    np.testing.assert_allclose(
        np.sum(p["CN2_TURB"]),
        np.sum(fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)[1]),
        rtol=1e-14)
    assert p["WIND_DIR"] == [22.5 * i for i in range(16)]
    # the fixture link itself: every other key is flagship256's
    flag = spec.config("flagship256")["params"]
    cfg = spec.config("temporal512_16l")
    changed = {k for k in flag if flag[k] != cfg["params"][k]}
    assert changed == {"NPXLS", "H_TURB", "CN2_TURB", "WIND_SPD", "WIND_DIR"}
    assert cfg["reduced"] == [] and len(cfg["source"]) <= 200
    assert ar_flow.select(16) is ar_flow.ar_flow_streamed
    # a chunk is one launch of the kernel at its most steps
    assert p["NITER"] // p["NCHUNKS"] == ar_flow.MAX_STEPS


def test_streamed_route_matches_the_float64_replay(spec):
    p = small_params(spec, 10, SEED=SEED)
    sim = fast_tpu_torch.Fast(p, device="cpu")
    assert sim.ar_kernel == "streamed" and sim.ar_layer_blocks == 3
    assert bool((sim._ar_alpha < 1).any())
    power = np.asarray(sim.run().power)
    setup = HostSetup(p)
    [(_, picks)] = check.sample(spec.check(CELL)["sample"], SEED, 1,
                                p["NCHUNKS"], p["NITER"], True)
    ref = plain.ar_powers(setup, SEED, picks)
    # the CPU program's float32 state and products against complex128:
    # 3e-7 to 7e-7 of the mean power over three seeds; 1e-5 leaves 15x
    # room and sits 47x or more under the bfloat16 control (4.7e-4 and up)
    assert check.power_gap(power[picks], ref) < 1e-5
    low = plain.ar_powers(setup, SEED, picks, precision="bf16")
    assert check.power_gap(low, ref) > 1e-4


def test_spans_and_counters_of_the_temporal_route(spec):
    with StageTimer.recording() as recs:
        sim = fast_tpu_torch.Fast(small_params(spec, 16), device="cpu")
    t = sim.timings
    assert 0 < t["temporal_logamp"] <= t["powerspec"]
    by_id = {r.id: r for r in recs}
    [inner] = [r for r in recs if r.name == "fast.temporal_logamp"]
    assert by_id[inner.parent].name == "fast.powerspec"
    assert (sim.ar_kernel, sim.ar_layer_blocks) == ("streamed", 4)

    before = sim.profile.totals.get("fast.ar_start", {}).get("count", 0)
    for s in (5, 6):
        sim.set_seed(s)
        sim.run()
    assert sim.profile.totals["fast.ar_start"]["count"] == before + 2

    four = fast_tpu_torch.Fast(small_params(spec, 4), device="cpu")
    assert (four.ar_kernel, four.ar_layer_blocks) == ("fused", 1)
    exact = fast_tpu_torch.Fast(small_params(spec, 4, SYNTH="fft"),
                                device="cpu")
    assert (exact.ar_kernel, exact.ar_layer_blocks) == (None, None)
    iid = fast_tpu_torch.Fast(small_params(spec, 4, TEMPORAL=False),
                              device="cpu")
    assert "temporal_logamp" not in iid.timings
    assert (iid.ar_kernel, iid.ar_layer_blocks) == (None, None)
    iid.run()
    assert "fast.ar_start" not in iid.profile.totals


def _record(unit="steps", timings=None, trace=None, runs=3, work=8192):
    window = harness.Window(0.0, 1.0, [(0.0, 1.0, True)] * runs)
    return {"unit": unit, "timings": timings or {}, "trace": trace,
            "window": window, "work_per_run": work,
            "shape": {"N": 512, "P": 82, "L": 16, "precision": "default",
                      "mixed": True, "boiling": True}}


def test_temporal_logamp_reader(spec):
    read = spec.reader("temporal_logamp_s")
    assert read(_record(timings={"powerspec": 9.0,
                                 "temporal_logamp": 4.5})) == 4.5
    assert read(_record(timings={"powerspec": 9.0})) is None


def test_ar_roofline_reader(spec):
    read = spec.reader("ar_roofline")
    per = {"void (anonymous namespace)::ar_update<4, 1>(...)": 0.20,
           "void (anonymous namespace)::ar_dft<1, 32, 1>(...)": 0.05,
           "void (anonymous namespace)::ar_detect<1, 32, 1>(...)": 0.01,
           "void fast::sum_tiles<2>(...)": 0.004,
           "void at::native::elementwise_kernel<...>": 0.5}
    trace = {"busy_s": 0.764, "window_s": 1.0, "per_kernel": per}
    least = ar_bound(16, 512, 82, 3 * 8192, True, peak=PEAKS["default"])[0]
    got = read(_record(trace=trace))
    assert got == pytest.approx(100 * least / 1e3 / 0.264, rel=1e-12)
    assert 0 < got < 100
    assert read(_record()) is None
    assert read(_record(trace=dict(trace, per_kernel={
        "void at::native::elementwise_kernel<...>": 0.5}))) is None
    assert read(_record(unit="realizations", trace=trace)) is None


def test_cell_entries(spec):
    cells = {m["name"]: m.get("workloads") for m in
             spec.data["end_to_end"] + spec.data["per_layer"]}
    for name in ("steps_per_s", "run_p90_ms", "temporal_logamp_s",
                 "ar_roofline"):
        assert CELL in cells[name], name
    assert spec.cell(CELL)["chips"] == 1
    assert spec.check(CELL)["sample"] == {"runs": 1, "steps_per_chunk": 64}
