"""The window's arithmetic on a fake clock, the trace's idle gaps and the
readers of the metrics on made-up records."""

import pytest

from perfbench import harness, tracing


class Clock:
    """A clock that each run advances by its own duration."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _loop(durations, seconds, fail=()):
    clock = Clock()

    def call(i):
        clock.t += durations[i]
        if i in fail:
            raise FloatingPointError("non-finite")
        return i

    return harness.closed_loop(call, seconds, clock=clock)


def test_window_ends_at_first_return_after_seconds():
    w = _loop([0.3] * 20, 1.0)
    assert len(w.runs) == 4 and w.seconds == pytest.approx(1.2)


def test_rate_is_all_work_over_all_time():
    w = _loop([0.1, 0.5, 0.2, 0.4, 0.3], 1.5, fail={2})
    assert len(w.runs) == 5 and w.ok == 4
    assert w.rate(1000) == pytest.approx(4000 / 1.5)


def test_p90_over_every_run():
    durs = [0.01 * (i % 10 + 1) for i in range(100)] + [0.5] * 50
    w = _loop(durs, 10.0)
    d = sorted(1e3 * x for x in durs[:len(w.runs)])
    assert w.percentile_ms(90) == pytest.approx(d[int(0.9 * len(d)) - 1])
    assert _loop([0.2] * 10, 1.0).percentile_ms(90) == pytest.approx(200)


def test_idle_named_by_innermost_host_record():
    dev = [(10, 20, "k"), (30, 35, "k"), (35, 60, "k")]
    host = [(0, 100, "perfbench.run"), (22, 29, "aten::randn")]
    idle = tracing.idle_by_host(dev, host, 0, 70)
    assert idle == pytest.approx({"perfbench.run": 20e-6,
                                  "aten::randn": 10e-6})


def _record(unit, per_kernel, busy=1.0, shape=None):
    w = harness.Window(0.0, 2.0, [(0.0, 1.0, True), (1.0, 2.0, True)])
    return {"unit": unit, "window": w, "work_per_run": 262144,
            "setup_s": 9.0, "timings": {"powerspec": 0.5,
                                        "device_constants": 0.25},
            "shape": shape or {"N": 256, "P": 82, "L": 4,
                               "precision": "default", "mixed": True,
                               "boiling": True},
            "trace": {"busy_s": busy, "window_s": 2.0,
                      "per_kernel": per_kernel}}


K2 = {"void synth_pass1<1, true>(...)": 0.6, "void detect_pass<1>(...)": 0.3,
      "sum_tiles": 0.01, "aten::copy": 0.09}
K1 = {"void colfac_pass1<1>(...)": 0.6, "void detect_pass<1>(...)": 0.39,
      "aten::copy": 0.01}


@pytest.mark.parametrize("kernels", [K2, K1], ids=["k2", "k1"])
def test_step_mfu_takes_the_least_route_whatever_ran(kernels):
    spec = harness.Spec()
    read = spec.reader("step_mfu.iid")
    v = read(_record("realizations", kernels))
    # 262,144 draws at K1's count (the lesser at 82 px): 71 ns a draw
    assert v == pytest.approx(100 * 262144 * 35.27e6 / 495e12, rel=1e-2)
    assert 0 < v < 100


def test_step_mfu_same_for_k3_at_wide_pupil():
    spec = harness.Spec()
    read = spec.reader("step_mfu.iid")
    wide = {"N": 1024, "P": 402, "L": 4, "precision": "default",
            "mixed": True, "boiling": False}
    a = read(_record("realizations", K2, shape=wide))
    b = read(_record("realizations", {"void split_pass1<1>(...)": 0.9},
                     shape=wide))
    assert a == b


def test_host_clock_readers():
    spec = harness.Spec()
    rec = _record("realizations", K2)
    assert spec.reader("realizations_per_s")(rec) == 262144
    assert spec.reader("steps_per_s")(rec) is None
    assert spec.reader("run_p90_ms")(rec) == 1000
    assert spec.reader("setup_s")(rec) == 9.0
    assert spec.reader("psd_s")(rec) == 0.5
    assert spec.reader("tables_s")(rec) == 0.25
    assert spec.reader("device_idle_pct.iid")(rec) == 50.0
    assert spec.reader("device_idle_pct.temporal")(rec) is None
    assert spec.reader("points_per_s")(rec) is None
    assert spec.reader("point_setup_s")(rec) is None


def test_sweep_readers():
    spec = harness.Spec()
    rec = dict(_record("points", K2), inits=[0.5, 0.75, 1.0])
    assert spec.reader("points_per_s")(rec) == 1.0
    assert spec.reader("point_setup_s")(rec) == 0.75
    assert spec.reader("realizations_per_s")(rec) is None
