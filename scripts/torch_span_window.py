"""The run loop's spans on the card, in one cell of the benchmark: windows
of ``run()`` calls in turns untraced and traced (``torch.profiler`` on
CUDA activity alone, the program's spans recorded), then one run under a
trace of CPU and CUDA activity.

    python scripts/torch_span_window.py --workload flagship256.temporal \
        [--seed N] [--seconds 20] [--turns 2] [--out FILE]

From the root of a checkout on a machine with a card. The set-up and the
windows are the benchmark's (``perfbench/run.py``): the cell's
configuration and mix, ``Fast()`` and one warm ``run()``, then a closed
loop of one caller, the seed advanced by one (a sweep builds each point's
own ``Fast``). Each window reports its rate, its mean run wall time (host
clock), and from the program's span totals (summed over a sweep's points)
the host ms a run of each span; a sweep, each point's own
``timings["powerspec"]`` (``point_psd_s``). A traced window reports too
the device's busy and idle seconds, and its idle put down to the innermost
``fast.*`` span that holds each gap's midpoint (``outside`` where none
does: the caller's loop), with how far the spans close: ``fast.run``'s
mean against the mean run wall time, and the idle's parts against
``window_s - busy_s``. The last line gives the spans' offsets from their
own ``record_function`` records in a CPU and CUDA trace of a few runs
(by name: the median at the start, at the end, and the largest). Prints one JSON line
each, with the card's name and power limit; ``--out`` keeps them.
"""

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness, tracing  # noqa: E402

#: The port's kernel libraries, built at once as the benchmark builds them.
LIBRARIES = ("synth_detect", "colfac_detect", "colfac_split", "ar_flow")
#: The spans of a run read per run (ms), and the names they go by.
PER_RUN = {"logamp_ms": "fast.logamp", "enqueue_ms": "fast.enqueue",
           "wait_ms": "fast.wait", "store_ms": "fast.store",
           "run_ms": "fast.run"}
#: Runs under the CPU and CUDA trace that reads the spans' offsets.
OFFSET_RUNS = 3


def idle_by_span(dev, spans, w0, w1):
    """Seconds of device idle inside ``[w0, w1]`` (ns) by span: each gap
    between the device records ``dev`` (``(start, end, name)``, ns) is put
    down to the innermost of the :class:`~fast_tpu_torch.utils.profiling.
    Span` records ``spans`` that holds its midpoint (the shortest of them,
    as :func:`perfbench.tracing.idle_by_host` names a gap), or to
    ``outside`` where none does."""
    out = tracing.idle_by_host(
        [(s / 1e3, e / 1e3, n) for s, e, n in dev],
        [(r.start / 1e3, r.end / 1e3, r.name) for r in spans],
        w0 / 1e3, w1 / 1e3)
    return {("outside" if k == "host" else k): v for k, v in out.items()}


@contextlib.contextmanager
def cuda_trace():
    """``torch.profiler`` on the card over the block, CUDA activity alone,
    warmed up as ``perfbench/tracing.py`` warms it. Yields a dict that
    after the block holds ``dev`` (the device records inside it, as
    ``(start, end, name)`` in ns, the spans' marks on the device's
    timeline left out), ``w0``, ``w1`` (the block's bounds on the spans'
    clock), ``window_s`` (its host seconds) and ``fast_busy`` (device
    records named ``fast.*`` that are no user annotation: spans that the
    benchmark's tracing would count as work)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from fast_tpu_torch.utils.profiling import clock_ns

    out = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(8):
            torch.zeros(1024, device="cuda")
        torch.cuda.synchronize()
        prof.step()
        t0, out["w0"] = time.perf_counter(), clock_ns()
        yield out
        torch.cuda.synchronize()
        out["window_s"] = time.perf_counter() - t0
        out["w1"] = clock_ns()
    dev, fast_busy = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name, s = e.name(), e.start_ns()
        if e.is_user_annotation():
            continue
        fast_busy += name.startswith("fast.")
        if out["w0"] <= s <= out["w1"]:
            dev.append((s, s + e.duration_ns(), name))
    out["dev"], out["fast_busy"] = dev, fast_busy


def totals_delta(after, before):
    """The span totals ``after`` less those ``before``, for the names that
    closed in between."""
    out = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
           for k, v in after.items()}
    return {k: v for k, v in out.items() if v["count"]}


def add_totals(into, more):
    for k, v in more.items():
        t = into.setdefault(k, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        for f in t:
            t[f] += v[f]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3_141_592_653)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out")
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_span_window: no card", file=sys.stderr)
        return 2
    from torch_variants import card

    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import _build
    from fast_tpu_torch.utils.profiling import StageTimer

    _build.build_all(list(LIBRARIES))
    spec = harness.Spec()
    w = spec.cell(a.workload)
    traffic = spec.traffic(w["traffic"])
    if "threads" in traffic:
        torch.set_num_threads(int(traffic["threads"]))
    params = harness.run_params(spec.config(w["config"]), traffic)
    params["SEED"] = a.seed
    sim = Fast(harness.point_params(params, traffic, 0), device="cuda")
    sim.set_seed(a.seed + (1 << 40))
    sim.run()
    torch.cuda.synchronize()
    head = {"cell": a.workload, "card": card(),
            "torch": torch.__version__}
    lines = []

    def window(k, traced):
        seed = a.seed + (k + 1) * 1_000_003
        points = []  # a sweep's (timings, totals, init seconds) per point

        def one(i):
            if harness.point(traffic, i) is None:
                s = sim
                s.set_seed(seed + i)
            else:
                t = time.perf_counter()
                s = Fast(dict(harness.point_params(params, traffic, i),
                              SEED=seed + i), device="cuda")
                points.append((s.timings, s.profile.totals,
                               time.perf_counter() - t))
            s.run()

        before = {k: dict(v) for k, v in sim.profile.totals.items()}
        if traced:
            with cuda_trace() as tr, StageTimer.recording() as recs:
                win = harness.closed_loop(one, a.seconds)
        else:
            win = harness.closed_loop(one, a.seconds)
        if points:
            tot = {}
            for _, t, _ in points:
                add_totals(tot, t)
        else:
            tot = totals_delta(sim.profile.totals, before)
        n = len(win.runs)
        walls = [e - s for s, e, _ in win.runs]
        line = dict(head, window=k, traced=traced, runs=n, ok=win.ok,
                    rate=win.rate(int(params["NITER"])),
                    mean_run_ms=1e3 * statistics.fmean(walls),
                    run_p90_ms=win.percentile_ms(90))
        for m, name in PER_RUN.items():
            if name in tot:
                line[m] = 1e3 * tot[name]["total_s"] / n
        line["enqueue_per_run"] = tot.get("fast.enqueue", {}).get(
            "count", 0) / n
        if not points:  # a sweep's window holds each point's Fast() too
            line["run_closure"] = line["run_ms"] / line["mean_run_ms"] - 1
        if points:
            line["point_psd_s"] = statistics.fmean(
                t["powerspec"] for t, _, _ in points)
            line["point_setup_s"] = statistics.fmean(
                s for _, _, s in points)
        line["self_ms"] = {k: 1e3 * v["self_s"] / n for k, v in tot.items()}
        if traced:
            # summed as the benchmark sums them: one stream, no overlap
            busy = sum(e - s for s, e, _ in tr["dev"]) / 1e9
            parts = idle_by_span(tr["dev"], recs, tr["w0"], tr["w1"])
            idle = tr["window_s"] - busy
            line.update(busy_s=busy, window_s=tr["window_s"], idle_s=idle,
                        idle_pct=100 * idle / tr["window_s"],
                        idle_by_span=parts,
                        idle_closure=sum(parts.values()) / idle - 1,
                        fast_busy=tr["fast_busy"], spans=len(recs))
        print(json.dumps(line), flush=True)
        lines.append(line)

    for k in range(a.turns):
        for traced in ((False, True) if k % 2 == 0 else (True, False)):
            window(2 * k + traced, traced)

    # each span's stamps against its own record in a CPU and CUDA trace,
    # over OFFSET_RUNS runs (a sweep's each with its point's Fast())
    from torch.profiler import ProfilerActivity, profile
    with StageTimer.recording() as recs:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(OFFSET_RUNS):
                s = sim
                if harness.point(traffic, i) is not None:
                    s = Fast(harness.point_params(params, traffic, i),
                             device="cuda")
                s.run()
            torch.cuda.synchronize()
    marks, on_device = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if not name.startswith("fast."):
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            key = "annotation" if e.is_user_annotation() else "work"
            on_device[key] = on_device.get(key, 0) + 1
        else:
            marks.setdefault(name, []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    offs = {}  # name: [(offset at the start, at the end), us]
    for r in recs:
        rs, re_ = min(marks.get(r.name, [(0, 0)]),
                      key=lambda m: abs(m[0] - r.start))
        offs.setdefault(r.name, []).append(
            ((rs - r.start) / 1e3, (r.end - re_) / 1e3))
    every = [max(map(abs, o)) for v in offs.values() for o in v]
    line = dict(head, offset_us_median=statistics.median(every),
                offset_us_max=max(every), spans=len(recs),
                offset_us_by_span={k: [statistics.median(o[0] for o in v),
                                       statistics.median(o[1] for o in v),
                                       max(max(map(abs, o)) for o in v)]
                                   for k, v in offs.items()},
                fast_on_device=on_device)
    print(json.dumps(line), flush=True)
    lines.append(line)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        with open(a.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
