"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cards the cell asks
for. Set-up (the kernels' build on a checkout's first run, ``Fast()`` of
the cell's configuration and one warm ``run()`` of its shapes) counts as
``setup_s``; then a closed loop of one caller calls ``run()`` with the
seed advanced by one until the first run that returns ``--seconds`` after
the window began (in a sweep, each run at the next parameter point of its
own new ``Fast``). ``--trace 1`` runs the window under ``torch.profiler``
and reports the cell's per-layer metrics instead of its end-to-end ones.
After the window the outputs of runs drawn from the seed are judged
against the plain reference (``perfbench/check.py``). The last line of
standard output is the result's JSON object; the numbers compared, each
with its limit, are the last lines of standard error.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import check, harness, tracing  # noqa: E402
from perfbench.reference.setup.host import HostSetup  # noqa: E402

#: The port's four kernel libraries, built at once on a checkout's first
#: run (one nvcc each) and loaded from its build directory after.
LIBRARIES = ("synth_detect", "colfac_detect", "colfac_split", "ar_flow")
#: Seconds of runs after a traced window, traced on the host too, whose
#: records name the idle gaps of ``breakdown``.
NAMED_SECONDS = 3.0


class NoChip(RuntimeError):
    pass


def _shape(setup, params):
    """The run's sizes, from the reference's own set-up of its
    configuration."""
    return {"N": setup.N, "P": setup.npup, "L": len(setup.h),
            "precision": params["PRECISION"],
            "mixed": params["MC_NOISE"] == "mixed",
            "boiling": setup.temporal and bool((setup.alpha < 1).any())}


def _short(name):
    """A profiler name without its trailing argument list, at most 160
    letters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                if name[i - 1] != " ":  # "Memcpy HtoD (Pageable -> ...)"
                    name = name[:i]
                break
    return name[:160]


def drive(cell, seed, seconds, trace, *, spec=None, device="cuda",
          t_start=None, log=None):
    """One run of ``cell``; returns the result dict (``checks`` last).

    On ``device="cuda"`` this needs as many cards as the cell asks for
    (:class:`NoChip` otherwise) and builds the kernel libraries first.
    """
    import torch

    spec = spec or harness.Spec()
    t_start = time.perf_counter() if t_start is None else t_start
    stamps = {"import": time.perf_counter() - t_start}
    w = spec.cell(cell)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoChip("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(w["chips"]):
            raise NoChip(f"{torch.cuda.device_count()} cards, the cell asks "
                         f"for {w['chips']}")
        from fast_tpu_torch.ops import _build
        built = _build.build_all(list(LIBRARIES))
        stamps["build"] = sum(b.seconds for b in built.values())
    from fast_tpu_torch import Fast

    traffic = spec.traffic(w["traffic"])
    if "threads" in traffic:  # the host's intra-op threads the mix fixes
        torch.set_num_threads(int(traffic["threads"]))
    params = harness.run_params(spec.config(w["config"]), traffic)
    params["SEED"] = int(seed)
    t0 = time.perf_counter()
    sim = Fast(harness.point_params(params, traffic, 0), device=device)
    timings = dict(sim.timings)
    stamps["Fast"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.set_seed(int(seed) + (1 << 40))
    sim.run()
    if device == "cuda":
        torch.cuda.synchronize()
    stamps["warm_run"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start

    results, inits = {}, []

    def span(name):
        return (torch.profiler.record_function(name) if trace
                else contextlib.nullcontext())

    def one(i):
        with span("perfbench.between_runs"):
            if harness.point(traffic, i) is None:
                s = sim
                s.set_seed(int(seed) + i)
            else:  # a sweep: this point's own Fast
                t = time.perf_counter()
                s = Fast(dict(harness.point_params(params, traffic, i),
                              SEED=int(seed) + i), device=device)
                inits.append(time.perf_counter() - t)
        with span("perfbench.run"):
            return s.run()

    def keep(i, value, ok):
        if ok:
            results[i] = value
        elif log is not None:  # a failed run is counted and its cause shown
            traceback.print_exception(value, file=log)

    t0 = time.perf_counter()
    profiler = tracing.profiled() if trace else contextlib.nullcontext({})
    with profiler as traced:
        window = harness.closed_loop(one, seconds, on_run=keep)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    if trace:  # a short stretch after the window names the idle gaps
        n = len(window.runs)
        with tracing.profiled(host=True) as named:
            harness.closed_loop(lambda i: one(n + i), NAMED_SECONDS)
        traced["idle_by_host"] = named["idle_by_host"]
    stamps["window_and_trace"] = time.perf_counter() - t0
    work = int(params["NITER"])

    t0 = time.perf_counter()
    setups = {}

    def setup_of(r):
        """The reference's set-up of run ``r``'s parameters."""
        k = harness.point(traffic, r)
        if k not in setups:
            setups[k] = HostSetup(harness.point_params(params, traffic, r))
        return setups[k]

    record = {"cell": cell, "setup_s": setup_s, "timings": timings,
              "window": window, "work_per_run": work,
              "inits": inits[:len(window.runs)],
              "unit": traffic["unit"],
              "shape": _shape(setup_of(0), params),
              "trace": traced or None}
    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the judged runs' outputs to the host, then the program's state freed
    check_spec = spec.check(cell)
    picks = check.sample(check_spec["sample"], seed, len(results),
                         int(params["NCHUNKS"]), work,
                         bool(params["TEMPORAL"]))
    ok_runs = sorted(results)
    judged = []
    for r, p in picks:
        i = ok_runs[r]
        res = results[i]
        # the reported moments first: reading the series moves it to the
        # host, and the moments are then worked out there
        mean, si = res.avg_power_W, res.scintillation_index
        judged.append((setup_of(i), harness.point_params(params, traffic, i),
                       int(seed) + i, p, res.power, mean, si))
    del sim, results
    if device == "cuda":
        torch.cuda.empty_cache()
    failed = len(window.runs) - window.ok
    correct, numbers = check.judge(judged, check_spec["limits"],
                                   device=device, failed=failed)
    stamps["check"] = time.perf_counter() - t0
    if log is not None:
        print("perfbench: seconds " + json.dumps(stamps) + " program "
              + json.dumps(timings), file=log)

    out = {"correct": bool(correct), "attempted": len(window.runs),
           "failed": failed, "metrics": metrics,
           "device": _device(device, int(w["chips"]), peak, traced)}
    if traced:
        out["breakdown"] = {
            "device_ops": [[_short(k), v] for k, v in
                           list(traced["per_kernel"].items())[:10]],
            "idle_gaps": [[k, v] for k, v in
                          list(traced["idle_by_host"].items())[:10]]}
    # a number that could not be read (no completed run) prints as null
    out["checks"] = {k: {"value": v if math.isfinite(v) else None,
                         "limit": lim} for k, (v, lim) in numbers.items()}
    return out


def _device(device, chips, peak, traced):
    import torch
    d = {"platform": "gpu" if device == "cuda" else device,
         "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                  else "cpu"),
         "count": chips, "memory_peak_bytes": int(peak)}
    if traced:
        d["busy_s"] = traced["busy_s"]
        d["window_s"] = traced["window_s"]
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        out = drive(a.workload, a.seed, a.seconds, bool(a.trace),
                    t_start=_T_START, log=sys.stderr)
    except NoChip as exc:
        print(f"perfbench: no chip for this cell: {exc}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct {out['correct']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
