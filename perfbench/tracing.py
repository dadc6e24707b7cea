"""The traced run's reading of the device, by the method of the port's
``utils/profiling.device_breakdown``: ``torch.profiler`` on the card, a
few small fills while it warms up (the profiler can lose the records of
the first kernels after it starts, and a warm-up step's records are
dropped), then the device work summed from the CUDA records.

The window itself is traced for CUDA activity alone, which costs the host
next to nothing, so its busy and idle time are the untraced run's. Host
activity is traced only over a short stretch of runs after the window, to
name what the host was doing under each idle gap. The harness names its
own spans ``perfbench.*`` (``record_function``): ``perfbench.run`` around
each ``run()``, ``perfbench.between_runs`` around the loop's own work
between them (a sweep's ``Fast()`` in it).
"""

import contextlib
import time


@contextlib.contextmanager
def profiled(host=False):
    """Profile the block on the card; ``host`` traces host activity too.
    Yields a dict that, after the block, holds ``busy_s`` (device seconds
    inside the block, its records summed: one stream, so they do not
    overlap), ``window_s`` (the block's host seconds), ``per_kernel``
    ({name: seconds}, the largest first) and, with ``host``,
    ``idle_by_host`` ({host activity: seconds of device idle under it})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(8):
            torch.zeros(1024, device="cuda")
        torch.cuda.synchronize()
        prof.step()  # the records from here on are kept: the block's alone
        with torch.profiler.record_function("perfbench.window"):
            t0 = time.perf_counter()
            yield out
            torch.cuda.synchronize()
            out["window_s"] = time.perf_counter() - t0
    # the raw records: FunctionEvent objects take minutes for a window of
    # hundreds of thousands of them
    events = prof.profiler.kineto_results.events()
    cuda = DeviceType.CUDA
    dev, host_recs = [], []
    for e in events:
        name = e.name()
        s = e.start_ns() / 1e3
        t = s + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            # the spans' own marks on the device's timeline are no work
            if (not name.startswith("perfbench.")
                    and not e.is_user_annotation()):
                dev.append((s, t, name))
        elif (name != "perfbench.window"
              and not name.startswith("ProfilerStep") and t > s):
            host_recs.append((s, t, name))
    per = {}
    for s, e, name in dev:
        per[name] = per.get(name, 0.0) + (e - s) / 1e6
    out["per_kernel"] = dict(sorted(per.items(), key=lambda kv: -kv[1]))
    out["busy_s"] = sum(per.values())
    if host:
        win = next(e for e in events if e.name() == "perfbench.window"
                   and e.device_type() != cuda)
        w0 = win.start_ns() / 1e3
        w1 = w0 + win.duration_ns() / 1e3
        out["idle_by_host"] = idle_by_host(
            [d for d in dev if w0 <= d[0] <= w1], host_recs, w0, w1)
    return out


def idle_by_host(dev, host, w0, w1):
    """Seconds of device idle inside ``[w0, w1]`` (us) by what the host was
    doing: each gap between device records is named by the shortest host
    record that holds its midpoint ("host" where none does).
    ``dev`` and ``host`` are lists of ``(start, end, name)`` in us."""
    gaps = []
    t = w0
    for s, e, _ in sorted(dev):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(host)
    out = {}
    active, i = [], 0
    for a, b in gaps:  # in rising order, so a sweep over the host records
        mid = (a + b) / 2
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = (min(active, key=lambda h: h[1] - h[0])[2] if active
                else "host")
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
