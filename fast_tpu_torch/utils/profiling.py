"""Stage timing.

Every engine stage records wall time into ``sim.timings``. A stage that
ran work on a CUDA device synchronises it at the stage end, so the time
covers the device work and not only its enqueueing.
"""

import contextlib
import time

import torch


class StageTimer:
    """Accumulates named wall-clock stage timings."""

    def __init__(self, device=None):
        self.timings = {}
        self._sync = device is not None and torch.device(device).type == "cuda"

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0)

    def __repr__(self):
        lines = [f"  {k}: {v * 1e3:.1f} ms" for k, v in self.timings.items()]
        return "StageTimer(\n" + "\n".join(lines) + "\n)"


def device_breakdown(fn):
    """Run ``fn()`` once under ``torch.profiler`` on a CUDA device.

    Returns ``(wall, busy, per_kernel)``: the host seconds from the call
    to the device's end, the seconds of device work (the sum of the
    kernel, copy and fill durations the profiler recorded; the run
    queues them on one stream, so they do not overlap) and ``{name:
    seconds}`` of that work by name, the largest first.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            per[e.name] = per.get(e.name, 0.0) + us / 1e6
    per = dict(sorted(per.items(), key=lambda kv: -kv[1]))
    return wall, sum(per.values()), per
