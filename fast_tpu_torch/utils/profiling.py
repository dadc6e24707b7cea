"""Spans of the program's work, stage timing and profiler traces.

Every engine stage records wall time into ``sim.timings``. A stage that
ran work on a CUDA device synchronises it at the stage end, so the time
covers the device work and not only its enqueueing. The run path marks
its sections with spans, which never synchronise (:class:`StageTimer`).
:func:`trace` records a ``torch.profiler`` trace of any region
(Chrome/TensorBoard format, which Perfetto opens), :func:`annotate` names
a region in it, and :func:`device_breakdown` sums one call's device time
by kernel.
"""

import collections
import contextlib
import itertools
import time

import torch
from torch.autograd import profiler as _profiler

#: The prefix of the program's span names (``fast.run``, ``fast.powerspec``
#: ...) in :attr:`StageTimer.totals`, in the records and in profiler traces.
PREFIX = "fast."

#: The clock of the spans' stamps, in ns: the one ``torch.profiler`` stamps
#: its records with (``kineto_results.events()``' ``start_ns()``, the Unix
#: epoch's), so a span and the CUDA records of a trace of the same window
#: compare with no host trace.
clock_ns = time.time_ns

#: One closed span: its ``name``, ``start`` and ``end`` (ns, :data:`clock_ns`),
#: the ``id`` of its ``parent`` span (None at the root), and ``run``, the seed
#: of the ``run()`` it belongs to (None outside a run).
Span = collections.namedtuple("Span", "id name start end parent run")

_ids = itertools.count()


class _Open:
    """A span while it is open: a context manager of one use."""

    __slots__ = ("timer", "name", "run", "id", "parent", "child", "start",
                 "marker")

    def __init__(self, timer, name, run):
        self.timer, self.name, self.run = timer, name, run

    def __enter__(self):
        stack = self.timer._open
        self.parent = parent = stack[-1] if stack else None
        if self.run is None and parent is not None:
            self.run = parent.run
        self.id = next(_ids)
        self.child = 0
        stack.append(self)
        # stamped before the marker opens and after it closes: its record
        # lies inside the span, nearer the stamps than the other way round
        self.start = clock_ns()
        self.marker = None
        if _profiler._is_profiler_enabled:  # only while a profiler traces
            self.marker = _profiler.record_function(self.name)
            self.marker.__enter__()
        return self

    def __exit__(self, kind, value, tb):
        if self.marker is not None:
            self.marker.__exit__(kind, value, tb)
        end = clock_ns()
        timer = self.timer
        timer._open.pop()
        if kind is StopIteration:  # an exhausted iterator's last next()
            return
        d = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child += d
        t = timer.totals.get(self.name)
        if t is None:
            t = timer.totals[self.name] = {"count": 0, "total_s": 0.0,
                                           "self_s": 0.0}
        t["count"] += 1
        t["total_s"] += d / 1e9
        t["self_s"] += (d - self.child) / 1e9
        sink = StageTimer._sink
        if sink is not None:
            sink.append(Span(self.id, self.name, self.start, end,
                             None if parent is None else parent.id,
                             self.run))


class StageTimer:
    """The program's spans, and the wall time of its set-up stages.

    :meth:`span` marks a section of the run path and never synchronises;
    :meth:`stage` is a span around a set-up stage that synchronises the
    card at its end and adds its seconds to ``timings[name]``. Every span
    adds to ``totals["fast.<name>"]``: ``count``, ``total_s`` and
    ``self_s``, its seconds less those its child spans cover. While a
    ``torch.profiler`` is active each span also opens
    ``record_function("fast.<name>")``, and inside :meth:`recording` each
    closed span is kept as a :class:`Span`.
    """

    #: The open recording's list of spans, shared by every timer: a ``Fast``
    #: built inside the block has no timer before its set-up begins.
    _sink = None

    def __init__(self, device=None):
        self.timings = {}
        self.totals = {}
        self._open = []
        self._sync = device is not None and torch.device(device).type == "cuda"

    def span(self, name, run=None):
        """A span ``fast.<name>`` around the ``with`` block; ``run`` (a
        root's seed) is inherited from the enclosing span where not given.
        A span left by ``StopIteration`` (an exhausted iterator's last
        ``next()``) is not counted: its time stays its parent's."""
        return _Open(self, PREFIX + name, run)

    @contextlib.contextmanager
    def stage(self, name):
        with self.span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self._sync:
                    torch.cuda.synchronize()
                self.timings[name] = self.timings.get(name, 0.0) + (
                    time.perf_counter() - t0)

    @classmethod
    @contextlib.contextmanager
    def recording(cls):
        """Keep every span that closes in the block, of every timer in the
        process; yields the list they are appended to, and keeps none
        after the block. Recordings do not nest."""
        if cls._sink is not None:
            raise RuntimeError("a span recording is already open")
        cls._sink = records = []
        try:
            yield records
        finally:
            cls._sink = None

    def __repr__(self):
        lines = [f"  {k}: {v * 1e3:.1f} ms" for k, v in self.timings.items()]
        return "StageTimer(\n" + "\n".join(lines) + "\n)"


@contextlib.contextmanager
def trace(logdir):
    """``torch.profiler`` trace of the block, written into ``logdir`` as
    ``<worker>.<time>.pt.trace.json`` (``tensorboard_trace_handler``; open
    in TensorBoard or Perfetto): CPU activity, and CUDA activity where a
    card is present."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


@contextlib.contextmanager
def annotate(name):
    """Named region visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield


def device_breakdown(fn):
    """Run ``fn()`` once under ``torch.profiler`` on a CUDA device.

    Returns ``(wall, busy, per_kernel)``: the host seconds from the call
    to the device's end, the seconds of device work (the sum of the
    kernel, copy and fill durations the profiler recorded; the run
    queues them on one stream, so they do not overlap) and ``{name:
    seconds}`` of that work by name, the largest first. A few small fills
    run first inside the trace: the profiler can lose the records of the
    first kernels launched after it starts (seen on an H100 with torch
    2.11: up to three launches of tens of ms missing from a run's sum).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.zeros(1024, device="cuda")
        torch.cuda.synchronize()
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
