"""What a cell is, found by name: the cell's entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness check
(``checks/<cell>.json``) and its metrics, each read by
``metrics/<metric>.py``. Adding a configuration, a mix, a cell or a
metric adds files and entries; nothing here names one.

The closed loop of the window lives here too: one caller, ``run()`` after
``run()``, each waited for; in a sweep (a mix with ``points``) each run
builds its own ``Fast`` at the next point first.
"""

import importlib.util
import json
import math
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: The modules, by top-level name, that no run may have loaded.
FORBIDDEN = ("jax", "jaxlib", "flax", "fast_tpu")


class Spec:
    """``BENCHMARK.json`` and the files of the cells it names, under
    ``root`` (the checkout) and ``base`` (the benchmark's folder)."""

    def __init__(self, root=ROOT, base=HERE):
        self.root, self.base = Path(root), Path(base)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def _json(self, kind, name):
        return json.loads((self.base / kind / f"{name}.json").read_text())

    def traffic(self, name):
        return self._json("traffic", name)

    def check(self, cell):
        return self._json("checks", cell)

    def metrics(self, cell, trace):
        """The entries of the metrics a run of ``cell`` reports: its
        end-to-end ones with ``trace`` 0, its per-layer ones with 1."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric):
        """The ``read(record)`` function of ``metrics/<metric>.py``."""
        path = self.base / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _sized(rule, N):
    return int(rule["product"] // N ** rule["grid_power"])


def run_params(config, traffic):
    """The parameter dict of a run: the configuration's ``params`` (the
    string "inf" read as infinity), the mix's ``params``, and NITER and
    NCHUNKS from the mix's sizing rules at the configuration's NPXLS
    (where the mix gives rules; else its ``params`` hold them)."""
    p = {k: (math.inf if v == "inf" else v)
         for k, v in config["params"].items()}
    p.update(traffic["params"])
    if "niter" not in traffic:
        return p
    N = int(p["NPXLS"])
    niter = _sized(traffic["niter"], N)
    if "chunks" in traffic:
        nchunks = int(traffic["chunks"])
    else:
        chunk = min(int(traffic["chunk"]["max"]),
                    _sized(traffic["chunk"], N))
        nchunks = max(1, niter // chunk)
    p.update(NITER=niter, NCHUNKS=nchunks)
    return p


def point(traffic, i):
    """The index of the parameter point of run ``i`` of a sweep (the mix's
    ``points`` in turn), or None for a mix that keeps one ``Fast``."""
    points = traffic.get("points")
    return i % len(points) if points else None


def point_params(params, traffic, i):
    """The parameters of run ``i``: ``params`` with the keys of its
    point of a sweep."""
    k = point(traffic, i)
    return params if k is None else dict(params, **traffic["points"][k])


class Window:
    """The runs of a closed loop: ``runs`` is a list of ``(start, end,
    ok)`` clock readings; ``start`` and ``end`` bound the window."""

    def __init__(self, start, end, runs):
        self.start, self.end, self.runs = start, end, runs

    @property
    def seconds(self):
        return self.end - self.start

    @property
    def ok(self):
        return sum(1 for r in self.runs if r[2])

    def rate(self, work_per_run):
        """All the work of the completed runs over all the window's time."""
        return self.ok * work_per_run / self.seconds

    def percentile_ms(self, q):
        """The ``q``-th percentile (nearest rank) of every run's wall time,
        from its call to its return, in ms."""
        d = sorted(1e3 * (e - s) for s, e, _ in self.runs)
        return d[max(0, math.ceil(q / 100 * len(d)) - 1)]


def closed_loop(call, seconds, clock=time.perf_counter, on_run=None):
    """Call ``call(i)`` for i = 0, 1, ... until the first call that
    returns ``seconds`` or more after the first began; a call that raises
    counts as failed. ``on_run(i, value_or_exception, ok)`` sees each."""
    runs = []
    start = clock()
    i = 0
    while True:
        s = clock()
        try:
            value, ok = call(i), True
        except Exception as exc:  # a failed run counts in `failed`
            value, ok = exc, False
        e = clock()
        runs.append((s, e, ok))
        if on_run is not None:
            on_run(i, value, ok)
        i += 1
        if e - start >= seconds:
            return Window(start, e, runs)


def forbidden_modules(modules):
    """The loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
