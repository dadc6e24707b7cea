"""Ranks on one host, and the port's twin of
``__graft_entry__.dryrun_multichip``.

* :func:`spawn` starts n processes (the ``spawn`` start method, so that a
  parent that has initialised CUDA may start them), joins them in one
  gloo world on ``localhost``, calls a function of this package's on
  each, and returns each rank's value. A rank that raises or exits
  non-zero, or a world that does not finish in time, fails the call after
  every process is stopped.
* :func:`run_cases` is such a function: it drives the production runners
  (:func:`~fast_tpu_torch.parallel.run_sharded`,
  :func:`~fast_tpu_torch.parallel.run_scan_sharded`,
  :func:`~fast_tpu_torch.parallel.sharded_moments`) through a list of
  cases, writes each rank's series to a directory and returns each case's
  kernel launches, host seconds and expected errors.
* :func:`dryrun_multichip` runs checks 1-4 of the JAX function at its
  sizes over n ranks: iid over ``mc`` with the moments, a ``(scan, mc)``
  scan, a time-sharded AR series and a layer-sharded boiling one. It has
  no wall-clock gate.

Ranks run on the CPU unless ``devices`` places them (ranks may share a
card: the world is gloo).
"""

import multiprocessing
import queue
import socket
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..ops import kernel_wrappers
from .mesh import TIMEOUT

#: Seconds a spawned world may take before it is stopped and the call
#: fails.
WORLD_TIMEOUT = 900


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, devices, args, results):
    """One spawned rank: join the world, run ``fn(devices, *args)``, put
    ``(rank, ok, value or traceback)`` on ``results``."""
    try:
        if torch.device(devices[rank]).type == "cpu":
            # n ranks share the host's cores, and one thread a rank sums
            # as the single-threaded serial run does
            torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=n, timeout=TIMEOUT)
        try:
            value = fn(devices, *args)
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def spawn(fn, n, *args, devices=None, timeout=WORLD_TIMEOUT):
    """Run ``fn(devices, *args)`` on each of ``n`` spawned ranks of a gloo
    world; returns the ranks' values in rank order.

    ``fn`` is a module-level function (it is pickled by name); ``devices``
    gives each rank's device by rank (default: all on the CPU). Raises
    RuntimeError, with the failing rank's traceback, when a rank raises or
    exits non-zero or the world takes more than ``timeout`` seconds; every
    process is stopped first.
    """
    devices = ["cpu"] * n if devices is None else [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"devices names {len(devices)} devices for {n} "
                         f"ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, port, devices, args, results))
             for r in range(n)]
    values = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(values) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"a world of {n} ranks did not finish "
                                   f"within {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in values}
                if dead:
                    raise RuntimeError(f"ranks exited with codes {dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            values[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        codes = {r: p.exitcode for r, p in enumerate(procs)}
        if any(c != 0 for c in codes.values()):
            raise RuntimeError(f"ranks exited with codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
    return [values[r] for r in range(n)]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_sims(spec, device):
    """The sims of a scan case: one per params dict of ``spec["list"]``,
    or an orbit pass (``spec["geometry"]``) or a sweep (``spec["sweep"]``)
    of ``spec["params"]``."""
    from .. import orbit, sweep
    from ..engine import Fast
    if "list" in spec:
        return [Fast(p, device=device) for p in spec["list"]]
    if "geometry" in spec:
        d = orbit.FAST_sat_orbit_from_geometry(spec["params"],
                                               spec["geometry"], device)
        return [d[f"simulation_{i}"]
                for i in range(len(spec["geometry"]["zenith_angles"]))]
    return sweep.build_sweep(spec["params"], spec["sweep"], device=device)


def _case(case, devices, device, timed):
    """Run one case; returns ``{array name: numpy}``. ``timed(fn)`` runs
    each call of a runner."""
    from . import make_mesh, make_scan_mesh, run_scan_sharded, run_sharded
    from . import sharded_moments
    from ..engine import Fast
    kind = case["kind"]
    if kind == "moments":
        with make_mesh(devices=devices) as mesh:
            return {"": timed(lambda: sharded_moments(case["values"], mesh))}
    if kind == "run":
        sim = Fast(case["params"], device=device)
        with make_mesh(devices=devices) as mesh:
            out = {}
            for i in range(case.get("repeat", 1)):
                res = timed(lambda: run_sharded(sim, mesh,
                                                seed=case.get("seed")))
                out[str(i)] = np.asarray(res.power)
            if case.get("moments"):
                n = len(out["0"]) // mesh.size("mc") * mesh.size("mc")
                out["moments"] = sharded_moments(out["0"][:n], mesh)
            return out
    if kind == "scan":
        sims = build_sims(case["sims"], device)
        with make_scan_mesh(*case["shape"], devices=devices) as mesh:
            res = timed(lambda: run_scan_sharded(sims, mesh,
                                                 seed=case.get("seed")))
        return {str(i): np.asarray(r.power) for i, r in enumerate(res)}
    raise ValueError(f"unknown case kind {kind!r}")


def run_cases(devices, cases, outdir):
    """Run ``cases`` on this rank of a spawned world (see :func:`spawn`).

    Each case is a dict with a ``name`` and a ``kind``:

    * ``"run"``: ``run_sharded`` of ``Fast(params)`` on a 1-D mesh of the
      world, ``repeat`` times (default once), with ``seed``; with
      ``moments`` true, ``sharded_moments`` of the first series too;
    * ``"scan"``: ``run_scan_sharded`` of the sims of ``sims`` (see
      :func:`build_sims`) on a ``shape`` mesh, with ``seed``;
    * ``"moments"``: ``sharded_moments(values)`` on a 1-D mesh.

    ``raises``: ``(exception name, text)`` the case must raise, with the
    text in its message. Writes this rank's arrays to
    ``outdir/rank{r}.npz`` under ``"{case}.{array}"``; returns ``{"device",
    "launches": {case: {kernel: n}}, "seconds": {case: s}, "raised": {case:
    message}}``, the launches and host seconds (closed by a synchronize)
    of the case's last runner call.
    """
    rank = dist.get_rank()
    device = torch.device(devices[rank])
    counters = kernel_wrappers()
    arrays, launches, seconds, raised = {}, {}, {}, {}

    def timed(name):
        def run(fn):
            for c in counters.values():
                c.LAUNCHES = 0
            _sync(device)
            t0 = time.perf_counter()
            out = fn()
            _sync(device)
            seconds[name] = time.perf_counter() - t0
            launches[name] = {k: c.LAUNCHES for k, c in counters.items()}
            return out
        return run

    for case in cases:
        name, expect = case["name"], case.get("raises")
        try:
            out = _case(case, devices, device, timed(name))
        except (ValueError, NotImplementedError) as e:
            if expect is None or type(e).__name__ != expect[0] \
                    or expect[1] not in str(e):
                raise
            raised[name] = str(e)
            continue
        if expect is not None:
            raise AssertionError(f"case {name} did not raise {expect}")
        arrays.update({f"{name}.{k}" if k else name: v
                       for k, v in out.items()})
    np.savez(Path(outdir) / f"rank{rank}.npz", **arrays)
    return {"device": str(device), "launches": launches,
            "seconds": seconds, "raised": raised}


def load_arrays(outdir, n):
    """The arrays :func:`run_cases` wrote, one dict a rank."""
    out = []
    for r in range(n):
        with np.load(Path(outdir) / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def mesh_summary(devices, shape):
    """This rank's view of a mesh of ``shape`` (a 1-D ``(n,)`` or a
    ``(scan, mc)`` pair): its axis names, shape, devices and index."""
    from . import make_mesh, make_scan_mesh
    mesh = (make_mesh(shape[0], devices=devices) if len(shape) == 1
            else make_scan_mesh(*shape, devices=devices))
    with mesh:
        return {"axis_names": mesh.axis_names, "shape": mesh.devices.shape,
                "devices": [str(d) for d in mesh.devices.ravel()],
                "index": mesh.index, "backend": mesh.backend}


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def flagship_params(npxls=256, niter=1024, nchunks=1, **overrides):
    """The 256^2 AO-corrected uplink at 1550 nm (``__graft_entry__.py``'s
    flagship), with ``overrides``."""
    from .. import conf, turbulence_models
    h, cn2, w = turbulence_models.HV57_Bufton_profile(4)
    p = dict(conf.DEFAULTS)
    p.update({
        "NPXLS": npxls, "DX": 0.01, "NITER": niter, "NCHUNKS": nchunks,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 1, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def dryrun_cases(n):
    """Checks 1-4 of ``__graft_entry__.dryrun_multichip(n)`` at its sizes
    (32^2 links), as :func:`run_cases` cases."""
    from .. import turbulence_models
    small = dict(npxls=32, DX=0.05, D_GROUND=1.0, DSUBAP=0.25)
    if n % 2 == 0 and n > 2:
        n_scan, n_mc = 2, n // 2
    else:
        n_scan, n_mc = 1, n
    h_b, cn2_b, w_b = turbulence_models.HV57_Bufton_profile(n)
    return [
        {"name": "iid", "kind": "run", "moments": True,
         "params": flagship_params(niter=4 * n, nchunks=2, **small)},
        {"name": "scan", "kind": "scan", "shape": (n_scan, n_mc),
         "sims": {"list": [flagship_params(niter=4 * n_mc, nchunks=1,
                                           ZENITH_ANGLE=z, **small)
                           for z in np.linspace(30, 60, 2 * n_scan)]}},
        {"name": "ar", "kind": "run",
         "params": flagship_params(
             niter=8 * n, nchunks=1, TEMPORAL=True, TEMPORAL_SYNTH="ar",
             TEMPORAL_ALPHA=1, DT=0.001, **small)},
        {"name": "boiling", "kind": "run",
         "params": flagship_params(
             niter=8, nchunks=1, TEMPORAL=True, TEMPORAL_SYNTH="ar",
             TEMPORAL_ALPHA=0.98, DT=0.001, H_TURB=h_b, CN2_TURB=cn2_b,
             WIND_SPD=w_b, WIND_DIR=np.linspace(0.0, 315.0, n), **small)},
    ]


def check_dryrun(arrays, n):
    """What JAX's dry run checks, on the arrays of :func:`dryrun_cases`
    over ``n`` ranks (one dict a rank): every series of the expected length
    and finite, finite moments; besides, every rank holds the same
    series."""
    n_scan, n_mc = dryrun_cases(n)[1]["shape"]
    lengths = {"iid.0": 4 * n, "ar.0": 8 * n, "boiling.0": 8,
               **{f"scan.{i}": 4 * n_mc for i in range(2 * n_scan)}}
    for name, length in lengths.items():
        x = arrays[0][name]
        if x.shape != (length,) or not np.isfinite(x).all():
            raise AssertionError(f"dry run {name}: shape {x.shape}, "
                                 f"expected ({length},), finite")
    if not np.isfinite(arrays[0]["iid.moments"]).all():
        raise AssertionError("dry run: non-finite moments")
    for r, a in enumerate(arrays[1:], 1):
        for k in list(lengths) + ["iid.moments"]:
            if not np.array_equal(a[k], arrays[0][k]):
                raise AssertionError(f"dry run {k}: rank {r} holds other "
                                     f"values than rank 0")


def dryrun_multichip(n, devices=None, timeout=WORLD_TIMEOUT):
    """Run the production sharded runners over ``n`` spawned ranks (the
    CPU by default; ``devices`` places them) on :func:`dryrun_cases` and
    :func:`check_dryrun` them. Returns each rank's report of
    :func:`run_cases`."""
    with tempfile.TemporaryDirectory() as outdir:
        reports = spawn(run_cases, n, dryrun_cases(n), outdir,
                        devices=devices, timeout=timeout)
        check_dryrun(load_arrays(outdir, n), n)
    return reports


if __name__ == "__main__":
    # python -m fast_tpu_torch.parallel.dryrun [n]: n CPU ranks (8)
    import sys
    from fast_tpu_torch.parallel import dryrun
    dryrun.dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    print("dryrun ok")
