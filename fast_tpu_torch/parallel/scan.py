"""Parameter scans: a batch of link configurations x Monte Carlo.

The port of ``fast_tpu.parallel.scan`` on one device. The reference's
orbit sweep builds N independent simulations and runs them serially
(``fast/complete_orbit_simulation.py:217-228``); the JAX package shards
configurations over a ``scan`` mesh axis and realizations over ``mc``.
Here the mesh is ``(1, 1)``: one device runs every configuration.

* iid: each configuration's chunks go through the engine's own chunk loop
  (``chunk_couplings``, with the configuration's tables), from seeds drawn
  in turn from the scan's seed.
* temporal AR: every configuration's series in one K6 call
  (:func:`fast_tpu_torch.ops.ar_flow.ar_flow_fused_batch`, one launch per
  4096 steps) for float32 with ``SYNTH != 'fft'``: the kernel on a CUDA
  device, its plain version on the CPU; the stock-op recursion with the
  exact ``ift2``, series by series, for ``SYNTH='fft'`` or float64. Both
  draw one Philox stream, series s on the state rows ``s * L ..``, so the
  two routes give the same series from one seed.
* temporal screens: each configuration's frozen-flow route.

A scan of one configuration gives that configuration's ``run()``: its
seeds are the ones ``run()`` draws from the same seed.
"""

import numpy as np
import torch

from ..ops import ar_flow
from ..ops.rng import draw_seed, make_generator


class ScanMesh:
    """A ``(scan, mc)`` grid of devices: ``devices`` is a numpy array of
    ``torch.device`` of shape ``(n_scan, n_mc)``."""

    def __init__(self, devices):
        self.devices = devices

    def __repr__(self):
        return f"ScanMesh({self.devices.tolist()})"


def make_scan_mesh(n_scan, n_mc, devices=None):
    """2-D ``(scan, mc)`` device mesh; ``devices`` defaults to the CUDA
    device. Only ``(1, 1)`` is taken for now."""
    if (n_scan, n_mc) != (1, 1):
        raise NotImplementedError(
            f"a ({n_scan}, {n_mc}) scan mesh needs the multi-device slice of "
            f"the port (ROADMAP.md queue 1, item 10); fast_tpu_torch scans "
            f"run on a (1, 1) mesh, one device")
    if devices is None:
        devices = ["cuda"]
    grid = np.empty(1, dtype=object)
    grid[0] = torch.device(devices[0])
    return ScanMesh(grid.reshape(1, 1))


def _same_device(a, b):
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _check_mesh(sims, mesh):
    """Raise unless every sim runs on the device of ``mesh`` (by default a
    (1, 1) mesh on the first sim's device)."""
    if mesh is None:
        return
    if mesh.devices.shape != (1, 1):
        raise NotImplementedError(
            "fast_tpu_torch scans run on a (1, 1) mesh (ROADMAP.md queue 1, "
            "item 10)")
    dev = mesh.devices[0, 0]
    for s in sims:
        if not _same_device(s.device, dev):
            raise ValueError(f"the mesh's device is {dev}, a sim runs on "
                             f"{s.device}")


def _seeds(sims, seed):
    """Each sim's ``(log-amplitude, screens)`` seeds, drawn in turn from
    the scan's seed (the first sim's ``SEED`` by default): the first
    sim's are those of its own ``run()``."""
    gen = make_generator(seed if seed is not None else sims[0].seed)
    return [(draw_seed(gen), draw_seed(gen)) for _ in sims]


def run_scan_sharded(sims, mesh=None, seed=None):
    """Run a batch of same-geometry simulations over a ``(scan, mc)`` mesh.

    Supported synthesis paths: ``fft`` / ``matmul`` / ``colfac`` and the
    kernels ``pallas_fused`` (K2) / ``pallas_colfac`` (K1 up to a 128 px
    pupil, K3 above), each configuration with its own tables. Temporal
    configurations (AR and screens mode) run one ordered series per
    configuration; the AR series run together in K6.

    Args:
        sims: list of initialised :class:`fast_tpu_torch.Fast` objects
            sharing grid geometry (same NPXLS/DX/pupil/NITER; PSDs may
            differ — e.g. one per orbit sample, :func:`fast_tpu_torch.sweep.
            build_sweep`), on the mesh's device.
        mesh: mesh from :func:`make_scan_mesh`; default, a (1, 1) mesh on
            the sims' device.
        seed: overrides the first sim's seed.

    Returns:
        list of :class:`FastResult`, one per sim (also stored on each sim).
    """
    _check_mesh(sims, mesh)
    s0 = sims[0]
    if s0.temporal:
        if s0._temporal_synth == "ar":
            return _run_scan_sharded_temporal_ar(sims, seed)
        return _run_scan_sharded_temporal_screens(sims, seed)
    if s0._synth == "pallas":
        # 'auto' never picks the screens-out kernel in this package
        raise NotImplementedError(
            "scan sharding supports SYNTH 'fft'|'matmul'|'colfac'|"
            "'pallas_fused'|'pallas_colfac'; the screens-out 'pallas' "
            "kernel is not scan-shardable — use a fused kernel "
            "(or 'colfac')")
    # the JAX scan's checks of the mesh's dimensions need more than one
    # device; on a (1, 1) mesh every Fast already passes them
    for s in sims[1:]:
        if (s.Npxls, s.Npxls_pup, s.Niter, s.Nchunks) != (
                s0.Npxls, s0.Npxls_pup, s0.Niter, s0.Nchunks):
            raise ValueError("sims must share grid geometry and NITER")
        if (s._synth, s.subharmonics) != (s0._synth, s0.subharmonics):
            raise ValueError("sims must share SYNTH and SUBHARM settings")
    return [s._run(seeds) for s, seeds in zip(sims, _seeds(sims, seed))]


def _check_temporal(sims, what, same, msg):
    """The argument checks both temporal scans share."""
    s0 = sims[0]
    for s in sims[1:]:
        if same(s) != same(s0):
            raise ValueError(msg)
        if s._temporal_synth != what:
            raise ValueError(f"sims must all use TEMPORAL_SYNTH='{what}'")


def _run_scan_sharded_temporal_screens(sims, seed=None):
    """Independent frozen-flow screens-mode series, one per configuration:
    each sim's screens route from its own seeds."""
    _check_temporal(
        sims, "screens",
        lambda s: (s.Npxls, s.Npxls_pup, s.Niter, s.Nchunks),
        "sims must share grid geometry, NITER and NCHUNKS (screens mode: "
        "pass explicit NPXLS so the grown grids match)")
    return [s._run(seeds) for s, seeds in zip(sims, _seeds(sims, seed))]


def _run_scan_sharded_temporal_ar(sims, seed=None):
    """Independent AR frozen-flow series, one per configuration (an orbit
    pass of temporal fading series): every series in one K6 call on the
    kernel route, or series by series on the exact route."""
    s0 = sims[0]
    _check_temporal(sims, "ar",
                    lambda s: (s.Npxls, s.Npxls_pup, s.Niter),
                    "sims must share grid geometry and NITER")
    boiling = bool(np.any(np.asarray(s0._ar_alpha) < 1.0))
    for s in sims[1:]:
        if bool(np.any(np.asarray(s._ar_alpha) < 1.0)) != boiling:
            raise ValueError("sims must agree on boiling (alpha < 1)")
        if s._ar_route != s0._ar_route:
            raise ValueError("sims must share the AR route (SYNTH='fft' or "
                             "DTYPE='float64' against the kernel)")

    seeds = _seeds(sims, seed)
    starts = [s._ar_start(scr) for s, (_, scr) in zip(sims, seeds)]
    # one noise stream for the batch, series s on the rows s * L ..
    seed_noise = starts[0][1]
    if s0._ar_route == "fft":
        return [s._finish(la, s._ar_fft_chunks(a, seed_noise, series=i))
                for i, (s, (la, _), (a, _)) in enumerate(zip(sims, seeds,
                                                              starts))]
    T = [s.tables for s in sims]
    c, _ = ar_flow.ar_flow_fused_batch(
        seed_noise, torch.stack([a for a, _ in starts]),
        torch.stack([t["ph"] for t in T]),
        torch.stack([t["ns"] for t in T]) if boiling else None,
        T[0]["W"], torch.stack([t["pm"] for t in T]), s0.Niter,
        noise=s0.params["TEMPORAL_NOISE"])
    results = []
    for i, (s, t, (la, _)) in enumerate(zip(sims, T, seeds)):
        scale = float(t["dx"]) ** 2 / float(t["norm"])
        results.append(s._finish(
            la, [torch.complex(c[:, i, 0], c[:, i, 1]) * scale]))
    return results
