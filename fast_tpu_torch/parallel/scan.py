"""Parameter scans: a batch of link configurations x Monte Carlo.

The port of ``fast_tpu.parallel.scan``. The reference's orbit sweep builds
N independent simulations and runs them serially
(``fast/complete_orbit_simulation.py:217-228``); here the configurations
are cut over the ``scan`` axis of a ``(scan, mc)`` mesh
(:class:`~fast_tpu_torch.parallel.mesh.Mesh`) and the realizations over
``mc``. Scan rank i runs the sims ``i * S / n_scan ..``; the series are
gathered over ``mc``, then over ``scan``, so every rank returns every
sim's result.

* iid: each configuration's chunks are cut over ``mc`` as
  :func:`~fast_tpu_torch.parallel.run_sharded` cuts them (the engine's
  chunk loop, ``chunk_couplings``, with the configuration's tables), from
  seeds drawn in turn from the scan's seed.
* temporal AR (an ``(n_scan, 1)`` mesh): every local configuration's
  series in one K6 call (:func:`fast_tpu_torch.ops.ar_flow.
  ar_flow_fused_batch`, one launch per 4096 steps) for float32 with
  ``SYNTH != 'fft'``: the kernel on a CUDA device, its plain version on
  the CPU; the stock-op recursion with the exact ``ift2``, series by
  series, for ``SYNTH='fft'`` or float64. Both draw one Philox stream,
  series s of the scan on the state rows ``s * L ..`` whichever rank runs
  it (K6's ``series0``), so the two routes, and every mesh, give the same
  series from one seed.
* temporal screens (an ``(n_scan, 1)`` mesh): each configuration's
  frozen-flow route.

A scan of one configuration gives that configuration's ``run()``: its
seeds are the ones ``run()`` draws from the same seed.
"""

import numpy as np
import torch

from ..ops import ar_flow
from ..ops.rng import draw_seed, make_generator
from .mesh import Mesh, _rank_generator, _same_device


def make_scan_mesh(n_scan, n_mc, devices=None):
    """2-D ``(scan, mc)`` mesh over the world's ranks, one process group
    per line of each axis; ``devices`` gives each rank's device, by rank
    (default: the card of the rank's ``LOCAL_RANK``). See
    :func:`~fast_tpu_torch.parallel.make_mesh`."""
    return Mesh((n_scan, n_mc), ("scan", "mc"), devices)


def _check_mesh(sims, mesh):
    """Raise unless every sim runs on this rank's device of ``mesh``."""
    for s in sims:
        if not _same_device(s.device, mesh.device):
            raise ValueError(f"the mesh's device is {mesh.device}, a sim runs "
                             f"on {s.device}")


def _seeds(sims, seed):
    """Each sim's ``(log-amplitude, screens)`` seeds, drawn in turn from
    the scan's seed (the first sim's ``SEED`` by default): the first
    sim's are those of its own ``run()``."""
    gen = make_generator(seed if seed is not None else sims[0].seed)
    return [(draw_seed(gen), draw_seed(gen)) for _ in sims]


def _block(sims, mesh):
    """The first of this rank's sims and their number."""
    n_scan = mesh.size("scan")
    if len(sims) % n_scan != 0:
        raise ValueError(f"len(sims) ({len(sims)}) must divide by the scan "
                         f"mesh dimension ({n_scan})")
    per = len(sims) // n_scan
    return mesh.index["scan"] * per, per


def _results(sims, seeds, mesh, outs):
    """Every sim's result on every rank from this rank's series ``outs``
    (each whole), gathered over the scan axis in sim order."""
    series = mesh.gather(torch.stack(outs), "scan")
    results = []
    for s, (logamp_seed, _), out in zip(sims, seeds, series):
        s._logamp_seed, s._logamp_cache = logamp_seed, None
        results.append(s._store(out))
    return results


def run_scan_sharded(sims, mesh, seed=None):
    """Run a batch of same-geometry simulations over a ``(scan, mc)`` mesh.

    Supported synthesis paths: ``fft`` / ``matmul`` / ``colfac`` and the
    kernels ``pallas_fused`` (K2) / ``pallas_colfac`` (K1 up to a 128 px
    pupil, K3 above), each configuration with its own tables. Temporal
    configurations (AR and screens mode) shard one ordered series per
    configuration over the ``scan`` axis (mc must be 1); a rank's AR
    series run together in K6.

    Args:
        sims: list of initialised :class:`fast_tpu_torch.Fast` objects
            sharing grid geometry (same NPXLS/DX/pupil/NITER; PSDs may
            differ — e.g. one per orbit sample, :func:`fast_tpu_torch.sweep.
            build_sweep`), the same list on every rank, each on this rank's
            device. ``len(sims)`` must be divisible by the mesh's scan
            dimension, ``NITER`` by ``n_mc * NCHUNKS``.
        mesh: mesh from :func:`make_scan_mesh`.
        seed: overrides the first sim's seed.

    Returns:
        list of :class:`FastResult`, one per sim (also stored on each sim),
        the same on every rank.
    """
    _check_mesh(sims, mesh)
    s0 = sims[0]
    if s0.temporal:
        if s0._temporal_synth == "ar":
            return _run_scan_sharded_temporal_ar(sims, mesh, seed)
        return _run_scan_sharded_temporal_screens(sims, mesh, seed)
    if s0._synth == "pallas":
        # 'auto' never picks the screens-out kernel in this package
        raise NotImplementedError(
            "scan sharding supports SYNTH 'fft'|'matmul'|'colfac'|"
            "'pallas_fused'|'pallas_colfac'; the screens-out 'pallas' "
            "kernel is not scan-shardable — use a fused kernel "
            "(or 'colfac')")
    for s in sims[1:]:
        if (s.Npxls, s.Npxls_pup, s.Niter, s.Nchunks) != (
                s0.Npxls, s0.Npxls_pup, s0.Niter, s0.Nchunks):
            raise ValueError("sims must share grid geometry and NITER")
        if (s._synth, s.subharmonics) != (s0._synth, s0.subharmonics):
            raise ValueError("sims must share SYNTH and SUBHARM settings")

    lo, per = _block(sims, mesh)
    n_mc, j = mesh.size("mc"), mesh.index["mc"]
    niter, nchunks = s0.Niter, s0.Nchunks
    if niter % (n_mc * nchunks) != 0:
        raise ValueError(
            f"NITER ({niter}) must be divisible by n_mc*NCHUNKS "
            f"({n_mc}*{nchunks})")
    b_local = niter // (n_mc * nchunks)
    if b_local % 2 != 0:
        raise ValueError("per-device chunk batch must be even")

    seeds = _seeds(sims, seed)
    outs = []
    for s, (logamp_seed, seed_mc) in zip(sims[lo:lo + per],
                                         seeds[lo:lo + per]):
        chunks = s._iid_chunks(
            seed_mc, first=j * nchunks, count=nchunks, nbatch=b_local,
            generator=_rank_generator(seed_mc, j, s.device))
        outs.append(mesh.gather(s._series(logamp_seed, chunks,
                                          t0=j * niter // n_mc), "mc"))
    return _results(sims, seeds, mesh, outs)


def _check_temporal(sims, mesh, what, same, msg):
    """The argument checks both temporal scans share."""
    if mesh.size("mc") != 1:
        raise ValueError(
            "temporal scan sharding needs an (n_scan, 1) mesh: one ordered "
            "series per configuration has no mc axis")
    s0 = sims[0]
    for s in sims[1:]:
        if same(s) != same(s0):
            raise ValueError(msg)
        if s._temporal_synth != what:
            raise ValueError(f"sims must all use TEMPORAL_SYNTH='{what}'")
    has_tps = s0.temporal_logamp_powerspec is not None
    for s in sims[1:]:
        if (s.temporal_logamp_powerspec is not None) != has_tps:
            raise ValueError(
                "sims must agree on temporal logamp powerspec presence "
                "(mixed sweeps would silently drop a sim's temporal "
                "log-amplitude spectrum)")
    return _block(sims, mesh)


def _run_scan_sharded_temporal_screens(sims, mesh, seed=None):
    """Independent frozen-flow screens-mode series, one per configuration:
    each sim's screens route from its own seeds."""
    lo, per = _check_temporal(
        sims, mesh, "screens",
        lambda s: (s.Npxls, s.Npxls_pup, s.Niter, s.Nchunks),
        "sims must share grid geometry, NITER and NCHUNKS (screens mode: "
        "pass explicit NPXLS so the grown grids match)")
    seeds = _seeds(sims, seed)
    outs = [s._series(la, s._temporal_screens_chunks(scr))
            for s, (la, scr) in zip(sims[lo:lo + per], seeds[lo:lo + per])]
    return _results(sims, seeds, mesh, outs)


def _run_scan_sharded_temporal_ar(sims, mesh, seed=None):
    """Independent AR frozen-flow series, one per configuration (an orbit
    pass of temporal fading series): this rank's series in one K6 call on
    the kernel route, or series by series on the exact route."""
    s0 = sims[0]
    lo, per = _check_temporal(sims, mesh, "ar",
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
    # one noise stream for the scan, the first sim's, on every rank
    seed_noise = s0._ar_start(seeds[0][1])[1]
    mine = sims[lo:lo + per]
    starts = [s._ar_start(scr)[0]
              for s, (_, scr) in zip(mine, seeds[lo:lo + per])]
    if s0._ar_route == "fft":
        outs = [s._series(la, s._ar_fft_chunks(a, seed_noise, series=lo + k))
                for k, (s, (la, _), a) in enumerate(zip(mine,
                                                         seeds[lo:lo + per],
                                                         starts))]
        return _results(sims, seeds, mesh, outs)
    T = [s.tables for s in mine]
    c, _ = ar_flow.ar_flow_fused_batch(
        seed_noise, torch.stack(starts),
        torch.stack([t["ph"] for t in T]),
        torch.stack([t["ns"] for t in T]) if boiling else None,
        T[0]["W"], torch.stack([t["pm"] for t in T]), s0.Niter,
        noise=s0.params["TEMPORAL_NOISE"], series0=lo,
        laid=T[0].get("w_laid"), precision=s0._precision)
    outs = []
    for i, (s, t, (la, _)) in enumerate(zip(mine, T, seeds[lo:lo + per])):
        scale = float(t["dx"]) ** 2 / float(t["norm"])
        outs.append(s._series(
            la, [torch.complex(c[:, i, 0], c[:, i, 1]) * scale]))
    return _results(sims, seeds, mesh, outs)
