"""Sharded Monte Carlo execution over ``torch.distributed``.

The port of ``fast_tpu.parallel.mesh``. A mesh is a grid of the world's
ranks, one process and one device each; the collectives run over NCCL
between cards and over gloo on the CPU (gloo moves host copies of the
tensors). NCCL refuses two ranks on one card, so ranks that share a card
(``devices=["cuda:0", "cuda:0"]``) run in a gloo world, each still
launching the kernels on the card.

* iid (:func:`run_sharded`): the Monte Carlo axis is cut over the ``mc``
  axis. Rank r runs the engine's chunk loop for the chunks ``r * NCHUNKS
  .. (r + 1) * NCHUNKS - 1`` of ``NITER / (d * NCHUNKS)`` draws, each with
  the kernel's Philox stream of its global chunk index, and multiplies
  them by its window of the log-amplitude series, which every rank draws
  from the run's seed. So on the kernel routes without ``SUBHARM`` a
  d-rank run gives ``Fast(NCHUNKS=d * NCHUNKS).run()`` bit for bit; the
  stock-op routes draw from a generator of their own per rank and agree
  in distribution.
* Temporal frozen flow, screens route: the time axis is cut; every rank
  makes the same layer screens and samples its own window of absolute
  steps, so the gathered series is the serial one.
* Temporal AR, pure frozen flow (alpha = 1): the time axis is cut; each
  window's start state is the series' start times ``e^{i mod(phase *
  offset, 2 pi)}``, the angle taken in float64, and the window runs
  through the engine's AR route (K4, or K5 past 8 layers) from its
  absolute step.
* Temporal AR, boiling: the layer axis is cut. Each rank evolves its
  layers with the kernels' Philox noise of its own state rows (so the
  shards draw the serial run's noise), forms its layer-partial pupil
  field ``W (sum_local a) W^T`` for the steps of a chunk, and one
  ``all_reduce`` of that block per chunk gives every rank the whole field
  before the detector.

:func:`sharded_moments` reduces the first four moments of an array cut
over an axis of the mesh: each rank sums its slice in float64 and only
the count and the four sums cross the group.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import synthesis
from ..engine import _resolve_device
from ..ops import ar_flow
from ..ops.rng import make_generator

#: How long a rank waits in a collective for the others before it fails.
TIMEOUT = datetime.timedelta(seconds=600)


def _same_device(a, b):
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _rank_device(devices, rank, world):
    """This rank's device: ``devices[rank]``, or by default the card of the
    rank's ``LOCAL_RANK``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] (one "
                "a rank) to run the ranks on the CPU")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    devices = list(devices)
    if len(devices) != world:
        raise ValueError(f"devices names {len(devices)} devices for a world "
                         f"of {world} ranks: give one a rank")
    dev = _resolve_device(devices[rank])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of the ranks of ``torch.distributed``, one device each, with
    the attributes of JAX's ``Mesh``: ``devices``, a numpy array of shape
    ``shape`` holding each rank's ``torch.device`` (gathered once, when the
    mesh is made), and ``axis_names``. Rank ``i`` sits at
    ``np.unravel_index(i, shape)``.

    For this rank: ``rank``, ``device``, ``index`` (its position along
    each axis) and ``groups`` (for each axis, the process group of the
    ranks along it that share this rank's other indices); ``backend`` is
    the world's ('nccl' or 'gloo'), read from the group.

    The mesh takes the world there is (``torch.distributed``'s default
    group, as :func:`~fast_tpu_torch.parallel.dryrun.spawn` makes it),
    whose size must be the mesh's. Without one it makes the world: the one
    ``torchrun`` names in the environment (``env://``), else a world of one
    rank on this process (a ``HashStore``); NCCL where this rank's device
    is a card, gloo on the CPU, :data:`TIMEOUT`. :meth:`close` (or
    leaving a ``with`` block) destroys the groups the mesh made, and the
    world if the mesh made it.
    """

    def __init__(self, shape, axis_names, devices=None):
        self._groups_made, self._owns_world = [], False
        if not dist.is_initialized():
            # torchrun names the world in the environment; else a world of
            # one rank
            world = int(os.environ.get("WORLD_SIZE", 1))
            rank = int(os.environ.get("RANK", 0))
            n = world if shape is None else int(np.prod(shape))
            if n != world:
                raise ValueError(
                    f"a mesh of {n} ranks needs a world of {n}; this process "
                    f"has no process group and a world of {world} in its "
                    f"environment: start the ranks with torchrun (or "
                    f"fast_tpu_torch.parallel.dryrun.spawn)")
            backend = ("nccl" if _rank_device(devices, rank, world).type
                       == "cuda" else "gloo")
            if world == 1:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1,
                                        timeout=TIMEOUT)
            else:
                dist.init_process_group(backend, init_method="env://",
                                        rank=rank, world_size=world,
                                        timeout=TIMEOUT)
            self._owns_world = True
        try:
            self._join(shape, axis_names, devices)
        except Exception:
            self.close()
            raise

    def _join(self, shape, axis_names, devices):
        world, self.rank = dist.get_world_size(), dist.get_rank()
        self.shape = (world,) if shape is None else tuple(int(s)
                                                          for s in shape)
        if int(np.prod(self.shape)) != world:
            raise ValueError(f"a {self.shape} mesh needs {np.prod(self.shape)}"
                             f" ranks; the world has {world}")
        self.axis_names = tuple(axis_names)
        self.backend = dist.get_backend()
        self.device = _rank_device(devices, self.rank, world)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL world moves CUDA tensors; this rank's "
                             f"device is {self.device}")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        names = [None] * world
        dist.all_gather_object(names, str(self.device))
        grid = np.empty(world, dtype=object)
        grid[:] = [torch.device(n) for n in names]
        self.devices = grid.reshape(self.shape)
        self.index = {a: int(i) for a, i in zip(
            self.axis_names, np.unravel_index(self.rank, self.shape))}
        self.groups = {}
        ranks = np.arange(world).reshape(self.shape)
        for k, axis in enumerate(self.axis_names):
            # every rank takes part in making every group, in one order
            for line in np.moveaxis(ranks, k, -1).reshape(-1, self.shape[k]):
                line = [int(r) for r in line]
                if len(line) == world:
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(line, timeout=TIMEOUT)
                    if self.rank in line:
                        self._groups_made.append(group)
                if self.rank in line:
                    self.groups[axis] = group

    def size(self, axis):
        """The number of ranks along ``axis``."""
        return self.shape[self.axis_names.index(axis)]

    def _wire(self, t):
        """``t`` as a collective moves it: real, on the card under NCCL and
        on the host under gloo."""
        x = torch.view_as_real(t) if t.is_complex() else t
        return (x if self.backend == "nccl" else x.cpu()).contiguous()

    @staticmethod
    def _back(x, like):
        x = x.to(like.device)
        return torch.view_as_complex(x) if like.is_complex() else x

    def gather(self, t, axis):
        """The tensors ``t`` of the ranks along ``axis``, joined on their
        first axis in rank order, on ``t``'s device; every rank's ``t`` has
        the same shape."""
        x = self._wire(t)
        parts = [torch.empty_like(x) for _ in range(self.size(axis))]
        dist.all_gather(parts, x, group=self.groups[axis])
        return self._back(torch.cat(parts), t)

    def all_reduce(self, t, axis):
        """The sum of the tensors ``t`` of the ranks along ``axis``, on
        ``t``'s device."""
        x = self._wire(t).clone()
        dist.all_reduce(x, group=self.groups[axis])
        return self._back(x, t)

    def close(self):
        for group in self._groups_made:
            dist.destroy_process_group(group)
        self._groups_made = []
        if self._owns_world:
            dist.destroy_process_group()
            self._owns_world = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"{self.backend}, devices={self.devices.ravel().tolist()})")


def make_mesh(n=None, axis_name="mc", devices=None):
    """1-D mesh over the Monte Carlo axis: every rank of the world (see
    :class:`Mesh` for the world it takes or makes).

    Args:
        n: None or the world's size.
        axis_name: the axis' name.
        devices: each rank's device, by rank; by default rank r runs on
            ``cuda:{LOCAL_RANK}`` (raises without a card). Ranks may share
            a device (gloo).
    """
    return Mesh(None if n is None else (n,), (axis_name,), devices)


def _world():
    return dist.get_world_size() if dist.is_initialized() else 1


def _check_device(sim, mesh):
    if not _same_device(sim.device, mesh.device):
        raise ValueError(f"the mesh's device is {mesh.device}, the sim runs "
                         f"on {sim.device}")


def _rank_generator(seed, rank, device):
    """The generator of a rank's stock-op draws: the run's own for rank 0
    (a world of one is the serial run), one of its own from ``(seed,
    rank)`` for the others."""
    if rank:
        seed = int(np.random.SeedSequence([seed, rank]).generate_state(
            1, np.uint64)[0])
    return make_generator(seed, device=device)


def _cached(sim, key, build):
    """Per-rank tables kept on the sim until its tables change."""
    c = getattr(sim, "_shard_cache", None)
    if c is None or c[0] is not sim.tables or c[1] != key:
        sim._shard_cache = (sim.tables, key, build())
    return sim._shard_cache[2]


def run_sharded(sim, mesh=None, seed=None):
    """Run ``sim``'s Monte Carlo loop sharded over a mesh's first axis.

    The global NITER realizations are split evenly across the ranks; each
    runs NCHUNKS chunks of its own (see the module docstring). Returns a
    :class:`fast_tpu_torch.FastResult` over the gathered realizations, the
    same on every rank, also stored on ``sim.result``. ``sim`` runs on the
    rank's device; ``mesh`` defaults to :func:`make_mesh` on that device
    (closed again at the end); ``seed`` overrides the sim's seed.

    Temporal mode shards the time axis (frozen-flow screens, and AR series
    with alpha = 1) or, for boiling AR series, the layer axis.
    """
    own = mesh is None
    if own:
        mesh = make_mesh(devices=[sim.device] * _world())
    try:
        _check_device(sim, mesh)
        if not sim.temporal:
            return _run_sharded_iid(sim, mesh, seed)
        if sim._ar_route is None:
            return _run_sharded_temporal(sim, mesh, seed)
        if np.any(np.asarray(sim._ar_alpha) < 1.0):
            return _run_sharded_temporal_ar_layers(sim, mesh, seed)
        return _run_sharded_temporal_ar(sim, mesh, seed)
    finally:
        if own:
            mesh.close()


def _run_sharded_iid(sim, mesh, seed):
    if sim._synth == "pallas":
        raise NotImplementedError(
            "run_sharded supports SYNTH 'fft'|'matmul'|'colfac'|"
            "'pallas_fused'|'pallas_colfac'; the screens-out 'pallas' kernel "
            "is not shardable — use a fused kernel (or 'colfac')")
    axis = mesh.axis_names[0]
    ndev, r = mesh.size(axis), mesh.index[axis]
    niter, nchunks = sim.Niter, sim.Nchunks
    if niter % (ndev * nchunks) != 0:
        raise ValueError(
            f"NITER ({niter}) must be divisible by n_devices*NCHUNKS "
            f"({ndev}*{nchunks})")
    b_local = niter // (ndev * nchunks)
    if b_local % 2 != 0:
        raise ValueError("per-device chunk batch must be even "
                         "(Hermitian doubling)")
    logamp_seed, seed_mc = sim._run_seeds(seed)
    chunks = sim._iid_chunks(
        seed_mc, first=r * nchunks, count=nchunks, nbatch=b_local,
        generator=_rank_generator(seed_mc, r, sim.device))
    out = sim._series(logamp_seed, chunks, t0=r * niter // ndev)
    return sim._store(mesh.gather(out, axis))


def _time_window(sim, mesh):
    axis = mesh.axis_names[0]
    ndev = mesh.size(axis)
    if sim.Niter % ndev != 0:
        raise ValueError(
            f"NITER ({sim.Niter}) must be divisible by n_devices ({ndev})")
    t_local = sim.Niter // ndev
    return axis, mesh.index[axis] * t_local, t_local


def _run_sharded_temporal(sim, mesh, seed):
    """Time-axis sharding of one frozen-flow series (screens route)."""
    axis, step0, t_local = _time_window(sim, mesh)
    logamp_seed, seed_scr = sim._run_seeds(seed)
    out = sim._series(logamp_seed, sim._temporal_screens_chunks(
        seed_scr, step0, t_local), t0=step0)
    return sim._store(mesh.gather(out, axis))


def _run_sharded_temporal_ar(sim, mesh, seed):
    """Time-axis sharding of a pure frozen-flow AR series (alpha = 1).

    The state at step t is exactly ``a0 * phasor^t``, so each rank jumps
    to its window's start: the accumulated angle is wrapped in float64
    before the cast to the working type, so the fractional cycle survives
    large offsets. The serial kernel route multiplies a float32 phasor
    every step instead, so the two differ by its round-off times the
    offset.
    """
    axis, step0, t_local = _time_window(sim, mesh)

    def jump():
        g = sim.freq.main
        phase = synthesis.ar_step_phase(g.fx, g.fy, sim.wind_vector, sim.dt)
        ang = np.mod(phase * float(step0), 2 * np.pi)
        cdt = torch.complex64 if sim.dtype == torch.float32 \
            else torch.complex128
        return torch.from_numpy(np.exp(1j * ang)).to(sim.device, cdt)

    jumped = _cached(sim, ("ar_jump", step0), jump)
    logamp_seed, seed_scr = sim._run_seeds(seed)
    a0, seed_noise = sim._ar_start(seed_scr)
    chunks = sim._ar_chunks(a0 * jumped, seed_noise, step0=step0,
                            nsteps=t_local)
    out = sim._series(logamp_seed, chunks, t0=step0)
    return sim._store(mesh.gather(out, axis))


def _run_sharded_temporal_ar_layers(sim, mesh, seed):
    """Layer-axis sharding of a boiling AR series.

    The AR(1)-in-Fourier recursion is sequential in time but independent
    per layer, so each rank evolves its ``L / d`` layers through the
    stock-op recursion with the kernels' noise of its own state rows. The
    recursion never needs the layer sum, so the ranks meet once per chunk:
    the pruned DFT is linear, so each rank transforms its layer-partial
    sum ``W (sum_local a) W^T`` for the chunk's steps and one
    ``all_reduce`` of that (B, P, P) block, P^2 / N^2 of the Fourier
    field's volume, forms the pupil field on every rank. The JAX package
    runs no kernel here either.
    """
    axis = mesh.axis_names[0]
    ndev, r = mesh.size(axis), mesh.index[axis]
    nlayers = len(sim.h)
    if nlayers % ndev != 0:
        raise ValueError(
            f"layer sharding needs nlayers ({nlayers}) divisible by "
            f"n_devices ({ndev})")
    l_local = nlayers // ndev
    lay = slice(r * l_local, (r + 1) * l_local)
    T = sim.tables

    def tables():
        alpha = T["alpha"][lay, None, None]
        return (T["step_phasor"][lay], T["sqrt_psd_df"][lay], alpha,
                torch.sqrt(torch.clamp(1.0 - alpha ** 2, min=0.0)))

    phasor, sqrt_psd_df, alpha, sqrt1ma = _cached(
        sim, ("ar_layers", ndev, r), tables)
    logamp_seed, seed_scr = sim._run_seeds(seed)
    a0, seed_noise = sim._ar_start(seed_scr)
    noise = ar_flow.NoiseStream(
        seed_noise, l_local, sim.Npxls, sim.Niter,
        noise=sim.params["TEMPORAL_NOISE"], device=sim.device,
        dtype=a0.dtype, layer0=r * l_local)
    W, pm = T["W"], T["pm"]
    dx, norm = float(T["dx"]), float(T["norm"])

    def chunks(a):
        for s, n in sim._pieces():
            a, A = synthesis.ar_flow_series(
                a, noise, phasor, sqrt_psd_df, alpha, sqrt1ma, n, True,
                step0=s)
            with synthesis.matmul_precision(sim._precision):
                field = mesh.all_reduce(W @ A @ W.T, axis)
            yield synthesis.detector_coupling(field.real, pm, dx, norm)

    return sim._store(sim._series(logamp_seed, chunks(a0[lay])))


def sharded_moments(values, mesh=None, axis_name="mc"):
    """First four moments of an array cut over a mesh axis.

    ``values`` is the whole array (numpy or a tensor), the same on every
    rank; rank r reduces its slice ``r / d`` along the first axis, in
    float64 on its device, and only the count and the four sums cross the
    group. Returns numpy float64 ``[E x, E x^2, E x^3, E x^4]``, the count
    being the first axis' length, as the JAX function counts it.
    """
    own = mesh is None
    if own:
        mesh = make_mesh(axis_name=axis_name)
    try:
        x = torch.as_tensor(values)
        ndev, r = mesh.size(axis_name), mesh.index[axis_name]
        n = x.shape[0]
        if n % ndev != 0:
            raise ValueError(f"the first axis ({n}) must divide by the "
                             f"mesh's {axis_name!r} dimension ({ndev})")
        part = x[r * n // ndev:(r + 1) * n // ndev].to(mesh.device,
                                                        torch.float64)
        sums = torch.stack([torch.full((), float(part.shape[0]),
                                       dtype=torch.float64,
                                       device=mesh.device)]
                           + [(part ** k).sum() for k in (1, 2, 3, 4)])
        sums = mesh.all_reduce(sums, axis_name)
        return (sums[1:] / sums[0]).cpu().numpy()
    finally:
        if own:
            mesh.close()
