"""Spatial-frequency grids.

Static, host-side (numpy float64) grid metadata, the same construction as
``fast_tpu.grids``:

* main grid: ``df = 2*pi / (N*dx)``, centred axes;
* subharmonic grids: 3 levels of 3x3 points, ``df = 2*pi / (3**p * D)``
  for ``p = 1, 2, 3`` and ``D = N * dx``; the level axis leads every array;
* temporal grids: per-layer x-axes in *linear* spatial frequency
  ``1 / (Nx v dt)`` rotated by the wind direction, the y-axis the main
  grid's (integrated over later);
* the log-amplitude grid of the temporal mode's high-resolution pupil
  filter.
"""

import numpy as np


def _axis_spacing(axis):
    """Bin spacing of (a stack of) uniform axes."""
    return axis[..., 1] - axis[..., 0]


def mesh_frequency_axes(fx_axis, fy_axis, rot=None):
    """Broadcast centred mesh of (stacked) frequency axes: ``fx_axis``
    (..., Nx) and ``fy_axis`` (..., Ny), any leading axes (subharmonic
    levels, layers) broadcast through; ``rot`` (...,) rotates the meshed
    coordinates in the plane (wind-aligned temporal grids). Returns ``(fx,
    fy)``, numpy float64 of shape (..., Ny, Nx)."""
    fx = np.asarray(fx_axis, dtype=float)[..., None, :]
    fy = np.asarray(fy_axis, dtype=float)[..., :, None]
    fx, fy = np.broadcast_arrays(fx, fy)
    if rot is not None:
        rot = np.asarray(rot, dtype=float)[..., None, None]
        c, s = np.cos(rot), np.sin(rot)
        fx, fy = fx * c - fy * s, fx * s + fy * c
    return np.ascontiguousarray(fx), np.ascontiguousarray(fy)


class SpatialFrequencyStruct:
    """A frequency grid: meshed ``fx/fy/fabs`` over ``fx_axis`` (..., Nx)
    and ``fy_axis`` (..., Ny; ``fx_axis`` again if None), of shape (...,
    Ny, Nx), by :func:`mesh_frequency_axes`."""

    def __init__(self, fx_axis, fy_axis=None, rot=None, freq_per_layer=False):
        fx_axis = np.asarray(fx_axis, dtype=float)
        if fx_axis.ndim not in (1, 2):
            raise ValueError(
                f"fx_axis must be 1-D or a 2-D stack, got ndim={fx_axis.ndim}")
        shared = fy_axis is None
        fy_axis = fx_axis if shared else np.asarray(fy_axis, dtype=float)
        self.fx_axis, self.fy_axis = fx_axis, fy_axis
        self.freq_per_layer = freq_per_layer
        self.dfx = _axis_spacing(fx_axis)
        self.dfy = _axis_spacing(fy_axis)
        # a square grid has one spacing and one 1-D axis
        self.df = self.dfx if shared else None
        if shared:
            self.f = fx_axis
        self.fx, self.fy = mesh_frequency_axes(fx_axis, fy_axis, rot)
        self.fabs = np.hypot(self.fx, self.fy)


class _AxesOnlyStruct:
    """Axes-only frequency metadata (no meshed arrays): what the streamed
    temporal PSD assembly reads, in O(Nx + Ny) memory instead of
    O(nlayer * Ny * Nx)."""

    def __init__(self, fx_axis, fy_axis, rot):
        self.fx_axis, self.fy_axis, self.rot = fx_axis, fy_axis, rot
        self.freq_per_layer = True
        self.dfx = _axis_spacing(fx_axis)
        self.dfy = _axis_spacing(fy_axis)
        self.df = None


def _centered_axis(n, spacing):
    """``n`` centered bins at ``spacing``: [-n/2, n/2) * spacing."""
    return np.arange(-(n / 2.0), n / 2.0) * spacing


class SpatialFrequencies:
    """The frequency grids of an ``N`` x ``N`` screen at pitch ``dx``."""

    def __init__(self, N, dx):
        self.N = N
        self.dx = dx
        self.main = SpatialFrequencyStruct(
            _centered_axis(N, 2 * np.pi / (N * dx)))

    def make_subharm_freqs(self, pmax=3):
        """3x3-point grids at spacings ``2*pi / (3**p * D)``, p = 1..pmax:
        ``self.subharm`` with (pmax, 3, 3) meshes and (pmax, 3) axes."""
        D = self.dx * self.N
        df_lo = 2 * np.pi / (3.0 ** np.arange(1, pmax + 1) * D)
        self.subharm = SpatialFrequencyStruct(
            np.arange(-1, 2)[None, :] * df_lo[:, None])

    def make_temporal_freqs(self, nlayer, Ny, Nx, wind_speed, wind_dir, dt,
                            materialize=True):
        """Per-layer grids whose x-axes align to temporal frequency bins:
        the spacing ``1 / (Nx v_i dt)``, in linear spatial frequency, maps
        index ``k`` to the same temporal frequency ``k / (Nx dt)`` in every
        layer, so per-layer spectra sum bin by bin. ``materialize=False``
        stores only the axes and the rotation."""
        v = np.asarray(wind_speed, dtype=float)
        df_temporal = 1.0 / (Nx * v * dt)
        fx_axes = _centered_axis(Nx, 1.0)[None, :] * df_temporal[:, None]
        fy_axes = np.tile(_centered_axis(Ny, self.main.dfy), (nlayer, 1))
        rot = np.radians(np.asarray(wind_dir, dtype=float))
        if materialize:
            self.temporal = SpatialFrequencyStruct(fx_axes, fy_axes, rot=rot,
                                                   freq_per_layer=True)
        else:
            self.temporal = _AxesOnlyStruct(fx_axes, fy_axes, rot)

    def make_logamp_freqs(self, Nx, dx, Ny, dy):
        """The high-resolution grid of the temporal pupil filter: ``Nx`` by
        ``Ny`` points at the pitches ``dx`` and ``dy``."""
        self.logamp = SpatialFrequencyStruct(
            _centered_axis(Nx, 2 * np.pi / (Nx * dx)),
            _centered_axis(Ny, 2 * np.pi / (Ny * dy)))
