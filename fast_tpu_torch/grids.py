"""Spatial-frequency grids.

Static, host-side (numpy float64) grid metadata, the same construction as
``fast_tpu.grids`` for the grids of the iid Monte Carlo path:

* main grid: ``df = 2*pi / (N*dx)``, centred axes;
* subharmonic grids: 3 levels of 3x3 points, ``df = 2*pi / (3**p * D)``
  for ``p = 1, 2, 3`` and ``D = N * dx``; the level axis leads every array.

The temporal and log-amplitude grids belong to paths this package does not
run yet.
"""

import numpy as np


class SpatialFrequencyStruct:
    """A square frequency grid: meshed ``fx/fy/fabs`` over one 1-D axis,
    or over a stack of axes (a 2-D ``f_axis``) whose leading axis runs
    through every array."""

    def __init__(self, f_axis):
        f_axis = np.asarray(f_axis, dtype=float)
        if f_axis.ndim not in (1, 2):
            raise ValueError(
                f"f_axis must be 1-D or a 2-D stack, got ndim={f_axis.ndim}")
        self.fx_axis = self.fy_axis = self.f = f_axis
        self.dfx = self.dfy = self.df = f_axis[..., 1] - f_axis[..., 0]
        fx, fy = np.broadcast_arrays(f_axis[..., None, :],
                                     f_axis[..., :, None])
        self.fx = np.ascontiguousarray(fx)
        self.fy = np.ascontiguousarray(fy)
        self.fabs = np.hypot(self.fx, self.fy)


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
