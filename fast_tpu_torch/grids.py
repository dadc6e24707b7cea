"""Spatial-frequency grids.

Static, host-side (numpy float64) grid metadata, the same construction as
``fast_tpu.grids`` for the main grid of the iid Monte Carlo path:
``df = 2*pi / (N*dx)`` with centered axes. The subharmonic, temporal and
log-amplitude grids belong to paths this package does not run yet.
"""

import numpy as np


class SpatialFrequencyStruct:
    """A square frequency grid: meshed ``fx/fy/fabs`` over one 1-D axis."""

    def __init__(self, f_axis):
        f_axis = np.asarray(f_axis, dtype=float)
        if f_axis.ndim != 1:
            raise ValueError(f"f_axis must be 1-D, got ndim={f_axis.ndim}")
        self.fx_axis = self.fy_axis = self.f = f_axis
        self.dfx = self.dfy = self.df = f_axis[1] - f_axis[0]
        fx, fy = np.broadcast_arrays(f_axis[None, :], f_axis[:, None])
        self.fx = np.ascontiguousarray(fx)
        self.fy = np.ascontiguousarray(fy)
        self.fabs = np.hypot(self.fx, self.fy)


def _centered_axis(n, spacing):
    """``n`` centered bins at ``spacing``: [-n/2, n/2) * spacing."""
    return np.arange(-(n / 2.0), n / 2.0) * spacing


class SpatialFrequencies:
    """The main frequency grid of an ``N`` x ``N`` screen at pitch ``dx``."""

    def __init__(self, N, dx):
        self.N = N
        self.dx = dx
        self.main = SpatialFrequencyStruct(
            _centered_axis(N, 2 * np.pi / (N * dx)))
