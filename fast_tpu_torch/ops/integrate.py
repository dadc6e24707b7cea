"""Numerical integration in torch.

Composite Simpson integration of 2-D power spectra, matching
``scipy.integrate.simpson`` for uniform samples (Cartwright's
last-interval correction for an even sample count), and path (layer)
integration as a sum over the layer axis.
"""

import torch


def simpson(y, dx=1.0, axis=-1):
    """Composite Simpson integration with uniform spacing ``dx``."""
    y = torch.movedim(y, axis, -1)
    n = y.shape[-1]
    if n < 2:
        raise ValueError("need at least 2 samples to integrate")
    if n == 2:
        return 0.5 * dx * (y[..., 0] + y[..., 1])

    def _odd_simpson(z):
        return (dx / 3.0) * (
            z[..., 0] + z[..., -1]
            + 4.0 * z[..., 1:-1:2].sum(-1)
            + 2.0 * z[..., 2:-1:2].sum(-1)
        )

    if n % 2 == 1:
        return _odd_simpson(y)
    head = _odd_simpson(y[..., : n - 1])
    tail = dx * (5.0 * y[..., -1] + 8.0 * y[..., -2] - y[..., -3]) / 12.0
    return head + tail


def integrate_powerspectrum(power_spectrum, f):
    """Simpson-integrate a (stack of) 2-D spectra over the last two axes.

    ``f`` is the 1-D frequency axis, uniform and shared by both axes.
    """
    df = float(f[1] - f[0])
    return simpson(simpson(power_spectrum, dx=df, axis=-1), dx=df, axis=-1)


def integrate_path(integrands, axis=0):
    """Integrate along the propagation path of the discrete layered model:
    a sum over the layer axis (the only branch the engine uses)."""
    return integrands.sum(axis)
