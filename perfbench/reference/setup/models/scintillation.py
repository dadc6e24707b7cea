"""Log-amplitude (scintillation) power spectrum in torch float64.

Reference ``fast/ao_power_spectra.py:272-301``: per-layer von Karman
spectrum times the Fresnel filter ``sin^2(wvl h f^2 / 4pi)``, filtered by
the pupil/mode spatial filter and path-integrated. The temporal mode's
high-resolution pupil-filter spline (reference ``fast/fast.py:394-405``) is
a bilinear resampler on uniform axes, which equals the reference's
``RectBivariateSpline(kx=1, ky=1)`` at interior points.
"""

import numpy as np
import torch

from ..ops.integrate import integrate_path
from .atmosphere import turb_powerspectrum_vonKarman


def logamp_powerspec(freq, h, cn2, wvl, pupilfilter=None, layer=True,
                     L0=np.inf, l0=1e-6):
    """Path-integrated log-amplitude PSD on the grid ``freq.fabs`` of a
    frequency struct (a per-layer grid if ``freq.freq_per_layer``).

    ``pupilfilter`` is None, an array or tensor tabulated on the grid
    (broadcast over layers), or a :class:`PupilFilterSampler`, sampled on
    each layer's axes ``freq.fx_axis``, ``freq.fy_axis``. ``layer``: the
    discrete layered model (a sum over layers) or, if False, a Simpson
    integral over the uniform heights ``h`` (:func:`integrate_path`).
    """
    fabs = freq.fabs
    if not torch.is_tensor(fabs):
        fabs = torch.as_tensor(np.asarray(fabs, dtype=np.float64))
    h = torch.as_tensor(np.asarray(h, dtype=float), dtype=fabs.dtype)
    if getattr(freq, "freq_per_layer", False):
        fabs_3d = fabs
    else:
        fabs_3d = fabs.expand((h.shape[0],) + tuple(fabs.shape))
    powerspec = turb_powerspectrum_vonKarman(freq, cn2, L0=L0, l0=l0) \
        * 2 * np.pi * (2 * np.pi / wvl) ** 2
    exp = (slice(None),) + (None,) * (fabs_3d.ndim - 1)
    powerspec = powerspec * torch.sin(
        wvl * h[exp] * fabs_3d ** 2 / (4 * np.pi)) ** 2
    if isinstance(pupilfilter, PupilFilterSampler):
        fx_axis = np.asarray(freq.fx_axis)
        fy_axis = np.asarray(freq.fy_axis)
        if getattr(freq, "freq_per_layer", False):
            pf = torch.stack([pupilfilter(fy_axis[i], fx_axis[i])
                              for i in range(fx_axis.shape[0])])
        else:
            pf = pupilfilter(fy_axis, fx_axis)
        powerspec = powerspec * pf
    elif pupilfilter is not None:
        powerspec = powerspec * torch.as_tensor(pupilfilter,
                                                dtype=powerspec.dtype)
    return integrate_path(powerspec, h, layer=layer)


class PupilFilterSampler:
    """Bilinear resampler of a pupil filter tabulated on uniform axes.

    Axis pairing follows the reference spline (``fast/funcs.py:313``,
    evaluated at ``fast/ao_power_spectra.py:293-295``): rows of ``P`` run
    along ``x_axis``, columns along ``y_axis``; a call takes ``(row_values,
    col_values)`` and returns the outer-product grid, float64.
    """

    def __init__(self, P, x_axis, y_axis):
        self.P = torch.as_tensor(np.asarray(P, dtype=np.float64))
        self.x0 = float(x_axis[0])
        self.dx = float(x_axis[1] - x_axis[0])
        self.y0 = float(y_axis[0])
        self.dy = float(y_axis[1] - y_axis[0])

    def __call__(self, row_vals, col_vals):
        nx, ny = self.P.shape
        row_vals = torch.as_tensor(np.asarray(row_vals, dtype=np.float64))
        col_vals = torch.as_tensor(np.asarray(col_vals, dtype=np.float64))
        rix = torch.clamp((row_vals - self.x0) / self.dx, 0, nx - 1)
        ciy = torch.clamp((col_vals - self.y0) / self.dy, 0, ny - 1)
        r0 = torch.clamp(torch.floor(rix).to(torch.int64), 0, nx - 2)
        c0 = torch.clamp(torch.floor(ciy).to(torch.int64), 0, ny - 2)
        fr = (rix - r0)[:, None]
        fc = (ciy - c0)[None, :]
        r0 = r0[:, None]
        c0 = c0[None, :]
        P = self.P
        return (P[r0, c0] * (1 - fr) * (1 - fc) + P[r0, c0 + 1] * (1 - fr) * fc
                + P[r0 + 1, c0] * fr * (1 - fc) + P[r0 + 1, c0 + 1] * fr * fc)


def temporal_logamp_powerspec(fx_axes, fy_axes, h, cn2, wvl, sampler, dfy,
                              L0=np.inf, l0=1e-6, block=8192):
    """1-D temporal log-amplitude PSD, streamed over blocks of temporal
    bins: ``sum_y logamp_PSD(f) * dfy`` per bin, summed over layers,
    without the (nlayers, Ny, Nx) per-layer grids of the reference
    (``fast/fast.py:581-587``), whose memory grows with NITER. The von
    Karman and Fresnel terms depend only on ``|f|``, which the per-layer
    wind rotation leaves alone, and the pupil filter is sampled on the
    unrotated axes (reference ``ao_power_spectra.py:291-295``).

    Args:
        fx_axes: (nlayers, Nx) per-layer temporal x-axes (linear frequency).
        fy_axes: (nlayers, Ny) per-layer y-axes.
        h, cn2: per-layer heights and Cn2 dh.
        wvl: wavelength.
        sampler: :class:`PupilFilterSampler`.
        dfy: main-grid y-frequency spacing (the integration weight).
        block: temporal bins per streamed block.

    Returns:
        (Nx,) float64 numpy array.
    """
    fx_axes = np.asarray(fx_axes, dtype=np.float64)
    fy_axes = np.asarray(fy_axes, dtype=np.float64)
    h = np.asarray(h, dtype=float)
    cn2 = np.asarray(cn2, dtype=float)
    nlayers, Nx = fx_axes.shape
    km = 5.92 / l0
    k0 = (2 * np.pi) / L0
    pref = 2 * np.pi * (2 * np.pi / wvl) ** 2

    out = np.zeros(Nx)
    for i in range(nlayers):
        fy = torch.from_numpy(fy_axes[i])[:, None]
        for lo in range(0, Nx, block):
            fx = torch.from_numpy(fx_axes[i, lo:lo + block])[None, :]
            fabs2 = fx ** 2 + fy ** 2
            spec = 0.033 * cn2[i] * torch.exp(-fabs2 / km ** 2) \
                / (fabs2 + k0 ** 2) ** (11 / 6.0)
            spec = torch.where(torch.isinf(spec), 0.0, spec)
            spec = spec * pref * torch.sin(
                wvl * h[i] * fabs2 / (4 * np.pi)) ** 2
            spec = spec * sampler(fy_axes[i], fx_axes[i, lo:lo + block])
            out[lo:lo + block] += (spec.sum(0) * dfy).numpy()
    return out
