"""Atmospheric turbulence models and integrated parameters.

Profile models and integrated parameters are host-side numpy (the same
functions as ``fast_tpu.models.atmosphere``); the von Karman spectrum is
torch float64, since it sits inside the PSD assembly.
"""

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Cn2 / wind profiles (host side)
# ---------------------------------------------------------------------------


def HV57(h, w=21, A=1.7e-14):
    """Hufnagel-Valley 5/7 Cn2(h) profile [m^-2/3] (not integrated Cn2 dh)."""
    h = np.asarray(h, dtype=float)
    return (0.00594 * (w / 27) ** 2 * (1e-5 * h) ** 10 * np.exp(-h / 1000)
            + 2.7e-16 * np.exp(-h / 1500) + A * np.exp(-h / 100.0))


def Bufton_wind(h, vg=8, vt=30, ht=9400.0, Lt=4800.0):
    """Bufton wind-speed profile [m/s] (ground + tropopause Gaussian bump)."""
    h = np.asarray(h, dtype=float)
    return vg + vt * np.exp(-(((h - ht) / Lt) ** 2))


def equivalent_layers(h, p, L, w=None):
    """Fusco (1999) equivalent-layers profile compression.

    Splits the profile into ``L`` slabs; each slab's height (and wind) is
    the Cn2-weighted 5/3-moment effective value. An empty slab becomes a
    zero-weight layer at the slab centre, as in the JAX package.
    """
    h = np.asarray(h, dtype=float)
    p = np.asarray(p, dtype=float)
    h_el = np.zeros(L)
    cn2_el = np.zeros(L)
    if w is not None:
        w = np.asarray(w, dtype=float)
        w_el = np.zeros(L)

    hstep = (h.max() - h.min()) / L
    alt_bins = np.arange(h.min(), h.max(), hstep)
    ix = np.digitize(h, alt_bins)
    for i in range(L):
        sel = ix == i + 1
        psum = p[sel].sum()
        cn2_el[i] = psum
        if psum > 0:
            h_el[i] = ((p[sel] * h[sel] ** (5 / 3)).sum() / psum) ** (3 / 5)
            if w is not None:
                w_el[i] = ((p[sel] * w[sel] ** (5 / 3)).sum() / psum) ** (3 / 5)
        else:
            h_el[i] = h.min() + (i + 0.5) * hstep
            if w is not None:
                w_el[i] = float(np.interp(h_el[i], h, w))

    if w is not None:
        return h_el, cn2_el, w_el
    return h_el, cn2_el


def HV57_Bufton_profile(N, w=21, A=1.7e-14, vg=8, vt=30, ht=9400.0, Lt=4800.0):
    """N-layer HV57 Cn2 + Bufton wind profile, compressed from 1 m bins."""
    h0 = np.arange(0, 30000)
    cn20 = HV57(h0, w, A)
    w0 = Bufton_wind(h0, vg, vt, ht, Lt)
    return equivalent_layers(h0, cn20, N, w=w0)


# ---------------------------------------------------------------------------
# Integrated atmospheric parameters (host side)
# ---------------------------------------------------------------------------


def cn2_to_r0(cn2, lamda=500e-9):
    """Fried parameter from integrated Cn2 dh [m^1/3]."""
    return (0.423 * (2 * np.pi / lamda) ** 2 * cn2) ** (-3.0 / 5.0)


def isoplanatic_angle(cn2, height, lamda=500e-9):
    """Isoplanatic angle [arcsec] from layered Cn2 dh and heights."""
    Jh = (np.asarray(cn2) * np.asarray(height) ** (5.0 / 3.0)).sum()
    iso = 0.057 * lamda ** (6.0 / 5.0) * Jh ** (-3.0 / 5.0)
    return iso * 180.0 * 3600.0 / np.pi


def coherence_time(cn2, v, lamda=500e-9):
    """Greenwood coherence time [s] from layered Cn2 dh and wind speeds."""
    Jv = (np.asarray(cn2) * np.asarray(v) ** (5.0 / 3.0)).sum()
    return 0.057 * lamda ** (6.0 / 5.0) * Jv ** (-3.0 / 5.0)


def rytov_variance(cn2, height, lamda=500e-9):
    """Plane-wave Rytov (log-amplitude) variance from layered Cn2 dh."""
    k = 2 * np.pi / lamda
    return 2.25 * k ** (7.0 / 6.0) * (
        np.asarray(cn2) * np.asarray(height) ** (5.0 / 6.0)).sum()


# ---------------------------------------------------------------------------
# von Karman spectrum (torch float64)
# ---------------------------------------------------------------------------


def _vonkarman(fabs, L0, l0, C=2 * np.pi):
    """The von Karman spectrum of unit Cn2 on the grid ``fabs`` (numpy or
    tensor), its infinite values (the DC pixel when ``L0 = inf``) zeroed."""
    if not torch.is_tensor(fabs):
        fabs = torch.as_tensor(np.asarray(fabs, dtype=np.float64))
    km = 5.92 / l0
    k0 = C / L0
    spec = 0.033 * torch.exp(-(fabs ** 2) / km ** 2) \
        / (fabs ** 2 + k0 ** 2) ** (11 / 6.0)
    return torch.where(torch.isinf(spec), 0.0, spec)


def turb_powerspectrum_vonKarman(freq, cn2, L0=25, l0=0.01, C=2 * np.pi):
    """Von Karman refractive-index power spectrum per layer.

    ``0.033 * cn2 * exp(-f^2/km^2) / (f^2 + k0^2)**(11/6)`` with
    ``km = 5.92/l0``, ``k0 = C/L0`` on the grid ``freq.fabs`` (numpy or
    tensor) of a frequency struct. Returns a stack with a leading layer
    axis (a scalar ``cn2`` gives one layer); a grid with
    ``freq.freq_per_layer`` already carries that axis. Infinite values
    (the DC pixel when ``L0 = inf``) are zeroed.
    """
    spec = _vonkarman(freq.fabs, L0, l0, C)
    if np.ndim(cn2) == 0:
        return spec[None] * cn2
    cn2 = torch.as_tensor(cn2, dtype=spec.dtype, device=spec.device)
    if getattr(freq, "freq_per_layer", False):
        return spec * cn2[(slice(None),) + (None,) * (spec.ndim - 1)]
    return spec[None] * cn2[(slice(None),) + (None,) * spec.ndim]
