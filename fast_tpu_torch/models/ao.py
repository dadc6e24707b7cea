"""AO residual power spectra in torch float64.

The port of ``fast_tpu.models.ao`` for the main frequency grid: the
Zernike Fourier filters, the WFS-corrected mask, the open-loop WFS noise
and aliasing PSDs and the PAOLA anisoplanatism/servo-lag transfer
function. Each function takes a grid object with ``fx``, ``fy``,
``fabs``, ``fx_axis`` and ``fy_axis`` (numpy arrays or tensors) and returns
float64 tensors on the grid's device.

The JAX package's deliberate fixes of reference quirks are kept: WFS-noise
pixels where the sinc response vanishes are zeroed instead of becoming
``inf * 0 = nan``.
"""

import math

import numpy as np
import torch

from ..ops.bessel import besselj, quadrature_order
from ..ops.zernike import noll_to_nm
from .atmosphere import turb_powerspectrum_vonKarman

_F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=_F64)


def _radial_terms(fabs, D, orders, x_max=None):
    """``2*J_{n+1}(f D/2) / (f D/2)`` for each radial order in ``orders``.

    Shape ``fabs.shape + (len(orders),)``; the ``fabs == 0`` pixel is
    fixed up by the caller.
    """
    x = fabs * D / 2
    if x_max is None:
        x_max = float(fabs.abs().max()) * D / 2
    M = quadrature_order(x_max, int(max(orders)))
    J = besselj(list(orders), x, M=M)
    xsafe = torch.where(x == 0, 1.0, x)
    return 2 * J / xsafe[..., None]


def _dc_fix(out, n_noll_start):
    out = out.clone()
    out[..., out.shape[-2] // 2, out.shape[-1] // 2] = (
        1.0 if n_noll_start == 1 else 0.0)
    return out


def zernike_squared_filter(fabs, fx, fy, D, n_noll, n_noll_start=1,
                           x_max=None):
    """``sum_j |FT Z_j|^2`` over Noll indices: the modal correction filter
    (reference ``fast/ao_power_spectra.py:54-95``)."""
    phi = torch.atan2(fy, fx)
    terms = []
    for j in range(n_noll_start, n_noll + 1):
        n, m = noll_to_nm(j)
        terms.append((j, n, m))
    uniq = sorted({n + 1 for _, n, _ in terms})
    R = _radial_terms(fabs, D, uniq, x_max=x_max)
    idx = {o: i for i, o in enumerate(uniq)}
    out = torch.zeros_like(fabs)
    for j, n, m in terms:
        R2 = R[..., idx[n + 1]] ** 2
        if m == 0:
            term = (n + 1) * R2
        else:
            az = (torch.cos(abs(m) * phi) if j % 2 == 0
                  else torch.sin(abs(m) * phi))
            term = 2 * (n + 1) * R2 * az ** 2
        out = out + term
    return _dc_fix(out, n_noll_start)


def mask_lf(freq, d_WFS, modal=False, modal_mult=1, Zmax=None, D=None):
    """AO-corrected (low-frequency) region mask.

    Square WFS band ``|fx|,|fy| <= pi/d_WFS``, optionally intersected with
    the modal DM space: a radial cut (``Zmax is None``) or a Zernike
    attenuation filter in [0, 1] (reference
    ``fast/ao_power_spectra.py:119-141``).
    """
    fx = _t(freq.fx)
    fy = _t(freq.fy)
    fmax = np.pi / d_WFS
    wfs_space = ((fx.abs() <= fmax) & (fy.abs() <= fmax)).to(_F64)
    if not modal:
        return wfs_space
    fabs = torch.sqrt(fx ** 2 + fy ** 2)
    if Zmax is None:
        dm_space = (fabs <= fmax * modal_mult).to(_F64)
    else:
        dm_space = zernike_squared_filter(fabs, fx, fy, D, Zmax)
    return wfs_space * torch.clamp(dm_space, max=1.0)


def Jol_noise_openloop(freq, Dsubap, noise_variance, lf_mask):
    """Open-loop WFS noise PSD inside the corrected band.

    ``N / (f^2 sinc^2(d fx / 2pi) sinc^2(d fy / 2pi))``, DC zeroed
    (reference ``fast/ao_power_spectra.py:148-161``).
    """
    fabs, fx, fy = _t(freq.fabs), _t(freq.fx), _t(freq.fy)
    denom = (fabs ** 2
             * torch.sinc(Dsubap * fx / (2 * np.pi)) ** 2
             * torch.sinc(Dsubap * fy / (2 * np.pi)) ** 2)
    ps = torch.where(denom > 0,
                     noise_variance / torch.where(denom > 0, denom, 1.0), 0.0)
    ps[..., ps.shape[-2] // 2, ps.shape[-1] // 2] = 0.0
    return lf_mask * ps


def Jol_alias_openloop(freq, Dsubap, p, lf_mask, v, Delta_t, lmax=3, kmax=3,
                       L0=np.inf, l0=1e-6):
    """Open-loop WFS aliasing PSD (reference
    ``fast/ao_power_spectra.py:163-223``).

    Double sum over the ``(2*lmax+1) * (2*kmax+1) - 1`` folded frequency
    offsets ``(l, k)`` of shifted von Karman spectra with geometric
    gradient terms, then the servo sinc. On the shared main grid every
    term is linear in the layer's Cn2 with a layer-independent shape, so
    the loop accumulates one unit-Cn2 field and scales per layer at the
    end (the same order of sums as the JAX package's ``lax.scan``).
    """
    fx, fy, fabs = _t(freq.fx), _t(freq.fy), _t(freq.fabs)
    fx_axis, fy_axis = _t(freq.fx_axis), _t(freq.fy_axis)
    p = _t(p).reshape(-1)
    v = _t(v).reshape(-1, 2)
    mid2, mid1 = fx.shape[-2] // 2, fy.shape[-1] // 2
    # unrotated axis meshes (the reference shifts the axes)
    X = fx_axis[None, :] * torch.ones_like(fy_axis)[:, None]
    Y = torch.ones_like(fx_axis)[None, :] * fy_axis[:, None]

    v_dot_kappa = fx[None] * v[:, 0, None, None] + fy[None] * v[:, 1, None, None]
    sinc_term = torch.sinc(Delta_t * v_dot_kappa / (2 * np.pi)) ** 2

    fabs_safe = torch.where(fabs == 0, 1.0, fabs)
    term_0 = fx ** 2 * fy ** 2 / fabs_safe ** 4
    row_mask = torch.zeros_like(fx)
    row_mask[mid2, :] = 1.0
    col_mask = torch.zeros_like(fx)
    col_mask[:, mid1] = 1.0
    dc_mask = torch.zeros_like(fx)
    dc_mask[mid2, mid1] = 1.0

    acc = torch.zeros((1,) + fabs.shape, dtype=_F64)
    for l in range(-lmax, lmax + 1):
        for k in range(-kmax, kmax + 1):
            if l == 0 and k == 0:
                continue
            Xs = X - 2 * np.pi * float(k) / Dsubap
            Ys = Y - 2 * np.pi * float(l) / Dsubap
            term_2 = turb_powerspectrum_vonKarman(
                torch.sqrt(Xs ** 2 + Ys ** 2), 1.0, L0=L0, l0=l0)
            Ys_safe = torch.where(Ys == 0, 1.0, Ys)
            Xs_safe = torch.where(Xs == 0, 1.0, Xs)
            term_1 = (fx / Ys_safe + fy / Xs_safe) ** 2
            mult = term_1 * term_2 * term_0
            mult = mult * (1 - dc_mask)
            if l == 0:
                mult = mult * (1 - row_mask) + term_2 * row_mask
            if k == 0:
                mult = mult * (1 - col_mask) + term_2 * col_mask
            acc = acc + mult
    alias = acc * p[:, None, None]
    alias = alias * sinc_term * lf_mask
    return torch.nan_to_num(alias, nan=0.0, posinf=0.0, neginf=0.0)


def G_AO_PAOLA(freq, mask, mode="AO", h=None, v=None, dtheta=(0, 0), Tx=None,
               tl=0, Delta_t=0, x_max=None):
    """Open-loop AO residual transfer function (PAOLA model).

    ``1 - 2 cos(dr.kappa - tl v.kappa) sinc(Dt v.kappa / 2pi) + sinc^2``
    per layer, applied inside the corrected mask and passed through
    outside. LGSAO blends a tip-tilt-only variant through a Z<=4 Zernike
    filter. Reference ``fast/ao_power_spectra.py:225-270``.
    """
    if mode not in ("NOAO", "AO", "TT", "LGSAO"):
        raise ValueError(
            'Mode not recognised, note that "AO_PA", "TT_PA" and "LGS_PA" '
            'are now "AO" and "TT" and "LGSAO')
    if mode == "NOAO":
        return 1.0
    fx, fy, fabs = _t(freq.fx), _t(freq.fy), _t(freq.fabs)
    h = _t(h).reshape(-1)
    dtheta = _t(dtheta)
    dr = dtheta[None, :] / 206265.0 * h[:, None]  # (nlayers, 2)
    dr_dot_kappa = fx[None] * dr[:, 0, None, None] + fy[None] * dr[:, 1, None, None]
    v = _t(v).reshape(-1, 2)
    v_dot_kappa = fx[None] * v[:, 0, None, None] + fy[None] * v[:, 1, None, None]

    term_1 = 2 * torch.cos(dr_dot_kappa - tl * v_dot_kappa)
    term_2 = torch.sinc(Delta_t * v_dot_kappa / (2 * math.pi))
    aniso = 1 - term_1 * term_2 + term_2 ** 2
    if mode in ("AO", "TT"):
        return aniso * mask + (1 - mask)
    term_1_lgs = 2 * torch.cos(-tl * v_dot_kappa)
    aniso_lgs = 1 - term_1_lgs * term_2 + term_2 ** 2
    Z = zernike_squared_filter(fabs, fx, fy, Tx, 4, n_noll_start=1,
                               x_max=x_max)
    return mask * (Z * aniso + (1 - Z) * aniso_lgs) + (1 - mask)
