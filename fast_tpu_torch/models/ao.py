"""AO residual power spectra in torch float64.

The port of ``fast_tpu.models.ao`` for the main and the subharmonic
frequency grids: the Zernike Fourier filters and the piston and tip/tilt
high-pass filters, the WFS-corrected mask and its complement, the
open-loop WFS noise and aliasing PSDs, the PAOLA anisoplanatism/servo-lag
transfer function and its closed-loop variant with the DM transfer
function. Each function takes a grid object with ``fx``, ``fy``,
``fabs``, ``fx_axis`` and ``fy_axis`` (numpy arrays or tensors) and returns
float64 tensors on the grid's device. A grid may carry leading axes (the
subharmonic levels: (levels, 3, 3) meshes over (levels, 3) axes), which
broadcast through; per-layer results put the layer axis first.

The JAX package's deliberate fixes of reference quirks are kept: WFS-noise
pixels where the sinc response vanishes are zeroed instead of becoming
``inf * 0 = nan``.
"""

import math

import numpy as np
import torch

from ..ops.bessel import besselj, quadrature_order
from ..ops.zernike import noll_to_nm
# turb_powerspectrum_vonKarman is a name of the reference's module
from .atmosphere import _vonkarman, turb_powerspectrum_vonKarman  # noqa

_F64 = torch.float64
# float64 points in torch's elementwise loop step on the CPU: two vectors of
# AVX-512 (AVX2's step of 8 divides it)
_LANES = 16


def _t(x):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=_F64)


def _per_layer(col, ndim):
    """A (nlayers,) column viewed against a grid of ``ndim`` axes."""
    return col[(slice(None),) + (None,) * ndim]


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


def _dc_fix(out, n_noll_start, value_piston=1.0, value_else=0.0):
    """``out`` with its DC pixel set: ``value_piston`` if the Noll range
    starts at piston, else ``value_else``."""
    out = out.clone()
    out[..., out.shape[-2] // 2, out.shape[-1] // 2] = (
        value_piston if n_noll_start == 1 else value_else)
    return out


def zernike_ft(fabs, phi, D, n_noll, x_max=None):
    """Fourier transform of the Noll-indexed Zernike polynomial ``n_noll``:
    complex128 (Noll 1976 eq. 25-26; reference
    ``fast/ao_power_spectra.py:10-21``)."""
    fabs, phi = _t(fabs), _t(phi)
    n, m = noll_to_nm(n_noll)
    R = _radial_terms(fabs, D, [n + 1], x_max=x_max)[..., 0]
    if m == 0:
        return (np.sqrt(n + 1) * (-1.0) ** (n / 2.0) * R).to(torch.complex128)
    prefac = np.sqrt(2 * (n + 1)) * (-1.0) ** ((n - m) / 2.0) * (1j) ** m
    az = torch.cos(m * phi) if n_noll % 2 == 0 else torch.sin(m * phi)
    return prefac * R.to(torch.complex128) * az


def zernike_filter(fabs, fx, fy, D, n_noll, n_noll_start=1, gamma=None):
    """Sum of the Zernike FTs of Noll indices ``n_noll_start..n_noll``,
    complex128, its DC pixel 1 if piston is included, else 0 (reference
    ``fast/ao_power_spectra.py:23-52``). ``gamma`` scales the aperture per
    entry, adding a leading axis."""
    fabs = _t(fabs)
    phi = torch.atan2(_t(fy), _t(fx))

    def accumulate(D_eff):
        out = torch.zeros(fabs.shape, dtype=torch.complex128)
        for j in range(n_noll_start, n_noll + 1):
            out = out + zernike_ft(fabs, phi, D_eff, j)
        return out

    if gamma is None:
        out = accumulate(D)
    else:
        out = torch.stack([accumulate(g * D) for g in np.atleast_1d(gamma)])
    return _dc_fix(out, n_noll_start)


def zernike_squared_filter(fabs, fx, fy, D, n_noll, n_noll_start=1,
                           gamma=None, plusminus=False, x_max=None):
    """``sum_j |FT Z_j|^2`` over Noll indices: the modal correction filter
    (reference ``fast/ao_power_spectra.py:54-95``). With ``plusminus``
    each term is ``Z_j(f) conj(Z_j(-f))``, ``(-1)^m`` times the plain
    one; ``gamma`` scales the aperture per entry, adding a leading axis."""
    return _dc_fix(_zernike_squared(fabs, fx, fy, D, n_noll, n_noll_start,
                                    gamma, plusminus, x_max), n_noll_start)


def _zernike_squared(fabs, fx, fy, D, n_noll, n_noll_start, gamma,
                     plusminus, x_max):
    """:func:`zernike_squared_filter` before its DC pixel is set."""
    phi = torch.atan2(fy, fx)
    terms = []
    for j in range(n_noll_start, n_noll + 1):
        n, m = noll_to_nm(j)
        terms.append((j, n, m))
    uniq = sorted({n + 1 for _, n, _ in terms})
    idx = {o: i for i, o in enumerate(uniq)}

    def accumulate(D_eff):
        R = _radial_terms(fabs, D_eff, uniq, x_max=x_max)
        out = torch.zeros_like(fabs)
        for j, n, m in terms:
            R2 = R[..., idx[n + 1]] ** 2
            if m == 0:
                term = (n + 1) * R2
            else:
                az = (torch.cos(abs(m) * phi) if j % 2 == 0
                      else torch.sin(abs(m) * phi))
                term = 2 * (n + 1) * R2 * az ** 2
            if plusminus:
                term = term * ((-1.0) ** m)
            out = out + term
        return out

    if gamma is None:
        return accumulate(D)
    return torch.stack([accumulate(g * D) for g in np.atleast_1d(gamma)])


def _bessel_highpass(fabs, D, orders, weights, dc, x_max):
    """``1 - sum_k (w_k J_{o_k}(x) / x)^2`` at ``x = fabs D / 2``, its DC
    pixel set to ``dc``: the piston and tip/tilt high-pass filters."""
    fabs = _t(fabs)
    x = fabs * D / 2
    if x_max is None:
        x_max = float(fabs.abs().max()) * D / 2
    J = besselj(list(orders), x, M=quadrature_order(x_max, max(orders)))
    xsafe = torch.where(x == 0, 1.0, x)
    filt = 1 - (weights[0] * J[..., 0] / xsafe) ** 2
    for k in range(1, len(orders)):
        filt = filt - (weights[k] * J[..., k] / xsafe) ** 2
    filt[..., filt.shape[-2] // 2, filt.shape[-1] // 2] = dc
    return filt


def piston_filter(fabs, D, x_max=None):
    """High-pass filter removing piston (reference
    ``fast/ao_power_spectra.py:104-107``), 0 at DC."""
    return _bessel_highpass(fabs, D, [1], [2], 0.0, x_max)


def tiptilt_filter(fabs, D, x_max=None):
    """High-pass filter removing tip/tilt (reference
    ``fast/ao_power_spectra.py:109-112``), 1 at DC."""
    return _bessel_highpass(fabs, D, [2], [4], 1.0, x_max)


def piston_tiptilt_filter(fabs, D, x_max=None):
    """High-pass filter removing piston and tip/tilt, 0 at DC."""
    return _bessel_highpass(fabs, D, [1, 2], [2, 4], 0.0, x_max)


def piston_gtilt_filter(fabs, fx, fy, D, x_max=None):
    """Piston + gradient-tilt low-pass (reference
    ``fast/ao_power_spectra.py:97-102``), at most 1."""
    pist = zernike_squared_filter(fabs, fx, fy, D, 1, x_max=x_max)
    if x_max is None:
        x_max = float(fabs.abs().max()) * D / 2
    G_tt = besselj([1], fabs * D / 2.0,
                   M=quadrature_order(x_max, 1))[..., 0] ** 2
    return torch.clamp(pist + G_tt, max=1.0)


def mask_lf(freq, d_WFS, modal=False, modal_mult=1, Zmax=None, D=None,
            Gtilt=False):
    """AO-corrected (low-frequency) region mask.

    Square WFS band ``|fx|,|fy| <= pi/d_WFS``, optionally intersected with
    the modal DM space: a radial cut (``Zmax is None``) or a Zernike
    attenuation filter in [0, 1], the piston + gradient-tilt one with
    ``Gtilt`` (reference ``fast/ao_power_spectra.py:119-141``).
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
    elif Gtilt:
        dm_space = piston_gtilt_filter(fabs, fx, fy, D)
    else:
        dm_space = zernike_squared_filter(fabs, fx, fy, D, Zmax)
    return wfs_space * torch.clamp(dm_space, max=1.0)


def mask_hf(freq, d_WFS, modal=False, modal_mult=1, Zmax=None, D=None,
            Gtilt=False):
    """High-frequency (uncorrected) mask: the complement of
    :func:`mask_lf` (the reference's ``fast/ao_power_spectra.py:143-146``
    would crash; ``fast_tpu`` fixed it the same way)."""
    return 1 - mask_lf(freq, d_WFS, modal=modal, modal_mult=modal_mult,
                       Zmax=Zmax, D=D, Gtilt=Gtilt)


def _band_box(lf_mask):
    """The rows and the columns of the last two axes that hold every
    non-zero point of ``lf_mask`` over all its leading axes: two slices,
    both empty for a mask with no non-zero point.

    The columns are widened to a multiple of ``_LANES`` (shifted left at the
    grid's edge), so that torch's elementwise kernels run every row of the
    box in whole vector steps, as they run a whole grid of such rows: a
    point's transcendental ops then take the same vector code, and give the
    same bits, as on the whole grid. A box that cannot be widened so is the
    whole grid.
    """
    nz = _t(lf_mask) != 0
    H, W = nz.shape[-2:]
    nz = nz.reshape(-1, H, W).any(0)
    rows = torch.nonzero(nz.any(1))[:, 0]
    cols = torch.nonzero(nz.any(0))[:, 0]
    if rows.numel() == 0:
        return slice(0, 0), slice(0, 0)
    c0, c1 = int(cols[0]), int(cols[-1]) + 1
    width = -(-(c1 - c0) // _LANES) * _LANES
    if width > W:
        return slice(0, H), slice(0, W)
    c0 = min(c0, W - width)
    return slice(int(rows[0]), int(rows[-1]) + 1), slice(c0, c0 + width)


def _box_point(box, i):
    """Index ``i`` of an axis in the box's slice ``box`` of that axis, or
    None outside it."""
    return i - box.start if box.start <= i < box.stop else None


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


def Jol_alias_openloop(freq, Dsubap, p, lf_mask, v=None, Delta_t=None,
                       wvl=None, lmax=3, kmax=3, L0=np.inf, l0=1e-6):
    """Open-loop WFS aliasing PSD (reference
    ``fast/ao_power_spectra.py:163-223``).

    Double sum over the ``(2*lmax+1) * (2*kmax+1) - 1`` folded frequency
    offsets ``(l, k)`` of shifted von Karman spectra with geometric
    gradient terms, then the servo sinc of the winds ``v`` (none without
    them) over ``Delta_t`` (0 if None). On the shared main grid every
    term is linear in the layer's Cn2 with a layer-independent shape, so
    the loop accumulates one unit-Cn2 field and scales per layer at the
    end (the same order of sums as the JAX package's ``lax.scan``).
    ``wvl`` is the reference's argument; the spectrum does not depend on
    it (``fast_tpu`` reads it nowhere either).

    The sum is evaluated on the box of ``lf_mask``'s support alone
    (:func:`_band_box`) and is 0 outside it, where the mask zeroes it: the
    same bits as the whole grid's evaluation, at the box's share of its
    cost.
    """
    fx, fy, fabs = _t(freq.fx), _t(freq.fy), _t(freq.fabs)
    fx_axis, fy_axis = _t(freq.fx_axis), _t(freq.fy_axis)
    lf_mask = _t(lf_mask)
    p = _t(p).reshape(-1)
    v = torch.zeros((p.shape[0], 2), dtype=_F64) if v is None \
        else _t(v).reshape(-1, 2)
    Delta_t = 0.0 if Delta_t is None else Delta_t
    shape = np.broadcast_shapes(p.shape + fabs.shape, lf_mask.shape)
    mid2, mid1 = fx.shape[-2] // 2, fy.shape[-1] // 2
    rows, cols = _band_box(lf_mask)
    box = (Ellipsis, rows, cols)
    fx, fy, fabs, lf_mask = fx[box], fy[box], fabs[box], lf_mask[box]
    fx_axis, fy_axis = fx_axis[..., cols], fy_axis[..., rows]
    # unrotated axis meshes (the reference shifts the axes)
    X = fx_axis[..., None, :] * torch.ones_like(fy_axis)[..., :, None]
    Y = torch.ones_like(fx_axis)[..., None, :] * fy_axis[..., :, None]

    v_dot_kappa = (fx[None] * _per_layer(v[:, 0], fx.ndim)
                   + fy[None] * _per_layer(v[:, 1], fy.ndim))
    sinc_term = torch.sinc(Delta_t * v_dot_kappa / (2 * np.pi)) ** 2

    fabs_safe = torch.where(fabs == 0, 1.0, fabs)
    term_0 = fx ** 2 * fy ** 2 / fabs_safe ** 4
    # the grid's zero row, column and DC pixel where the box holds them, as
    # masks of the last two axes broadcast over any leading ones
    r, c = _box_point(rows, mid2), _box_point(cols, mid1)
    row_mask = torch.zeros(fx.shape[-2:], dtype=_F64)
    col_mask = torch.zeros(fx.shape[-2:], dtype=_F64)
    dc_mask = torch.zeros(fx.shape[-2:], dtype=_F64)
    if r is not None:
        row_mask[r, :] = 1.0
    if c is not None:
        col_mask[:, c] = 1.0
    if r is not None and c is not None:
        dc_mask[r, c] = 1.0

    acc = torch.zeros((1,) + fabs.shape, dtype=_F64)
    for l in range(-lmax, lmax + 1):
        for k in range(-kmax, kmax + 1):
            if l == 0 and k == 0:
                continue
            Xs = X - 2 * np.pi * float(k) / Dsubap
            Ys = Y - 2 * np.pi * float(l) / Dsubap
            term_2 = _vonkarman(torch.sqrt(Xs ** 2 + Ys ** 2), L0, l0)
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
    alias = acc * _per_layer(p, fabs.ndim)
    alias = alias * sinc_term * lf_mask
    out = torch.zeros(shape, dtype=_F64)
    out[box] = torch.nan_to_num(alias, nan=0.0, posinf=0.0, neginf=0.0)
    return out


def G_AO_PAOLA(freq, mask, mode="AO", h=None, v=None, dtheta=(0, 0), Tx=None,
               wvl=None, Zmax=None, tl=0, Delta_t=0, Dsubap=None, modal=False,
               modal_mult=1, x_max=None):
    """Open-loop AO residual transfer function (PAOLA model).

    ``1 - 2 cos(dr.kappa - tl v.kappa) sinc(Dt v.kappa / 2pi) + sinc^2``
    per layer (``v.kappa = 0`` without winds), applied inside the
    corrected mask and passed through outside. LGSAO blends a
    tip-tilt-only variant through a Z<=4 Zernike filter. Reference
    ``fast/ao_power_spectra.py:225-270``. ``wvl``, ``Zmax``, ``Dsubap``,
    ``modal`` and ``modal_mult`` are the reference's arguments; the
    function does not depend on them (``fast_tpu`` reads them nowhere
    either).

    The transfer function is evaluated on the box of ``mask``'s support
    alone (:func:`_band_box`) and is 1 outside it, where the mask passes
    it through: the same bits as the whole grid's evaluation. LGSAO's
    Zernike filter keeps the whole grid's ``x_max``, and so its quadrature.
    """
    if mode not in ("NOAO", "AO", "TT", "LGSAO"):
        raise ValueError(
            'Mode not recognised, note that "AO_PA", "TT_PA" and "LGS_PA" '
            'are now "AO" and "TT" and "LGSAO')
    if mode == "NOAO":
        return 1.0
    fx, fy, fabs = _t(freq.fx), _t(freq.fy), _t(freq.fabs)
    mask = _t(mask)
    if mode == "LGSAO" and x_max is None:
        # the whole grid's, as zernike_squared_filter reads it there
        x_max = float(fabs.abs().max()) * Tx / 2
    h = _t(h).reshape(-1)
    shape = np.broadcast_shapes(h.shape + fx.shape, mask.shape)
    box = (Ellipsis,) + _band_box(mask)
    fx, fy, fabs, mask = fx[box], fy[box], fabs[box], mask[box]
    dtheta = _t(dtheta)
    dr = dtheta[None, :] / 206265.0 * h[:, None]  # (nlayers, 2)
    dr_dot_kappa = (fx[None] * _per_layer(dr[:, 0], fx.ndim)
                    + fy[None] * _per_layer(dr[:, 1], fy.ndim))
    if v is None:
        v_dot_kappa = torch.zeros((), dtype=_F64)
    else:
        v = _t(v).reshape(-1, 2)
        v_dot_kappa = (fx[None] * _per_layer(v[:, 0], fx.ndim)
                       + fy[None] * _per_layer(v[:, 1], fy.ndim))

    term_1 = 2 * torch.cos(dr_dot_kappa - tl * v_dot_kappa)
    term_2 = torch.sinc(Delta_t * v_dot_kappa / (2 * math.pi))
    aniso = 1 - term_1 * term_2 + term_2 ** 2
    out = torch.ones(shape, dtype=_F64)
    if mode in ("AO", "TT"):
        out[box] = aniso * mask + (1 - mask)
        return out
    term_1_lgs = 2 * torch.cos(-tl * v_dot_kappa)
    aniso_lgs = 1 - term_1_lgs * term_2 + term_2 ** 2
    # the filter's DC pixel is left unset: both aniso terms are 0 there
    Z = _zernike_squared(fabs, fx, fy, Tx, 4, 1, None, False, x_max)
    out[box] = mask * (Z * aniso + (1 - Z) * aniso_lgs) + (1 - mask)
    return out


def DM_transfer_function(fx, fy, fabs, mode, Zmax=None, D=None, dsubap=None):
    """DM spatial transfer function: 1 for ``'perfect'``, the Zernike
    filter up to ``Zmax`` for ``'zernike'``. ``dsubap`` is the reference's
    argument; neither mode reads it."""
    if mode == "perfect":
        return 1.0
    if mode == "zernike":
        return zernike_filter(fabs, fx, fy, D, Zmax)
    raise NotImplementedError("Choose DM that is implemented")


def G_AO_PAOLA_closedloop(fx, fy, fabs, h, dtheta=(0, 0), Delta_t=0.0, tl=0.0,
                          gloop=1.0, v=None, dsubap=None, DM="perfect",
                          Zmax=None, D=None, nu=1, modal=False, modal_mult=1):
    """Closed-loop integrator variant of the PAOLA transfer function
    (reference ``fast/ao_power_spectra.py:314-357``, which the engine never
    calls), per layer; frequencies are converted to linear units as there.
    Complex with a ``'zernike'`` DM. ``modal`` and ``modal_mult`` are the
    reference's arguments; the function does not read them."""
    Gamma_DM = DM_transfer_function(fx, fy, fabs, mode=DM, Zmax=Zmax, D=D,
                                    dsubap=dsubap)
    fx = _t(fx) / (2 * np.pi)
    fy = _t(fy) / (2 * np.pi)
    h = _t(h).reshape(-1)
    dtheta = _t(dtheta)
    dr = dtheta[None, :] / 206265.0 * h[:, None]  # (nlayers, 2)
    dr_dot_f = (fx[None] * _per_layer(dr[:, 0], fx.ndim)
                + fy[None] * _per_layer(dr[:, 1], fy.ndim))
    if v is None:
        v_dot_f = torch.zeros((), dtype=_F64)
    else:
        v = _t(v).reshape(-1, 2)
        v_dot_f = (fx[None] * _per_layer(v[:, 0], fx.ndim)
                   + fy[None] * _per_layer(v[:, 1], fy.ndim))

    two_pi = 2 * np.pi
    sinc = torch.sinc(Delta_t * v_dot_f)
    lead = torch.cos(two_pi * (Delta_t / 2 + tl) * v_dot_f)
    lag = torch.cos(two_pi * (Delta_t / 2.0 - tl) * v_dot_f)
    top = (1 + gloop ** 2 * Gamma_DM ** 2 * sinc ** 2
           * (1 + nu ** 2 * Gamma_DM ** 2) / 2.0
           - torch.cos(two_pi * Delta_t * v_dot_f)
           + gloop * Gamma_DM ** 2 * sinc * nu
           * (torch.cos(two_pi * dr_dot_f
                        + two_pi * (Delta_t / 2 - tl) * v_dot_f)
              - torch.cos(two_pi * dr_dot_f
                          - two_pi * (Delta_t / 2 + tl) * v_dot_f))
           + gloop * Gamma_DM * sinc * (lead - lag)
           - gloop ** 2 * Gamma_DM ** 3 * sinc ** 2 * nu
           * torch.cos(two_pi * dr_dot_f))
    bottom = (1 + gloop ** 2 * Gamma_DM ** 2 * sinc ** 2 / 2.0
              + gloop * Gamma_DM * sinc * (lead - lag)
              - torch.cos(two_pi * Delta_t * v_dot_f))
    return top / bottom
