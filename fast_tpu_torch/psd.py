"""Power-spectral-density assembly, in torch float64.

Everything ``fast_tpu.psd`` computes, term by term: on the main grid
(:func:`assemble_main`) von Karman turbulence per layer, the PAOLA AO
transfer function, the aliasing and WFS-noise PSDs, the residual per-layer
and total spectra, every error-budget integral (Simpson) and the
log-amplitude PSD; on the subharmonic grids (:func:`assemble_subharm`) the
same residual spectra and their per-level variances. It runs once per
configuration on the CPU and is never on the Monte Carlo hot path.

The AO-band terms (the aliasing PSD and the PAOLA transfer function) are
evaluated on the box of the corrected mask's support alone, with the same
bits as on the whole grid; ``Fast.psd_band_share`` is the share of the
main grid's points they were evaluated on (1.0 for a box that is the whole
grid, 0.0 without AO).
"""

import types

import numpy as np
import torch

from .models import ao as ao_spectra
from .models import atmosphere
from .models.scintillation import logamp_powerspec
from .ops.integrate import integrate_path, integrate_powerspectrum

_F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=_F64)


def _residual_stack(fr, lf_mask, cn2, h, wind_vector, dtheta, noise, Dsubap,
                    texp, tloop, wvl, D_ground, L0, l0, *, mode, alias_on,
                    noise_on, lmax, kmax, x_max):
    """turb, G_ao, alias, noise and the per-layer residual PSD on the grid
    ``fr`` (``fast_tpu.psd._residual_stack``)."""
    k = 2 * np.pi / wvl
    nlayers = len(np.atleast_1d(h))

    turb = atmosphere.turb_powerspectrum_vonKarman(fr, cn2, L0, l0)
    G_ao = ao_spectra.G_AO_PAOLA(
        fr, lf_mask, mode, h, wind_vector, dtheta, D_ground, tl=tloop,
        Delta_t=texp, x_max=x_max)
    ao_on = mode != "NOAO"
    if alias_on and ao_on:
        alias_ps = ao_spectra.Jol_alias_openloop(
            fr, Dsubap, cn2, lf_mask, wind_vector, texp, lmax=lmax,
            kmax=kmax, L0=L0, l0=l0)
    else:
        alias_ps = torch.zeros_like(turb)
    if noise_on and ao_on:
        noise_ps = ao_spectra.Jol_noise_openloop(fr, Dsubap, noise, lf_mask)
    else:
        noise_ps = torch.zeros_like(fr.fabs)

    ps_per_layer = (2 * np.pi * k ** 2 * (turb * G_ao + alias_ps)
                    + noise_ps / nlayers)
    return turb, G_ao, alias_ps, noise_ps, ps_per_layer


def _grid(fx, fy, fabs, fx_axis, fy_axis):
    return types.SimpleNamespace(fx=_t(fx), fy=_t(fy), fabs=_t(fabs),
                                 fx_axis=_t(fx_axis), fy_axis=_t(fy_axis),
                                 freq_per_layer=False)


def assemble_main(fx, fy, fabs, fx_axis, fy_axis, f_grid, lf_mask, hf_mask,
                  pupil_filter, cn2, h, wind_vector, dtheta, noise, Dsubap,
                  texp, tloop, wvl, D_ground, L0, l0, *, mode, alias_on,
                  noise_on, lmax=5, kmax=5, x_max=None):
    """Main-grid PSD assembly and all error-budget integrals.

    Same arguments as ``fast_tpu.psd.assemble_main`` (numpy arrays or
    floats); returns a dict of float64 tensors with the same keys.
    """
    fr = _grid(fx, fy, fabs, fx_axis, fy_axis)
    f_grid, lf_mask, hf_mask = _t(f_grid), _t(lf_mask), _t(hf_mask)
    pupil_filter = _t(pupil_filter)
    cn2 = np.asarray(cn2, dtype=np.float64)
    k = 2 * np.pi / wvl
    ao_on = mode != "NOAO"

    turb, G_ao, alias_ps, noise_ps, ps_per_layer = _residual_stack(
        fr, lf_mask, cn2, h, wind_vector, dtheta, noise, Dsubap, texp, tloop,
        wvl, D_ground, L0, l0, mode=mode, alias_on=alias_on,
        noise_on=noise_on, lmax=lmax, kmax=kmax, x_max=x_max)
    powerspec = ps_per_layer.sum(0)

    zero = torch.zeros((), dtype=_F64)
    aniso_servo_error = integrate_powerspectrum(
        integrate_path(G_ao * turb) * lf_mask * 2 * np.pi * k ** 2, f_grid)
    alias_error = (integrate_powerspectrum(
        integrate_path(alias_ps * 2 * np.pi * k ** 2), f_grid)
        if alias_on and ao_on else zero)
    noise_error = (integrate_powerspectrum(noise_ps, f_grid)
                   if noise_on and ao_on else zero)
    fitting_error = integrate_powerspectrum(powerspec * hf_mask, f_grid)
    phs_var = integrate_powerspectrum(powerspec, f_grid)
    phs_var_weights = integrate_powerspectrum(ps_per_layer, f_grid) / phs_var

    logamp_ps = logamp_powerspec(fr, h, cn2, wvl, pupil_filter,
                                 L0=L0, l0=l0)
    logamp_var = integrate_powerspectrum(logamp_ps, f_grid)

    return dict(
        powerspec=powerspec, aniso_servo_error=aniso_servo_error,
        alias_error=alias_error, noise_error=noise_error,
        fitting_error=fitting_error, phs_var=phs_var,
        phs_var_weights=phs_var_weights, logamp_powerspec=logamp_ps,
        logamp_var=logamp_var, turb_powerspec=turb,
        G_ao=torch.as_tensor(G_ao, dtype=_F64), alias_powerspec=alias_ps,
        noise_powerspec=noise_ps, powerspec_per_layer=ps_per_layer)


def assemble_subharm(fx, fy, fabs, fx_axis, fy_axis, df_levels, lf_mask_sh,
                     cn2, h, wind_vector, dtheta, noise, Dsubap, texp, tloop,
                     wvl, D_ground, L0, l0, *, mode, alias_on, noise_on,
                     lmax=5, kmax=5, x_max=None):
    """Subharmonic PSD assembly on the (levels, 3, 3) grids.

    Same arguments as ``fast_tpu.psd.assemble_subharm``; the per-level
    variances use the ``df^2`` point weights of each level. Returns a dict
    of float64 tensors with the same keys.
    """
    fr = _grid(fx, fy, fabs, fx_axis, fy_axis)
    *_, ps_per_layer = _residual_stack(
        fr, _t(lf_mask_sh), np.asarray(cn2, dtype=np.float64), h,
        wind_vector, dtheta, noise, Dsubap, texp, tloop, wvl, D_ground, L0,
        l0, mode=mode, alias_on=alias_on, noise_on=noise_on, lmax=lmax,
        kmax=kmax, x_max=x_max)
    powerspec_sh = ps_per_layer.sum(0)
    phs_var_sh = ps_per_layer.sum((-1, -2)) * _t(df_levels) ** 2
    weights_sh = phs_var_sh / phs_var_sh.sum()
    return dict(powerspec_subharm_per_layer=ps_per_layer,
                powerspec_subharm=powerspec_sh, phs_var_subharm=phs_var_sh,
                phs_var_weights_sh=weights_sh)
