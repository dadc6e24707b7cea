"""Reference-compatible function surface (``fast/funcs.py``).

Users of the reference import numerics from ``fast.funcs``; this module
exposes the names of ``fast_tpu.funcs`` backed by the port's
implementations in :mod:`fast_tpu_torch.ops`, :mod:`fast_tpu_torch.models`
and :mod:`fast_tpu_torch.synthesis`. Random draws take an explicit
``torch.Generator`` (where ``fast_tpu`` takes a JAX key) and land on the
generator's device; the screen constructors return tensors on the device
of their coefficients.
"""

import numpy as np
import torch

from .models.atmosphere import turb_powerspectrum_vonKarman  # noqa: F401
from .ops.apertures import (  # noqa: F401
    circle,
    gaussian2d,
    compute_pupil,
    compute_gaussian_mode,
    coupling_loss,
    optimize_fibre,
)
from .ops.apertures import pupil_filter as _pupil_filter_ndarray
from .ops.integrate import integrate_path, integrate_powerspectrum  # noqa: F401
from .ops.rng import complex_normal
from .engine import l_path, calculate_wind_correction  # noqa: F401
from .interop import as_torch_dtype
from .synthesis import draw_logamp
from .models.scintillation import PupilFilterSampler


def _freq_tuple(axis):
    """Reference-shaped ``(fx, fy, fabs, axis)`` tuple from a 1-D axis."""
    fx, fy = np.meshgrid(axis, axis)
    return fx, fy, np.hypot(fx, fy), axis


def f_grid_linear(L0, l0, max_size=1024):
    """Linearly spaced frequency grid bounded by outer/inner scale."""
    df = 2 * np.pi / L0
    fmax = 2 * 5.92 / l0  # inner-scale cutoff ``km = 5.92/l0``, doubled
    if 2 * fmax / df + 1 > max_size:
        fmax = max_size * df / 2
    return _freq_tuple(np.arange(-fmax, fmax, df))


def f_grid_dx(N, dx):
    """Frequency grid from real-space size and sampling (the main-grid rule)."""
    from .grids import _centered_axis
    return _freq_tuple(_centered_axis(N, 2 * np.pi / (N * dx)))


def f_grid_log(L0, l0, N=129, include_0=True):
    """Logarithmically spaced frequency grid between pi/L0 and 4*pi/l0."""
    half = N // 2 if N % 2 == 0 else (N - 1) // 2
    side = np.logspace(np.log10(np.pi / L0), np.log10(4 * np.pi / l0), half)
    parts = ([-side[::-1], [0.0], side] if include_0
             else [-side[::-1], side])
    return _freq_tuple(np.concatenate(parts))


def calc_gaussian_beam_parameters(z, F_0, W_0, wvl):
    """Andrews & Phillips ch. 12 eq. 8-9 beam parameters."""
    k = 2 * np.pi / wvl
    Theta_0 = 1 - z / F_0
    Lambda_0 = 2 * z / (k * W_0 ** 2)
    Theta = Theta_0 / (Theta_0 ** 2 + Lambda_0 ** 2)
    Theta_bar = 1 - Theta
    Lambda = Lambda_0 / (Theta_0 ** 2 + Lambda_0 ** 2)
    return Theta_0, Lambda_0, Theta, Lambda, Theta_bar


def pdf_lognorm(Is, sigma, Imn=1):
    """Log-normal intensity PDF."""
    scint = sigma ** 2
    return 1 / (Is * np.sqrt(scint * 2 * np.pi)) * np.exp(
        -((np.log(Is / Imn) + 0.5 * scint) ** 2) / (2 * scint))


def pdf_gammagamma(Is, alpha, beta):
    """Gamma-gamma irradiance PDF (Andrews & Phillips) of unit-mean
    irradiance, ``2 (ab)^((a+b)/2) / (Gamma(a) Gamma(b)) I^((a+b)/2 - 1)
    K_{a-b}(2 sqrt(a b I))`` (the reference left it unimplemented,
    ``fast/funcs.py:202-208``)."""
    from scipy.special import gamma as _gamma, kv as _kv

    Is = np.asarray(Is, dtype=float)
    ab = alpha * beta
    order = alpha - beta
    pref = 2 * ab ** ((alpha + beta) / 2) / (_gamma(alpha) * _gamma(beta))
    return (pref * Is ** ((alpha + beta) / 2 - 1)
            * _kv(order, 2 * np.sqrt(ab * Is)))


def gammagamma_parameters(rytov_var_spherical):
    """Large/small-scale scintillation parameters (alpha, beta) from the
    spherical-wave Rytov variance (Andrews & Phillips ch. 9)."""
    s2 = rytov_var_spherical
    alpha = 1 / (np.exp(0.49 * s2 / (1 + 1.11 * s2 ** (6 / 5)) ** (7 / 6)) - 1)
    beta = 1 / (np.exp(0.51 * s2 / (1 + 0.69 * s2 ** (6 / 5)) ** (5 / 6)) - 1)
    return alpha, beta


def pupil_filter(freq, pupil, spline=False):
    """Pupil spatial filter (numpy); ``spline=True`` returns a bilinear
    resampler over ``freq``'s axes."""
    P = _pupil_filter_ndarray(np.asarray(pupil))
    if spline:
        return PupilFilterSampler(P, freq.fx_axis, freq.fy_axis)
    return P


def generate_random_coefficients(generator, shape, dtype=np.complex128):
    """Standard complex normal coefficients from ``generator``, on its
    device."""
    return complex_normal(shape, generator, dtype=as_torch_dtype(dtype))


def generate_random_coefficients_logamp(generator, Nscrns, powerspec,
                                        temporal=False,
                                        temporal_powerspecs=None):
    """Float64 log-amplitude draws from ``generator``; see
    :func:`fast_tpu_torch.synthesis.draw_logamp`."""
    return draw_logamp(
        generator, Nscrns, powerspec,
        temporal_powerspec=temporal_powerspecs if temporal else None,
        dtype=torch.float64)


def make_phase_fft(rand, df, double=False):
    """Phase screens from pre-coloured Fourier coefficients.

    Reference-parity wrapper (``fast/funcs.py:210-223``): ``rand`` already
    carries ``sqrt(PSD)``; this applies the centred inverse FFT scaling.
    ``double`` stacks the imaginary parts after the real ones.
    """
    from .ops.fourier import ift2
    scr = ift2(torch.as_tensor(rand) * df, 1.0)
    if double:
        return torch.cat([scr.real, scr.imag], dim=0)
    return scr.real


def make_phase_subharm(rand, freq, N, dx, double=False):
    """Low-order subharmonic screens from pre-coloured coefficients.

    Reference-parity wrapper (``fast/funcs.py:225-258``): explicit mode sum
    over the 3-level 3x3 subharmonic grids, mean-subtracted.
    """
    from .synthesis import make_subharm_modes
    rand = torch.as_tensor(rand)
    modes = torch.from_numpy(make_subharm_modes(
        freq.subharm.fx, freq.subharm.fy, N, dx)).to(rand.device)
    df = torch.as_tensor(np.asarray(freq.subharm.df), device=rand.device)
    weights = rand * df[:, None, None]
    scr = torch.einsum("bimn,imnxy->bxy", weights.to(modes.dtype), modes)
    scr = scr - scr.mean(dim=(-2, -1), keepdim=True)
    if double:
        return torch.cat([scr.real, scr.imag], dim=0)
    return scr.real


def temporal_autocorrelation(I):
    """Mean-removed autocorrelation of an intensity time series."""
    Icp = np.asarray(I) - np.asarray(I).mean()
    corr = np.correlate(Icp, Icp, mode="full")
    return corr[len(Icp) - 1:] / len(Icp)
