"""Numerical building blocks of the port: FFT conventions, integration,
Bessel functions, apertures, random numbers and the wrappers of the CUDA
kernels (imported from their own modules, which build at first use;
:func:`kernel_wrappers` names them). The re-exports are
``fast_tpu.ops``'s."""

from . import apertures, bessel, fourier, integrate, interp, rng, zernike
from .apertures import (circle, compute_gaussian_mode, compute_pupil,
                        coupling_loss, gaussian2d, optimize_fibre,
                        pupil_filter)
from .bessel import besselj
from .fourier import ft, ft2, ift, ift2
from .integrate import integrate_path, integrate_powerspectrum, simpson
from .zernike import noll_to_nm

__all__ = [
    "fourier", "integrate", "bessel", "zernike", "apertures", "interp", "rng",
    "ft", "ift", "ft2", "ift2",
    "simpson", "integrate_powerspectrum", "integrate_path",
    "besselj", "noll_to_nm",
    "circle", "gaussian2d", "compute_pupil", "compute_gaussian_mode",
    "pupil_filter", "optimize_fibre", "coupling_loss",
]


def kernel_wrappers():
    """The wrappers of the seven kernels by the names of ``PERF.md``'s
    table, K1 to K7; each counts its launches on the card in its
    ``LAUNCHES``."""
    from . import ar_flow as af
    from . import colfac_detect as cd
    from . import synth_detect as sd
    return {"K1": cd.colfac_detect, "K2": sd.synth_detect,
            "K3": cd.colfac_detect_split, "K4": af.ar_flow_fused,
            "K5": af.ar_flow_streamed, "K6": af.ar_flow_fused_batch,
            "K7": sd.synth_screens}
