"""Log-amplitude (scintillation) power spectrum in torch float64.

Reference ``fast/ao_power_spectra.py:272-301``: per-layer von Karman
spectrum times the Fresnel filter ``sin^2(wvl h f^2 / 4pi)``, filtered by
the pupil/mode spatial filter and path-integrated. The temporal mode's
pupil-filter resampler belongs to a path this package does not run yet.
"""

import numpy as np
import torch

from ..ops.integrate import integrate_path
from .atmosphere import turb_powerspectrum_vonKarman


def logamp_powerspec(fabs, h, cn2, wvl, pupilfilter, L0=np.inf, l0=1e-6):
    """Path-integrated log-amplitude PSD on the grid ``fabs`` (tensor),
    filtered by the pupil filter tabulated on the same grid."""
    h = torch.as_tensor(np.asarray(h, dtype=float), dtype=fabs.dtype)
    powerspec = turb_powerspectrum_vonKarman(fabs, cn2, L0=L0, l0=l0) \
        * 2 * np.pi * (2 * np.pi / wvl) ** 2
    powerspec = powerspec * torch.sin(
        wvl * h[:, None, None] * fabs[None] ** 2 / (4 * np.pi)) ** 2
    return integrate_path(powerspec * pupilfilter)
