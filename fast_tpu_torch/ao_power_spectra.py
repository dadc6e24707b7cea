"""Reference-compatible AO power-spectra surface (``fast/ao_power_spectra.py``).

Re-exports the float64 torch implementations of
:mod:`fast_tpu_torch.models`, the names of ``fast_tpu.ao_power_spectra``.
"""

from .models.ao import (  # noqa: F401
    zernike_ft,
    zernike_filter,
    zernike_squared_filter,
    piston_filter,
    tiptilt_filter,
    piston_tiptilt_filter,
    piston_gtilt_filter,
    mask_lf,
    mask_hf,
    Jol_noise_openloop,
    Jol_alias_openloop,
    G_AO_PAOLA,
    DM_transfer_function,
    G_AO_PAOLA_closedloop,
)
from .models.scintillation import logamp_powerspec  # noqa: F401
# the reference leaks this aotools import into its namespace
# (``fast/ao_power_spectra.py:6``)
from .models.atmosphere import cn2_to_r0  # noqa: F401
