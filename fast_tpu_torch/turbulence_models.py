"""Reference-compatible turbulence-model surface (``fast/turbulence_models.py``)."""

from .models.atmosphere import (  # noqa: F401
    HV57,
    Bufton_wind,
    HV57_Bufton_profile,
    equivalent_layers,
    cn2_to_r0,
    isoplanatic_angle,
    coherence_time,
    rytov_variance,
)
