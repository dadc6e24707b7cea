"""Reference-compatible alias for the orbit sweeps (``fast/complete_orbit_simulation.py``)."""

from .orbit import (  # noqa: F401
    get_satellite_obj,
    get_sample_time,
    get_angles_positions,
    FAST_sat_orbit,
    FAST_sat,
    FAST_sat_orbit_from_geometry,
    sample_pass_geometry,
    circular_orbit_provider,
    skyfield_provider,
)
