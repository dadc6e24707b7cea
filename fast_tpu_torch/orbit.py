"""Satellite-orbit sweeps (reference ``fast/complete_orbit_simulation.py``).

A copy of ``fast_tpu.orbit`` (numpy only) for this package, which imports
nothing of ``fast_tpu``; the functions that build simulations take the
run device (``"cuda"`` unless the caller asks for ``"cpu"``).

The reference is hard-wired to skyfield TLE ephemerides and builds one
fully-initialised simulation per orbit sample. Here the ephemeris is an
abstraction:

* an *ephemeris provider* is any callable ``t_seconds -> (alt_deg, az_deg,
  dist_m)`` giving the satellite's topocentric position at time ``t``;
* :func:`skyfield_provider` adapts a skyfield satellite + ground station
  (requires skyfield; optional);
* :func:`circular_orbit_provider` is a built-in Keplerian circular-orbit
  pass model needing no TLEs or network access;
* :func:`sample_pass_geometry` turns a provider into per-sample link
  geometry (zenith angle, range, point-ahead angle from two-way light
  time, downlink anisoplanatism angle from satellite motion over one AO
  loop) — the quantities the engine consumes;
* :func:`FAST_sat_orbit` keeps the reference's TLE entry point, and
  :func:`FAST_sat_orbit_from_geometry` builds the per-sample simulations
  from any geometry (the natural batch axis for parameter scans,
  :func:`fast_tpu_torch.parallel.run_scan_sharded`).
"""

import datetime
import logging

import numpy as np

logger = logging.getLogger(__name__)

try:  # pragma: no cover - optional dependency
    from skyfield.api import load as _sf_load, wgs84 as _sf_wgs84
    _skyfield = True
except ImportError:
    _skyfield = False
    _sf_load = _sf_wgs84 = None  # replaceable by a test fixture backend

_C = 2.997925e8
_R_EARTH = 6.371009e6
_GM = 3.986004418e14


# ---------------------------------------------------------------------------
# geometry helpers (pure numpy, ephemeris-agnostic)
# ---------------------------------------------------------------------------


def fov_angle_components(alt0, az0, alt1, az1):
    """Decompose the angle between two sky directions into telescope-frame
    (x, y) components [deg].

    Spherical-triangle decomposition used for both the point-ahead and the
    downlink anisoplanatism angles (reference
    ``complete_orbit_simulation.py:150-163``). Angles in degrees.
    """
    z0 = np.radians(90 - np.asarray(alt0))
    z1 = np.radians(90 - np.asarray(alt1))
    daz = np.radians(np.asarray(az1) - np.asarray(az0))
    cos_a = np.cos(z1) * np.cos(z0) + np.sin(z1) * np.sin(z0) * np.cos(daz)
    cos_a = np.clip(cos_a, -1.0, 1.0)
    sin_a = np.sqrt(1 - cos_a ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        cos_o = (np.cos(z1) - cos_a * np.cos(z0)) / (sin_a * np.sin(z0))
        cos_o = np.clip(cos_o, -1.0, 1.0)
        sin_o = np.sqrt(1 - cos_o ** 2)
        alpha = np.degrees(np.arccos(cos_a))
        dy = cos_o * alpha
        dx = np.sign(np.asarray(az1) - np.asarray(az0)) * sin_o * alpha
    return dx, dy


def fov_rotation(alt0, az0, alt1, az1):
    """Telescope field-of-view rotation between two sky directions [rad].

    ``pi - beta1 - beta0`` where ``beta0``/``beta1`` are the spherical-
    triangle angles at the two directions (vertices: zenith and the two
    directions) — the reference's rotation output
    (``complete_orbit_simulation.py:165-169``).
    """
    z0 = np.radians(90 - np.asarray(alt0))
    z1 = np.radians(90 - np.asarray(alt1))
    daz = np.radians(np.asarray(az1) - np.asarray(az0))
    cos_a = np.cos(z1) * np.cos(z0) + np.sin(z1) * np.sin(z0) * np.cos(daz)
    cos_a = np.clip(cos_a, -1.0, 1.0)
    sin_a = np.sqrt(1 - cos_a ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta0 = np.arccos(np.clip(
            (np.cos(z1) - np.cos(z0) * cos_a) / (sin_a * np.sin(z0)), -1, 1))
        beta1 = np.arccos(np.clip(
            (np.cos(z0) - cos_a * np.cos(z1)) / (sin_a * np.sin(z1)), -1, 1))
    return np.pi - beta1 - beta0


def _provider_at(provider, t, lon_shift_deg):
    """Evaluate a provider, passing the station longitude shift when the
    provider supports it (rotating-Earth ephemerides); fall back to the
    fixed-station evaluation otherwise."""
    if lon_shift_deg:
        try:
            return provider(t, lon_shift_deg=lon_shift_deg)
        except TypeError:
            pass
    return provider(t)


def sample_pass_geometry(provider, times, Tloop, paa_station_shift=True,
                         rotations=False):
    """Per-sample link geometry from an ephemeris provider.

    Args:
        provider: callable ``t -> (alt_deg, az_deg, dist_m)``; it may
            optionally accept ``lon_shift_deg`` (station longitude offset,
            for Earth-rotation corrections).
        times: 1-D array of sample times [s].
        Tloop: AO loop delay [s].
        paa_station_shift: evaluate the point-ahead direction against the
            ground station shifted backwards by the Earth rotation over
            the two-way light time, as the reference does
            (``complete_orbit_simulation.py:139-143``). Only effective for
            providers that accept ``lon_shift_deg``.
        rotations: also compute the FoV rotation per sample [rad]
            (reference ``complete_orbit_simulation.py:165-169``).

    Returns:
        dict with per-sample arrays: ``paa`` (N, 2) and ``aniso_dl`` (N, 2)
        in arcsec, ``altitudes``, ``azimuts`` [deg], ``distances`` [m],
        ``zenith_angles`` [deg], and — when requested — ``rotations``
        [rad].
    """
    times = np.asarray(times, dtype=float)
    n = len(times)
    alt0 = np.zeros(n)
    az0 = np.zeros(n)
    dist0 = np.zeros(n)
    paa = np.zeros((n, 2))
    aniso = np.zeros((n, 2))
    rot = np.zeros(n)

    for i, t in enumerate(times):
        alt0[i], az0[i], dist0[i] = provider(t)
        # point-ahead: two-way light time, station rewound by the Earth
        # rotation over it (reference ``complete_orbit_simulation.py:140``)
        dt_paa = 2 * dist0[i] / _C
        lon_shift = -360.0 * dt_paa / 86400.0 if paa_station_shift else 0.0
        alt_p, az_p, _ = _provider_at(provider, t + dt_paa, lon_shift)
        paa[i] = fov_angle_components(alt0[i], az0[i], alt_p, az_p)
        # downlink anisoplanatism: satellite motion over one loop delay
        alt_d, az_d, _ = provider(t + Tloop)
        aniso[i] = fov_angle_components(alt0[i], az0[i], alt_d, az_d)
        if rotations:
            rot[i] = fov_rotation(alt0[i], az0[i], alt_d, az_d)

    paa = np.nan_to_num(paa * 3600)
    aniso = np.nan_to_num(aniso * 3600)
    out = {
        "paa": paa,
        "aniso_dl": aniso,
        "altitudes": alt0,
        "azimuts": az0,
        "distances": dist0,
        "zenith_angles": 90 - alt0,
    }
    if rotations:
        out["rotations"] = rot
    return out


# ---------------------------------------------------------------------------
# built-in Keplerian provider (no TLE / network needed)
# ---------------------------------------------------------------------------


def circular_orbit_provider(h_orbit, offset_angle_deg=0.0, pass_azimuth_deg=0.0):
    """Ephemeris provider for an idealised circular-orbit pass.

    The satellite moves on a great circle over a non-rotating spherical
    Earth; closest approach to the station (at ``t = 0``) is offset from
    zenith by ``offset_angle_deg`` perpendicular to the track, which is
    oriented ``pass_azimuth_deg`` east of north.

    Args:
        h_orbit: orbit altitude above the surface [m].
        offset_angle_deg: central-angle cross-track offset at culmination.
        pass_azimuth_deg: direction of motion at culmination.

    Returns:
        provider callable ``t -> (alt_deg, az_deg, dist_m)``.
    """
    r = _R_EARTH + h_orbit
    omega = np.sqrt(_GM / r ** 3)  # orbital angular rate [rad/s]
    beta = np.radians(offset_angle_deg)
    az_track = np.radians(pass_azimuth_deg)

    def provider(t):
        along = omega * t  # in-track central angle from culmination
        # central angle between station and satellite ground point
        cos_g = np.cos(beta) * np.cos(along)
        gamma = np.arccos(np.clip(cos_g, -1, 1))
        dist = np.sqrt(_R_EARTH ** 2 + r ** 2 - 2 * _R_EARTH * r * cos_g)
        # elevation from central angle
        sin_el = (r * cos_g - _R_EARTH) / dist
        alt = np.degrees(np.arcsin(np.clip(sin_el, -1, 1)))
        # bearing of the sub-satellite point from the station
        num = np.sin(along)
        den = np.cos(along) * np.sin(beta)
        az = np.degrees(az_track + np.arctan2(num, den))
        return alt, az % 360, dist

    return provider


# ---------------------------------------------------------------------------
# skyfield adapter + reference-parity entry points
# ---------------------------------------------------------------------------


def _require_skyfield():
    if not _skyfield:
        raise ImportError(
            "skyfield is required for TLE-driven orbit simulation; use "
            "circular_orbit_provider / FAST_sat_orbit_from_geometry for the "
            "ephemeris-free path")


def get_satellite_obj(TLE_file_path, satellite_name=None):
    """Load a skyfield satellite from a TLE file/URL."""
    _require_skyfield()
    satellites = _sf_load.tle_file(TLE_file_path)
    if satellite_name is not None:
        by_name = {sat.name: sat for sat in satellites}
        return by_name[satellite_name]
    return satellites[0]


def skyfield_provider(satellite, tele_lat, tele_lon, t_rise):
    """Ephemeris provider backed by a skyfield satellite object.

    ``t_rise`` is the epoch (UTC datetime) that provider time ``t = 0``
    refers to. Accepts ``lon_shift_deg`` so
    :func:`sample_pass_geometry` can evaluate the point-ahead direction
    against the station rewound by the Earth rotation over the two-way
    light time, exactly as the reference does
    (``complete_orbit_simulation.py:139-143``).
    """
    _require_skyfield()
    ts = _sf_load.timescale()
    telescope = _sf_wgs84.latlon(tele_lat, tele_lon)
    difference = satellite - telescope

    def provider(t, lon_shift_deg=0.0):
        diff = difference
        if lon_shift_deg:
            diff = satellite - _sf_wgs84.latlon(tele_lat,
                                                tele_lon + lon_shift_deg)
        topo = diff.at(
            ts.from_datetime(datetime.timedelta(seconds=float(t)) + t_rise))
        alt, az, dist = topo.altaz()
        return alt.degrees, az.degrees, dist.m

    return provider


def get_sample_time(satellite, tele_lat, tele_lon, N=10, start=None, period=10,
                    min_altitude_degrees=5.0, max_altitude_degree=90.0,
                    zenith_stop=False):
    """Find a pass of ``satellite`` over the station and sample it.

    Returns ``(sample_times_s, t_rise_utc)`` (reference
    ``complete_orbit_simulation.py:29-92``).
    """
    _require_skyfield()
    ts = _sf_load.timescale()
    telescope = _sf_wgs84.latlon(tele_lat, tele_lon)

    t0 = ts.from_datetime(start) if start is not None else satellite.epoch
    t1 = ts.from_datetime(t0.utc_datetime() + datetime.timedelta(days=period))
    times, events = satellite.find_events(telescope, t0, t1,
                                          min_altitude_degrees)
    events = np.asarray(events)

    # culmination (event==1) altitudes in one vectorised ephemeris call;
    # keep the best pass under the altitude cap (last wins on ties, as a
    # running >= max would)
    alts = (satellite - telescope).at(times).altaz()[0].degrees
    ok = np.flatnonzero((events == 1) & (alts >= 0)
                        & (alts <= max_altitude_degree))
    if ok.size == 0:
        raise Exception(
            "The satellite doesn't pass over the telescope during the "
            "research period")
    peak = ok[::-1][np.argmax(alts[ok[::-1]])]

    # pass boundaries: nearest rise (event==0) at or before the peak and —
    # unless sampling stops at culmination — nearest fall (event==2) after
    rises = np.flatnonzero(events[:peak + 1] == 0)
    t_rise = times[int(rises[-1])] if rises.size else times[0]
    if zenith_stop:
        t_fall = times[int(peak)]
    else:
        falls = peak + np.flatnonzero(events[peak:] == 2)
        t_fall = times[int(falls[0])] if falls.size else times[-1]

    # .seconds (not total_seconds): passes are << 1 day, and the truncated
    # field is what downstream sampling has always consumed
    dt = (t_fall.utc_datetime() - t_rise.utc_datetime()).seconds
    return np.linspace(0, dt, N), t_rise.utc_datetime()


def get_angles_positions(sample_times, satellite, tele_lat, tele_lon, t_rise,
                         Tloop, rotations=False):
    """Reference-parity wrapper: per-sample PAA / anisoplanatism / altaz.

    Returns ``(paa, aniso_dl, altitudes, azimuts, distances)`` with angles
    in arcsec (reference ``complete_orbit_simulation.py:95-184``).
    """
    provider = skyfield_provider(satellite, tele_lat, tele_lon, t_rise)
    geo = sample_pass_geometry(provider, sample_times, Tloop,
                               rotations=rotations)
    if rotations:
        return (geo["paa"], geo["aniso_dl"], geo["altitudes"],
                geo["azimuts"], geo["distances"], geo["rotations"])
    return (geo["paa"], geo["aniso_dl"], geo["altitudes"], geo["azimuts"],
            geo["distances"])


def FAST_sat_orbit_from_geometry(fast_params, geometry, device="cuda"):
    """One initialised simulation per orbit sample from precomputed geometry.

    ``geometry`` is the dict produced by :func:`sample_pass_geometry`.
    Zero-Cn2 layers are dropped as in the reference
    (``complete_orbit_simulation.py:213-215``). The simulations run on
    ``device``.
    """
    from .engine import Fast

    p = dict(fast_params)
    layer_mask = np.array(fast_params["CN2_TURB"]) > 0
    p["CN2_TURB"] = np.array(fast_params["CN2_TURB"])[layer_mask]
    p["H_TURB"] = np.array(fast_params["H_TURB"])[layer_mask]
    p["WIND_DIR"] = np.array(fast_params["WIND_DIR"])[layer_mask]
    p["WIND_SPD"] = np.array(fast_params["WIND_SPD"])[layer_mask]

    sims = {}
    for idx in range(len(geometry["zenith_angles"])):
        p_i = dict(p)
        p_i["L_SAT"] = geometry["distances"][idx]
        p_i["DTHETA"] = geometry["paa"][idx, :]
        p_i["ANISO_DL"] = geometry["aniso_dl"][idx, :]
        p_i["ZENITH_ANGLE"] = geometry["zenith_angles"][idx]
        p_i["AZIMUT_SAT"] = geometry["azimuts"][idx]
        sims[f"simulation_{idx}"] = Fast(p_i, device=device)

    sims["altitudes"] = geometry["altitudes"]
    return sims


def FAST_sat_orbit(fast_params, simu_params, TLE_file, device="cuda"):
    """TLE-driven orbit sweep (reference entry point).

    Samples a pass of the satellite over the telescope and builds one
    initialised simulation per sample on ``device`` (reference
    ``complete_orbit_simulation.py:187-232``).
    """
    satellite = get_satellite_obj(TLE_file, simu_params["satellite_name"])
    sample_times, t0 = get_sample_time(
        satellite, simu_params["telescop_lat"], simu_params["telescop_lon"],
        simu_params["N_sample"], simu_params["t0_research"],
        simu_params["research_window"], simu_params["altitude_min"],
        simu_params["altitude_max"], simu_params["zenith_stop"])
    provider = skyfield_provider(
        satellite, simu_params["telescop_lat"], simu_params["telescop_lon"], t0)
    geometry = sample_pass_geometry(provider, sample_times,
                                    fast_params["TLOOP"])
    return FAST_sat_orbit_from_geometry(fast_params, geometry, device)


def run_orbit_sweep(sims, mesh=None, seed=None):
    """Run an orbit sweep's simulations as one parameter scan.

    Takes the dict produced by :func:`FAST_sat_orbit` /
    :func:`FAST_sat_orbit_from_geometry` (the reference ran each sample
    serially; here the samples form the ``scan`` axis of
    :func:`fast_tpu_torch.parallel.run_scan_sharded`). Simulations
    must share grid geometry — pass explicit ``NPXLS``/``DX`` in
    ``fast_params`` so the per-sample 'auto' rules don't produce different
    grids. Runs each simulation's own ``run()`` in turn when no mesh is
    given.

    Returns:
        dict mapping ``simulation_i`` -> :class:`FastResult`.
    """
    keys = [k for k in sims if k.startswith("simulation_")]
    keys.sort(key=lambda k: int(k.split("_")[1]))
    sim_list = [sims[k] for k in keys]

    if mesh is None:
        return {k: s.run() for k, s in zip(keys, sim_list)}

    from .parallel.scan import run_scan_sharded

    results = run_scan_sharded(sim_list, mesh, seed=seed)
    return dict(zip(keys, results))


def FAST_sat(sat_apparent_speed, fast_params, device="cuda"):
    """Single simulation with ANISO_DL set from the apparent satellite speed."""
    from .engine import Fast

    fast_params = dict(fast_params)
    fast_params["ANISO_DL"] = np.asarray(sat_apparent_speed) * fast_params["TLOOP"]
    return Fast(fast_params, device=device)
