"""The orbit module of fast_tpu_torch (``orbit.py``, its copy of
``fast_tpu/orbit.py``, and the alias module ``complete_orbit_simulation``)
against fast_tpu.

* The geometry helpers and the circular-orbit provider agree with the JAX
  package's to 1e-12 (relative, or absolute on angles near zero).
* ``FAST_sat_orbit_from_geometry`` drops zero-Cn2 layers and sets the
  per-sample keys as the JAX package does; its sims' PSDs and link budgets
  equal ``fast_tpu``'s to 1e-10 relative. ``FAST_sat`` matches.
* skyfield is optional in both packages, with the same ``ImportError``.
* ``run_orbit_sweep`` without a mesh runs each sim's own ``run()``; with a
  (1, 1) mesh it is the parameter scan.
"""

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch import complete_orbit_simulation as tcos
from fast_tpu_torch import orbit, parallel

torch.set_num_threads(1)


def params(**overrides):
    """The flagship link at NPXLS=64, DX=0.02, with a fifth layer of zero
    Cn2 that the orbit module drops."""
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": 256, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": np.append(h, 30000.0),
        "CN2_TURB": np.append(cn2, 0.0), "WIND_SPD": np.append(w, 5.0),
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0, 45.0]), "SEED": 8,
        "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def close(got, ref, rel=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("h,offset,azimuth", [(600e3, 10.0, 0.0),
                                              (550e3, 5.0, 30.0),
                                              (1200e3, 0.5, 200.0)])
def test_geometry_matches_jax(h, offset, azimuth):
    from fast_tpu import orbit as jorbit
    times = np.linspace(-240, 240, 9)
    tp = orbit.circular_orbit_provider(h, offset, azimuth)
    jp = jorbit.circular_orbit_provider(h, offset, azimuth)
    for t in times:
        close(tp(t), jp(t))
    tg = orbit.sample_pass_geometry(tp, times, 0.001, rotations=True)
    jg = jorbit.sample_pass_geometry(jp, times, 0.001, rotations=True)
    assert tg.keys() == jg.keys()
    for k in jg:
        close(tg[k], jg[k])
    rng = np.random.default_rng(3)
    alt0, alt1 = rng.uniform(10, 89, (2, 50))
    az0, az1 = rng.uniform(0, 360, (2, 50))
    for fn in ("fov_angle_components", "fov_rotation"):
        close(getattr(orbit, fn)(alt0, az0, alt1, az1),
              getattr(jorbit, fn)(alt0, az0, alt1, az1))


def test_orbit_sims_match_jax():
    from fast_tpu import orbit as jorbit
    geo = orbit.sample_pass_geometry(
        orbit.circular_orbit_provider(550e3, offset_angle_deg=8.0),
        np.linspace(-90, 90, 2), 0.001)
    td = orbit.FAST_sat_orbit_from_geometry(params(), geo, device="cpu")
    jd = jorbit.FAST_sat_orbit_from_geometry(params(), geo)
    assert sorted(td) == sorted(jd)
    close(td["altitudes"], jd["altitudes"])
    for i in range(2):
        ts, js = td[f"simulation_{i}"], jd[f"simulation_{i}"]
        assert ts.device == torch.device("cpu")
        for k in ("CN2_TURB", "H_TURB", "WIND_DIR", "WIND_SPD"):
            assert len(ts.params[k]) == 4  # the zero-Cn2 layer dropped
            np.testing.assert_array_equal(ts.params[k], js.params[k])
        assert ts.params["L_SAT"] == geo["distances"][i]
        assert ts.params["ZENITH_ANGLE"] == geo["zenith_angles"][i]
        assert ts.params["AZIMUT_SAT"] == geo["azimuts"][i]
        np.testing.assert_array_equal(ts.params["DTHETA"], geo["paa"][i])
        np.testing.assert_array_equal(ts.params["ANISO_DL"],
                                      geo["aniso_dl"][i])
        for k in ("powerspec", "logamp_powerspec", "wind_vector"):
            close(getattr(ts, k), getattr(js, k), 1e-10)
        for k, v in js.link_budget.items():
            close(ts.link_budget[k], v, 1e-10)
        close(ts.diffraction_limit, js.diffraction_limit, 1e-10)
    assert not np.allclose(td["simulation_0"].wind_vector,
                           td["simulation_1"].wind_vector)


def test_fast_sat_matches_jax():
    import fast_tpu.orbit as jorbit
    speed = np.array([300.0, -120.0])
    ts = orbit.FAST_sat(speed, params(), device="cpu")
    js = jorbit.FAST_sat(speed, params())
    np.testing.assert_array_equal(ts.params["ANISO_DL"],
                                  speed * params()["TLOOP"])
    close(ts.wind_vector, js.wind_vector, 1e-12)
    close(ts.powerspec, js.powerspec, 1e-10)


def test_skyfield_is_optional_with_the_same_error():
    from fast_tpu import orbit as jorbit
    if orbit._skyfield:
        pytest.skip("skyfield is installed")
    with pytest.raises(ImportError) as te:
        orbit.get_satellite_obj("none.tle")
    with pytest.raises(ImportError) as je:
        jorbit.get_satellite_obj("none.tle")
    assert str(te.value) == str(je.value)
    for fn, args in ((orbit.skyfield_provider, (None, 0, 0, None)),
                     (orbit.get_sample_time, (None, 0, 0)),
                     (orbit.FAST_sat_orbit, (params(), {
                         "satellite_name": None}, "none.tle"))):
        with pytest.raises(ImportError, match="skyfield"):
            fn(*args)


def test_alias_module_exports_the_jax_names():
    from fast_tpu import complete_orbit_simulation as jcos
    names = [n for n in dir(jcos) if not n.startswith("_")]
    assert names and all(getattr(tcos, n) is getattr(orbit, n)
                         for n in names)


def test_run_orbit_sweep_with_and_without_a_mesh():
    geo = orbit.sample_pass_geometry(
        orbit.circular_orbit_provider(600e3, offset_angle_deg=10.0),
        np.linspace(-60, 60, 2), 0.001)
    d = orbit.FAST_sat_orbit_from_geometry(params(), geo, device="cpu")
    serial = orbit.run_orbit_sweep(d)
    assert sorted(serial) == ["simulation_0", "simulation_1"]
    for k, r in serial.items():
        assert d[k].result is r
        np.testing.assert_array_equal(np.asarray(d[k].run().power),
                                      np.asarray(r.power))
    scan = orbit.run_orbit_sweep(d, parallel.make_scan_mesh(1, 1, ["cpu"]),
                                 seed=d["simulation_0"].seed)
    # the scan's first sim draws the seeds of its own run()
    np.testing.assert_array_equal(np.asarray(scan["simulation_0"].power),
                                  np.asarray(serial["simulation_0"].power))
    assert np.isfinite(np.asarray(scan["simulation_1"].power)).all()
