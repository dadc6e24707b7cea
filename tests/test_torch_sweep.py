"""Sweeps of fast_tpu_torch (``sweep.build_sweep``) against fast_tpu's and
against full per-sample inits: the analogues of ``tests/test_sweep.py``, on
the CPU at 64^2.

* Clones match ``fast_tpu.sweep.build_sweep``'s and full per-sample
  ``fast_tpu_torch.Fast`` inits to 1e-10 relative: PSDs, log-amplitude
  variance, error budgets, link budget, diffraction limit; with SUBHARM,
  the subharmonic spectra too.
* The JAX sweep's per-sample arrays through ``interop.sample_tables`` give
  the clones' own device tables.
* A sweep refuses the 'auto' grid and TEMPORAL; the default SYNTH follows
  the JAX rule ('matmul' off the accelerator, the K2 kernel on it for
  float32), 'auto' resolves through the base.
* Each clone has its own tables (its sqrt-PSD on the device, its column
  factors on the colfac routes); the grid's tables are shared.
"""

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch import interop, sweep

torch.set_num_threads(1)

ZENITHS = np.array([30.0, 45.0, 60.0])
DTHETAS = np.array([[4.0, 0.0], [3.0, 1.0], [2.0, 2.0]])


def params(**overrides):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": 256, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "DTHETA": [4, 0], "SEED": 12, "LOGLEVEL": "WARNING",
        "SYNTH": "matmul",
    })
    p.update(overrides)
    return p


SAMPLES = {"ZENITH_ANGLE": ZENITHS, "DTHETA": DTHETAS,
           "AZIMUT_SAT": np.array([0.0, 40.0, 300.0]),
           "ANISO_DL": np.array([[2.0, 1.0], [0.0, 3.0], [1.0, 1.0]]),
           "L_SAT": np.array([900e3, 700e3, 1100e3])}


def solo_params(i, **o):
    return params(ZENITH_ANGLE=ZENITHS[i], DTHETA=list(DTHETAS[i]),
                  AZIMUT_SAT=SAMPLES["AZIMUT_SAT"][i],
                  ANISO_DL=SAMPLES["ANISO_DL"][i],
                  L_SAT=SAMPLES["L_SAT"][i], **o)


def close(got, ref, rel=1e-10):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-300)


FIELDS = ("powerspec", "logamp_powerspec", "logamp_var", "phs_var",
          "diffraction_limit", "L", "aniso_servo_error", "alias_error",
          "fitting_error", "noise_error", "phs_var_weights", "wind_vector",
          "h", "cn2")


@pytest.fixture(scope="module")
def sweeps():
    from fast_tpu import sweep as jsweep
    return (sweep.build_sweep(params(), SAMPLES, device="cpu"),
            jsweep.build_sweep(params(), SAMPLES))


@pytest.mark.parametrize("i", [0, 1, 2])
def test_clones_match_jax_and_full_inits(sweeps, i):
    tsims, jsims = sweeps
    solo = fast_tpu_torch.Fast(solo_params(i), device="cpu")
    s, js = tsims[i], jsims[i]
    for name in FIELDS:
        close(getattr(s, name), getattr(solo, name))
        close(getattr(s, name), getattr(js, name))
    for term, val in s.link_budget.items():
        close(val, solo.link_budget[term])
        close(val, js.link_budget[term])
    assert s.params["ZENITH_ANGLE"] == ZENITHS[i] and s._synth == "matmul"
    # the clone's device tables are those of the full init
    for k in ("sqrt_psd", "pm", "W", "s_t"):
        torch.testing.assert_close(s.tables[k], solo.tables[k], rtol=1e-6,
                                   atol=0)
    for k in ("norm", "logamp_var", "diffraction_limit"):
        close(s.tables[k], solo.tables[k])


def test_budgets_differ_and_clones_run(sweeps):
    tsims, _ = sweeps
    assert not np.isclose(tsims[0].aniso_servo_error,
                          tsims[2].aniso_servo_error)
    assert not np.isclose(tsims[0].alias_error, tsims[2].alias_error)
    assert "sweep_assemble" in tsims[0].timings
    r = tsims[1].run()
    assert r.power.shape == (256,) and np.isfinite(r.power).all()


def test_tables_from_the_jax_sweep(sweeps):
    """The JAX clones' per-sample arrays, carried by
    ``interop.sample_tables``, are the port's clones' tables."""
    tsims, jsims = sweeps
    base = tsims[0]._table_arrays(column_factors=False)
    per = {"powerspec": np.stack([js.powerspec for js in jsims]),
           "logamp_var": [js.logamp_var for js in jsims],
           "diffraction_limit": [js.diffraction_limit for js in jsims]}
    tables = interop.sample_tables(base, per)
    for T, s in zip(tables, tsims):
        for k, v in T.items():
            if torch.is_tensor(v) and v.is_floating_point():
                torch.testing.assert_close(v, s.tables[k], rtol=1e-6,
                                           atol=0)
    assert tables[1]["W"] is tables[0]["W"]
    with pytest.raises(ValueError, match="may not vary"):
        interop.sample_tables(base, {"pupil_mode": [base["pupil_mode"]]})
    with pytest.raises(ValueError, match="one entry per sample"):
        interop.sample_tables(base, {"powerspec": per["powerspec"],
                                     "logamp_var": [1.0]})


def test_each_clone_has_its_own_tables(sweeps):
    """The bug ``copy.copy`` invites (``fast_tpu/sweep.py:232-237``): a
    clone that kept the base's tables would run the base atmosphere."""
    tsims, _ = sweeps
    a, b = tsims[0].tables, tsims[2].tables
    assert not torch.equal(a["sqrt_psd"], b["sqrt_psd"])
    assert not torch.equal(a["s_t"], b["s_t"])
    assert float(a["logamp_var"]) != float(b["logamp_var"])
    for k in ("W", "wr", "wi", "pm", "pm_t", "mix"):
        assert a[k] is b[k], k


def test_subharm_matches_jax_and_full_inits():
    from fast_tpu import sweep as jsweep
    samples = {"ZENITH_ANGLE": ZENITHS[::2]}
    tsims = sweep.build_sweep(params(SUBHARM=True), samples, device="cpu")
    jsims = jsweep.build_sweep(params(SUBHARM=True), samples)
    for i, z in enumerate(samples["ZENITH_ANGLE"]):
        solo = fast_tpu_torch.Fast(params(SUBHARM=True, ZENITH_ANGLE=z),
                                   device="cpu")
        for k in ("powerspec_subharm", "phs_var_weights_sh",
                  "phs_var_subharm", "powerspec"):
            close(getattr(tsims[i], k), getattr(solo, k))
            close(getattr(tsims[i], k), getattr(jsims[i], k))
        torch.testing.assert_close(tsims[i].tables["sqrt_psd_sh"],
                                   solo.tables["sqrt_psd_sh"], rtol=1e-6,
                                   atol=0)
    assert not np.allclose(tsims[0].powerspec_subharm,
                           tsims[1].powerspec_subharm)
    assert tsims[0].tables["sh_modes"] is tsims[1].tables["sh_modes"]
    r = tsims[0].run()
    assert np.isfinite(np.asarray(r.power)).all()


@pytest.mark.parametrize("overrides,exc,match", [
    ({"NPXLS": "auto"}, ValueError, "explicit NPXLS"),
    ({"DX": "auto"}, ValueError, "explicit NPXLS"),
    ({"TEMPORAL": True}, NotImplementedError, "TEMPORAL=False")])
def test_sweep_refuses(overrides, exc, match):
    with pytest.raises(exc, match=match):
        sweep.build_sweep(params(**overrides), {"ZENITH_ANGLE": ZENITHS},
                          device="cpu")


@pytest.mark.parametrize("synth,dtype,expect", [
    (None, "float32", "matmul"), (None, "float64", "matmul"),
    ("auto", "float32", "pallas_fused"), ("auto", "float64", "fft")])
def test_sweep_resolves_synth(synth, dtype, expect):
    """No SYNTH key: 'matmul' off the card (the JAX rule off the TPU);
    'auto' resolves through the base, to the engine's own pick."""
    p = params(DTYPE=dtype, NITER=64)
    if synth is None:
        del p["SYNTH"]
    else:
        p["SYNTH"] = synth
    sims = sweep.build_sweep(p, {"ZENITH_ANGLE": ZENITHS[:2]}, device="cpu")
    for s in sims:
        assert s._synth == s.params["SYNTH"] == expect
    assert np.isfinite(np.asarray(sims[0].run().power)).all()


@pytest.mark.parametrize("synth", ["colfac", "pallas_colfac"])
def test_colfac_factors_are_per_sample(synth):
    """Each clone factors its own covariance: its factors equal a full
    per-sample init's, and its K1 table is built from them."""
    samples = {"ZENITH_ANGLE": ZENITHS[::2]}
    sims = sweep.build_sweep(params(SYNTH=synth), samples, device="cpu")
    La, Lb = sims[0].tables["L"], sims[1].tables["L"]
    assert not torch.allclose(La, Lb)
    for s, z in zip(sims, samples["ZENITH_ANGLE"]):
        solo = fast_tpu_torch.Fast(params(SYNTH=synth, ZENITH_ANGLE=z),
                                   device="cpu")
        torch.testing.assert_close(s.tables["L"], solo.tables["L"],
                                   rtol=1e-5, atol=1e-6 * float(
                                       solo.tables["L"].abs().max()))
        if synth == "pallas_colfac":
            torch.testing.assert_close(s.tables["S_colfac"],
                                       solo.tables["S_colfac"], rtol=1e-5,
                                       atol=1e-6)
    assert np.isfinite(np.asarray(sims[1].run().power)).all()
