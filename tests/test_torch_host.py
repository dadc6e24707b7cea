"""fast_tpu_torch host layer against fast_tpu: imports, config, grids,
pupils, fibre mode and link budget.

Small config: the flagship link at NPXLS=64, DX=0.02 (P=42).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import fast_tpu
import fast_tpu_torch
from fast_tpu.ops import apertures as j_apertures
from fast_tpu_torch.ops import apertures as t_apertures

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_params(**overrides):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": 256, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 3, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


@pytest.fixture(scope="module")
def sims():
    p = small_params()
    return fast_tpu.Fast(dict(p)), fast_tpu_torch.Fast(dict(p), device="cpu")


def test_import_has_no_jax():
    code = ("import sys, fast_tpu_torch, fast_tpu_torch.engine; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('fast_tpu.')"
            " or m == 'fast_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_config_key_sets_equal():
    assert set(fast_tpu_torch.conf.DEFAULTS) == set(fast_tpu.conf.DEFAULTS)
    assert (set(fast_tpu_torch.conf.TPU_DEFAULTS)
            == set(fast_tpu.conf.TPU_DEFAULTS))
    for k, v in fast_tpu.conf.TPU_DEFAULTS.items():
        assert fast_tpu_torch.conf.TPU_DEFAULTS[k] == v
    for k, v in fast_tpu.conf.DEFAULTS.items():
        np.testing.assert_array_equal(fast_tpu_torch.conf.DEFAULTS[k], v)


@pytest.mark.parametrize("N,dx", [(64, 0.02), (256, 0.01)])
def test_grid_pupil_and_mode_match(N, dx):
    jg = fast_tpu.grids.SpatialFrequencies(N, dx).main
    tg = fast_tpu_torch.grids.SpatialFrequencies(N, dx).main
    for name in ("fx", "fy", "fabs", "fx_axis", "fy_axis", "f"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    assert tg.df == jg.df
    jp = j_apertures.compute_pupil(N, dx, 0.8)
    tp = t_apertures.compute_pupil(N, dx, 0.8)
    np.testing.assert_array_equal(tp, jp)
    jm, jw = j_apertures.compute_gaussian_mode(jp, dx, "opt")
    tm, tw = t_apertures.compute_gaussian_mode(tp, dx, "opt")
    assert abs(tw - jw) <= 1e-12 * abs(jw)
    np.testing.assert_allclose(tm, jm, rtol=1e-12, atol=0)


def test_engine_host_fields_match(sims):
    js, ts = sims
    for name in ("Npxls", "Npxls_pup", "dx", "pup_crop", "L", "r0", "theta0",
                 "tau0", "r0_los", "paa"):
        assert getattr(ts, name) == getattr(js, name), name
    np.testing.assert_array_equal(ts.wind_vector, js.wind_vector)
    np.testing.assert_array_equal(ts.pupil, js.pupil)
    np.testing.assert_array_equal(ts.lf_mask, np.asarray(js.lf_mask))
    assert abs(ts.W0 - js.W0) <= 1e-12 * js.W0
    np.testing.assert_allclose(ts.pupil_mode, js.pupil_mode, rtol=1e-12)
    np.testing.assert_allclose(ts.pupil_filter, js.pupil_filter, rtol=1e-12,
                               atol=1e-12 * js.pupil_filter.max())
    assert ts.link_budget.keys() == js.link_budget.keys()
    for k, v in js.link_budget.items():
        assert abs(ts.link_budget[k] - v) <= 1e-12 * max(1.0, abs(v)), k
    assert (abs(ts.diffraction_limit - js.diffraction_limit)
            <= 1e-12 * js.diffraction_limit)


def test_pruned_dft_matrix_matches():
    from fast_tpu import synthesis as js
    from fast_tpu_torch import synthesis as ts
    for dt in (np.complex64, np.complex128):
        np.testing.assert_array_equal(ts.pruned_ift2_matrix(64, 11, 53, dt),
                                      js.pruned_ift2_matrix(64, 11, 53, dt))


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        fast_tpu_torch.Fast(small_params())


@pytest.mark.parametrize("overrides,match", [
    ({"TEMPORAL": True}, "TEMPORAL"),
    ({"SYNTH": "pallas"}, "K7"),
])
def test_unported_options_raise(overrides, match):
    """What is still to port raises: ``run(progress=True)``, here of a
    TEMPORAL sim. SYNTH='pallas' (K7) used to raise at construction; it
    now constructs on its own path and runs."""
    if overrides.get("SYNTH") == "pallas":
        sim = fast_tpu_torch.Fast(small_params(NITER=64, NCHUNKS=2,
                                               **overrides), device="cpu")
        assert sim._synth == "pallas"
        power = sim.run().power
        assert power.shape == (64,) and np.isfinite(power).all()
        return
    with pytest.raises(NotImplementedError, match=match):
        sim = fast_tpu_torch.Fast(small_params(**overrides), device="cpu")
        assert sim.temporal
        sim.run(progress=True)


def test_progress_run_not_ported(sims):
    with pytest.raises(NotImplementedError, match="progress"):
        sims[1].run(progress=True)


def test_stage_timings_recorded(sims):
    assert set(sims[1].timings) >= {"init_geometry", "powerspec",
                                    "device_constants"}
