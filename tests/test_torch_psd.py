"""fast_tpu_torch PSD stage against fast_tpu.psd.assemble_main.

Both run in float64 on the same host inputs. Every field must agree to
1e-10 of its own largest magnitude: the arithmetic is the same, only the
summation order of some products and reductions differs.
"""

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu import psd as j_psd
from fast_tpu.models import ao as j_ao
from fast_tpu_torch import psd as t_psd
from fast_tpu_torch.models import ao as t_ao
from fast_tpu_torch.ops import bessel as t_bessel

torch.set_num_threads(1)

RTOL = 1e-10


def host_sim(N, mode, noise):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": N, "DX": 1.28 / N, "NITER": 2, "NCHUNKS": 1,
        "D_GROUND": 0.8, "ZENITH_ANGLE": 55, "AO_MODE": mode,
        "DSUBAP": 0.1, "ALIAS": True, "NOISE": noise, "H_TURB": h,
        "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 1,
        "LOGLEVEL": "WARNING",
    })
    return fast_tpu_torch.Fast(p, device="cpu")


def psd_args(sim):
    g = sim.freq.main
    f64 = np.float64
    args = (np.asarray(g.fx, f64), np.asarray(g.fy, f64),
            np.asarray(g.fabs, f64), np.asarray(g.fx_axis, f64),
            np.asarray(g.fy_axis, f64), np.asarray(g.f, f64),
            np.asarray(sim.lf_mask, f64), np.asarray(sim.hf_mask, f64),
            np.asarray(sim.pupil_filter, f64), np.asarray(sim.cn2, f64),
            np.asarray(sim.h, f64), np.asarray(sim.wind_vector, f64),
            np.asarray(sim.dtheta, f64), f64(sim.noise), f64(sim.Dsubap),
            f64(sim.texp), f64(sim.tloop), f64(sim.wvl), f64(sim.D_ground),
            f64(sim.L0), f64(sim.l0))
    x_max = (float(np.max(g.fabs) * sim.D_ground / 2)
             if sim.ao_mode == "LGSAO" else None)
    return args, dict(mode=sim.ao_mode, alias_on=bool(sim.alias),
                      noise_on=bool(sim.noise > 0), x_max=x_max)


def assert_close(name, got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= RTOL * scale, f"{name}: {err} > {RTOL} * {scale}"


@pytest.mark.parametrize("mode,noise,N", [
    (mode, noise, 32) for mode in ("AO", "TT", "NOAO", "LGSAO")
    for noise in (0.0, 0.1)] + [("AO", 0.1, 64)])
def test_assemble_main_matches(mode, noise, N):
    sim = host_sim(N, mode, noise)
    args, statics = psd_args(sim)
    ref = j_psd.assemble_main(*args, **statics)
    got = t_psd.assemble_main(*args, **statics)
    assert set(got) == set(ref)
    for k in ref:
        assert_close(k, got[k].numpy(), ref[k])


@pytest.mark.parametrize("mode", ["AO", "TT"])
def test_mask_lf_matches(mode):
    sim = host_sim(32, mode, 0.0)
    ref = j_ao.mask_lf(sim.freq.main, sim.Dsubap, modal=sim.modal,
                       modal_mult=sim.modal_mult, Zmax=sim.Zmax,
                       D=sim.D_ground)
    assert_close("lf_mask", sim.lf_mask, ref)
    got = t_ao.mask_lf(sim.freq.main, sim.Dsubap, modal=sim.modal,
                       modal_mult=sim.modal_mult, Zmax=sim.Zmax,
                       D=sim.D_ground)
    assert_close("lf_mask", got.numpy(), ref)


def test_bessel_matches_scipy():
    from scipy.special import jv
    x = np.linspace(-150.0, 150.0, 3001)
    orders = [0, 1, 2, 3, 5]
    got = t_bessel.besselj(orders, torch.from_numpy(x)).numpy()
    for i, n in enumerate(orders):
        np.testing.assert_allclose(got[:, i], jv(n, x), rtol=0, atol=1e-13)
