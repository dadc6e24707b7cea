"""Subharmonics (SUBHARM=True) in fast_tpu_torch against fast_tpu.

* Grids, modes and the subharmonic PSD fields agree with the JAX
  package's to float64 round-off (1e-10 of each field's max), and the
  main-grid fields stay so with SUBHARM on.
* The screens from the mean-subtracted, cropped mode table equal the
  full-grid screens, mean-subtracted and then cropped (1e-12).
* Both detect kernels' plain versions add the subharmonic screens as the
  TPU kernels do in the Pallas interpreter (zero bits; 1e-3, float32
  products in another order).
* Monte Carlo runs with SUBHARM=True agree with the JAX package's in
  distribution: mean within 5 combined standard errors, scintillation
  index within 20%.
* On the card K2 with subharmonic screens agrees with its plain version to
  KERNEL_REL times the largest |sum|; so does K1.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_subharm.py -m cuda
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch import synthesis as ts
from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops import synth_detect as sd

torch.set_num_threads(1)

NITER = 4096
KERNEL_REL = 4e-6


def small_params(**overrides):
    import fast_tpu_torch
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": NITER, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 31, "LOGLEVEL": "WARNING", "SUBHARM": True,
    })
    p.update(overrides)
    return p


CONFIGS = {"AO": {}, "LGSAO_noise": {"AO_MODE": "LGSAO", "NOISE": 0.1}}


@pytest.fixture(scope="module", params=list(CONFIGS))
def sims(request):
    import fast_tpu
    import fast_tpu_torch
    p = small_params(SYNTH="matmul", **CONFIGS[request.param])
    return fast_tpu.Fast(dict(p)), fast_tpu_torch.Fast(dict(p), device="cpu")


def close(got, ref, rel=1e-10):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-300)


def test_subharm_grid_matches(sims):
    jg, tg = sims[0].freq.subharm, sims[1].freq.subharm
    for name in ("fx", "fy", "fabs", "fx_axis", "fy_axis", "df"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))
    assert tg.fx.shape == (3, 3, 3)


@pytest.mark.parametrize("name", [
    "lf_mask_subharm", "powerspec_subharm", "powerspec_subharm_per_layer",
    "phs_var_subharm", "phs_var_weights_sh",
    # the main grid's fields stay where they were
    "powerspec", "lf_mask", "phs_var", "fitting_error", "alias_error",
    "noise_error", "logamp_var"])
def test_fields_match(sims, name):
    close(getattr(sims[1], name), getattr(sims[0], name))


def test_subharm_modes_match():
    from fast_tpu import synthesis as js
    import fast_tpu_torch
    g = fast_tpu_torch.grids.SpatialFrequencies(64, 0.02)
    g.make_subharm_freqs()
    np.testing.assert_array_equal(
        ts.make_subharm_modes(g.subharm.fx, g.subharm.fy, 64, 0.02),
        np.asarray(js.make_subharm_modes(g.subharm.fx, g.subharm.fy, 64,
                                         0.02)))


def test_mode_table_screens_equal_full_grid_screens():
    """Each mode less its full-grid mean, cropped, gives the screens that
    are mean-subtracted over the full grid and then cropped."""
    import fast_tpu_torch
    g = fast_tpu_torch.grids.SpatialFrequencies(64, 0.02)
    g.make_subharm_freqs()
    modes = ts.make_subharm_modes(g.subharm.fx, g.subharm.fy, 64, 0.02)
    rng = np.random.default_rng(4)
    sqrt_ps = rng.random((3, 3, 3))
    df = np.asarray(g.subharm.df)
    gen = torch.Generator().manual_seed(5)
    got = ts.subharm_screens(
        gen, torch.from_numpy(sqrt_ps), torch.from_numpy(df),
        torch.from_numpy(ts.subharm_mode_table(modes, (20, 44))), 6).numpy()
    gen = torch.Generator().manual_seed(5)
    rand = torch.randn((2, 6, 3, 3, 3), generator=gen,
                       dtype=torch.float64).numpy()
    weights = (rand[0] + 1j * rand[1]) * (sqrt_ps * df[:, None, None])
    full = np.einsum("bimn,imnxy->bxy", weights, modes)
    full -= full.mean(axis=(-2, -1), keepdims=True)
    assert got.shape == (6, 24, 24)
    assert np.abs(got - full[:, 20:44, 20:44]).max() <= 1e-12 * np.abs(
        full).max()


def subharm_inputs(N=64, lo=20, hi=44, nbatch=4, seed=5):
    npup = hi - lo
    rng = np.random.default_rng(seed)
    sqrt_ps = (rng.random((N, N)) + 0.2).astype(np.float32)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((npup, npup)).astype(np.float32)
    shc = (rng.normal(size=(nbatch, npup, npup))
           + 1j * rng.normal(size=(nbatch, npup, npup))).astype(np.complex64)
    L = ((rng.normal(size=(N, npup, npup))
          + 1j * rng.normal(size=(N, npup, npup))) * 0.01).astype(np.complex64)
    return sqrt_ps, W, pm, shc, L


def tables(W, pm):
    return sd.pad_pupil(torch.from_numpy(np.ascontiguousarray(W.real)),
                        torch.from_numpy(np.ascontiguousarray(W.imag)),
                        torch.from_numpy(np.ascontiguousarray(pm.T)))


def test_pack_subharm_layout():
    _, _, _, shc, _ = subharm_inputs()
    sh_t = sd.pack_subharm(torch.from_numpy(shc)).numpy()
    assert sh_t.shape == (4, 2, 32, 32) and sh_t.dtype == np.float32
    np.testing.assert_array_equal(sh_t[:, 0, :24, :24],
                                  shc.real.transpose(0, 2, 1))
    np.testing.assert_array_equal(sh_t[:, 1, :24, :24],
                                  shc.imag.transpose(0, 2, 1))
    assert not sh_t[:, :, 24:].any() and not sh_t[:, :, :, 24:].any()


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_k2_plain_adds_subharm_as_pallas(noise):
    from fast_tpu.ops import pallas_synth
    sqrt_ps, W, pm, shc, _ = subharm_inputs()
    nbatch, N, df = 4, 64, 0.3
    ref = np.asarray(pallas_synth.fused_synthesis_detect(
        1, sqrt_ps, df, nbatch, W, pm, interpret=True, precision="highest",
        noise=noise,
        subharm_screens=pallas_synth.pad_subharm_screens(shc, 24)))
    wr, wi, pm_t = tables(W, pm)
    zero = torch.zeros((nbatch, N, N), dtype=torch.int64)
    got = sd.synth_detect_reference(
        0, torch.from_numpy(np.ascontiguousarray(sqrt_ps.T * np.float32(df))),
        wr, wi, pm_t, nbatch,
        mix=(torch.from_numpy(sd.mixing_matrix(N).copy())
             if noise == "mixed" else None),
        bits=(zero, zero), sh_t=sd.pack_subharm(torch.from_numpy(shc)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_k1_plain_adds_subharm_as_pallas(noise):
    from fast_tpu.ops import pallas_synth
    _, W, pm, shc, L = subharm_inputs()
    nbatch, N = 4, 64
    ref = np.asarray(pallas_synth.fused_colfac_detect(
        3, L, W, pm, nbatch, interpret=True, precision="highest",
        noise=noise,
        subharm_screens=pallas_synth.pad_subharm_screens(shc, 24)))
    wr, wi, pm_t = tables(W, pm)
    S = cd.pack_tables(torch.from_numpy(L), mixed=noise == "mixed")
    zero = torch.zeros((nbatch, N, S.shape[1] // 2), dtype=torch.int64)
    got = cd.colfac_detect_reference(
        0, S, wr, wi, pm_t, nbatch, mixed=noise == "mixed",
        bits=(zero, zero), sh_t=sd.pack_subharm(torch.from_numpy(shc)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def in_distribution(r, ref, si_rel=0.2):
    r, ref = np.asarray(r, np.float64), np.asarray(ref, np.float64)
    assert r.shape == ref.shape and np.isfinite(r).all()
    se = np.hypot(r.std(), ref.std()) / np.sqrt(r.size)
    assert abs(r.mean() - ref.mean()) <= 5 * se
    si, si_ref = r.var() / r.mean() ** 2, ref.var() / ref.mean() ** 2
    assert abs(si - si_ref) <= si_rel * si_ref


@pytest.fixture(scope="module")
def jax_subharm_run():
    import fast_tpu
    sim = fast_tpu.Fast(small_params(SYNTH="matmul"))
    return sim.run().power / sim.diffraction_limit


# the kernels' plain versions draw their Philox bits in int64 torch ops:
# 2048 realizations ('gauss' for K1, whose 'mixed' noise draws 128 lanes
# per column) keep the file well inside its time
@pytest.mark.parametrize("synth,niter,noise", [
    ("auto", 2048, "mixed"), ("matmul", NITER, "mixed"),
    ("pallas_colfac", 2048, "gauss")])
def test_run_in_distribution(jax_subharm_run, synth, niter, noise):
    import fast_tpu_torch
    sim = fast_tpu_torch.Fast(small_params(SYNTH=synth, NITER=niter,
                                           MC_NOISE=noise, SEED=32),
                              device="cpu")
    assert sim._synth == {"auto": "pallas_fused"}.get(synth, synth)
    assert sim.subharmonics and sim.tables["sh_modes"].shape == (3, 3, 3,
                                                                 42, 42)
    res = sim.run()
    in_distribution(res.power / res._dl, jax_subharm_run[:niter])


def test_subharm_off_in_temporal_mode_and_absent_by_default():
    import fast_tpu_torch
    sim = fast_tpu_torch.Fast(small_params(SUBHARM=False, NITER=256),
                              device="cpu")
    assert not sim.subharmonics and sim.powerspec_subharm is None
    assert "sh_modes" not in sim.tables


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["synth_detect", "colfac_detect"])
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_kernel_with_subharm_matches_plain_on_card(cuda_device, kernel,
                                                   noise):
    sqrt_ps, W, pm, _, L = subharm_inputs()
    nbatch, N, mixed = 4100, 64, noise == "mixed"
    rng = np.random.default_rng(9)
    shc = (rng.normal(size=(nbatch, 24, 24))
           + 1j * rng.normal(size=(nbatch, 24, 24))).astype(np.complex64)
    sh_t = sd.pack_subharm(torch.from_numpy(shc)).to(cuda_device)
    wr, wi, pm_t = (t.to(cuda_device) for t in tables(W, pm))
    if kernel == "synth_detect":
        fn, ref_fn = sd.synth_detect, sd.synth_detect_reference
        s_t = torch.from_numpy(np.ascontiguousarray(
            sqrt_ps.T * np.float32(0.3 / np.sqrt((sqrt_ps ** 2).sum())))
        ).to(cuda_device)
        mix = (torch.from_numpy(sd.mixing_matrix(N).copy()).to(cuda_device)
               if mixed else None)
        args, kw = (7, s_t, wr, wi, pm_t, nbatch), dict(mix=mix)
    else:
        fn, ref_fn = cd.colfac_detect, cd.colfac_detect_reference
        S = cd.pack_tables(torch.from_numpy(L * 4), mixed=mixed)
        args, kw = (7, S.to(cuda_device), wr, wi, pm_t, nbatch), dict(
            mixed=mixed)
    before = fn.LAUNCHES
    got = fn(*args, stream=2, sh_t=sh_t, **kw)
    ref = ref_fn(*args, stream=2, sh_t=sh_t, **kw)
    torch.cuda.synchronize()
    assert fn.LAUNCHES == before + 2
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= KERNEL_REL * float(ref.abs().max())
