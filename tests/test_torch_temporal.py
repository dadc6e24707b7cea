"""The temporal (frozen-flow) mode of fast_tpu_torch against fast_tpu, on
the CPU, at ``tests/conftest.py:make_test_params`` sizes (the AR runs on a
64^2 grid at DX = 0.02 m, 120 steps).

* Analytic fields of the temporal mode (grids, the temporal log-amplitude
  PSD, the high-resolution pupil filter, pixel shifts, AR survival
  factors, the grown grid and the 'auto' route) agree with
  ``fast_tpu.Fast`` on the same params to 1e-10 of each field's maximum.
* The stock-op pieces agree with the JAX functions on the same numpy
  inputs: interpolation and frozen-flow sampling to 1e-5 absolute on
  float32 screens of order 1 (bilinear weights in another order), the AR
  recursion without boiling to 2e-6 on states of order 1, the coloured
  log-amplitude series from the same injected complex noise to 1e-9 of
  its largest value in float64.
* The JAX engine's AR tables through ``tables_from_numpy`` give the port's
  own tables.
* Runs agree with ``fast_tpu.Fast(p).run()`` in distribution, as
  ``tests/test_temporal.py::test_temporal_crossval_statistics`` holds the
  JAX package to the reference: |log ratio of means| < 0.5 and lag-1
  autocorrelations within 0.3 (one short correlated series each). The
  'ar' kernel route equals the SYNTH='fft' route from one seed to 2e-3
  relative, and no route depends on NCHUNKS.
"""

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch import synthesis as ts
from fast_tpu_torch.interop import tables_from_numpy
from fast_tpu_torch.ops import ar_flow as af
from fast_tpu_torch.ops import interp

torch.set_num_threads(1)


def params(**overrides):
    """``make_test_params`` of tests/conftest.py with TEMPORAL=True."""
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": "auto", "DX": 0.01, "NITER": 200, "NCHUNKS": 4,
        "TEMPORAL": True, "D_GROUND": 0.8, "OBSC_GROUND": 0, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "PROP_DIR": "up", "DTHETA": [4, 0],
        "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001, "TEXP": 0.001,
        "ALIAS": True, "NOISE": 0, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 6, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


SCREENS = dict(TEMPORAL_SYNTH="auto")
AR = dict(TEMPORAL_SYNTH="ar", NPXLS=64, DX=0.02, NITER=120,
          TEMPORAL_ALPHA=0.98, SEED=9)
LONG = dict(NITER=50000, NCHUNKS=500, NPXLS=64, DX=0.02, SEED=4)


@pytest.fixture(scope="module")
def jax_sims():
    """One JAX engine per configuration, built once; the two short ones
    run."""
    import fast_tpu
    sims = {k: fast_tpu.Fast(params(**o))
            for k, o in (("screens", SCREENS), ("ar", AR), ("long", LONG))}
    for k in ("screens", "ar"):
        sims[k].run()
    return sims


@pytest.fixture(scope="module")
def port_sims():
    sims = {k: fast_tpu_torch.Fast(params(**o), device="cpu")
            for k, o in (("screens", SCREENS), ("ar", AR), ("long", LONG))}
    for k in ("screens", "ar"):
        sims[k].run()
    return sims


def close(got, ref, rel=1e-10):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-300)


# --------------------------------------------------------------------------
# (c) analytic fields and the route rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which,route,npxls", [
    ("screens", "screens", 326), ("ar", "ar", 64), ("long", "ar", 64)])
def test_route_and_grid_follow_the_jax_rule(jax_sims, port_sims, which, route,
                                            npxls):
    js, ps = jax_sims[which], port_sims[which]
    assert ps._temporal_synth == js._temporal_synth == route
    assert ps.Npxls == js.Npxls == npxls  # 'screens' grows it, 'ar' does not
    assert ps.subharmonics is False and ps.Npxls_pup == js.Npxls_pup
    assert (ps._ar_route is None) == (route == "screens")


@pytest.mark.parametrize("name", [
    "temporal_logamp_powerspec", "pixel_shifts", "powerspec_per_layer",
    "powerspec", "logamp_var", "lf_mask_temporal", "_ar_alpha",
    "_sqrt_psd_layers", "diffraction_limit", "_norm"])
@pytest.mark.parametrize("which", ["screens", "ar"])
def test_fields_match(jax_sims, port_sims, which, name):
    close(getattr(port_sims[which], name), getattr(jax_sims[which], name))


def test_long_series_fields(jax_sims, port_sims):
    """NITER=50000 on a 64^2 grid: 'auto' picks the AR route, boiling is on
    (alpha < 1, the JAX package's wrap-time rule), and the streamed
    temporal PSD has one bin per step."""
    js, ps = jax_sims["long"], port_sims["long"]
    assert (ps._ar_alpha < 1).any()
    close(ps._ar_alpha, js._ar_alpha)
    assert ps._temporal_materialized == js._temporal_materialized
    assert ps.temporal_logamp_powerspec.shape == (50000,)
    close(ps.temporal_logamp_powerspec, js.temporal_logamp_powerspec)
    assert "ns" in ps.tables and ps.tables["ph"].dtype == torch.complex64
    # a short series keeps pure frozen flow under 'auto'
    short = fast_tpu_torch.Fast(params(NITER=50, NPXLS=164, NCHUNKS=1,
                                       TEMPORAL_SYNTH="ar"), device="cpu")
    assert (short._ar_alpha == 1).all() and "ns" not in short.tables


@pytest.mark.parametrize("grid,names", [
    ("temporal", ["fx_axis", "fy_axis", "fx", "fy", "fabs", "dfx", "dfy"]),
    ("logamp", ["fx_axis", "fy_axis", "fabs", "dfx", "dfy"])])
def test_temporal_grids_match(jax_sims, port_sims, grid, names):
    jg = getattr(jax_sims["screens"].freq, grid)
    pg = getattr(port_sims["screens"].freq, grid)
    assert pg.df is None and jg.df is None
    for n in names:
        close(getattr(pg, n), getattr(jg, n))


def test_pupil_filter_sampler_matches(jax_sims, port_sims):
    jf = jax_sims["screens"].pupil_filter_temporal
    pf = port_sims["screens"].pupil_filter_temporal
    close(pf.P.numpy(), np.asarray(jf.P))
    rng = np.random.default_rng(0)
    # inside the table, on its edges and beyond them (clamped)
    rows = np.concatenate([rng.uniform(-400, 400, 50), [pf.x0, -1e4, 1e4]])
    cols = np.concatenate([rng.uniform(-400, 400, 40), [pf.y0, -1e4, 1e4]])
    got = pf(rows, cols)
    assert got.dtype == torch.float64 and got.shape == (53, 43)
    close(got.numpy(), np.asarray(jf(rows, cols)))


@pytest.mark.parametrize("overrides,match", [
    ({"TEMPORAL_SYNTH": "banana"}, "TEMPORAL_SYNTH"),
    ({"TEMPORAL_NOISE": "banana"}, "TEMPORAL_NOISE")])
def test_bad_temporal_keys_rejected(overrides, match):
    with pytest.raises(ValueError, match=match):
        fast_tpu_torch.Fast(params(**overrides), device="cpu")


def test_what_temporal_mode_still_refuses(capsys):
    """``run(progress=True)`` used to be refused here; it now runs and
    gives the numbers of ``run()``. An iid sim still refuses the temporal
    reference API."""
    sim = fast_tpu_torch.Fast(params(**dict(AR, NITER=8, NCHUNKS=2)),
                              device="cpu")
    ref = np.asarray(sim.run().power)
    np.testing.assert_array_equal(np.asarray(sim.run(progress=True).power),
                                  ref)
    assert "steps/s" in capsys.readouterr().err
    iid = fast_tpu_torch.Fast(params(TEMPORAL=False, NPXLS=64, DX=0.02),
                              device="cpu")
    with pytest.raises(ValueError, match="TEMPORAL=True"):
        iid.compute_phs_temporal()


# --------------------------------------------------------------------------
# (b), (c) the stock-op pieces against the JAX functions
# --------------------------------------------------------------------------


def test_interpolation_matches_jax():
    import jax.numpy as jnp
    from fast_tpu.ops import interp as jinterp
    rng = np.random.default_rng(1)
    img = rng.normal(size=(2, 32, 32)).astype(np.float32)
    rows = rng.uniform(-70, 70, (5, 7)).astype(np.float32)
    cols = rng.uniform(-70, 70, (5, 7)).astype(np.float32)
    ref = np.asarray(jinterp.bilinear_periodic(jnp.asarray(img), rows, cols))
    got = interp.bilinear_periodic(torch.from_numpy(img),
                                   torch.from_numpy(rows),
                                   torch.from_numpy(cols))
    assert got.shape == (2, 5, 7)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    ref = np.asarray(jinterp.sample_grid_periodic(
        jnp.asarray(img[0]), rows[0], cols[1]))
    got = interp.sample_grid_periodic(torch.from_numpy(img[0]),
                                      torch.from_numpy(rows[0]),
                                      torch.from_numpy(cols[1]))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # integer coordinates pick pixels, wrapped
    pix = interp.bilinear_periodic(torch.from_numpy(img[0]),
                                   torch.tensor([33.0]), torch.tensor([-1.0]))
    assert float(pix) == img[0, 1, 31]


def test_sample_frozen_flow_and_layer_screens_match_jax():
    import jax
    import jax.numpy as jnp
    from fast_tpu import synthesis as js
    rng = np.random.default_rng(2)
    screens = rng.normal(size=(3, 48, 48)).astype(np.float32)
    rows = rng.uniform(0, 200, (3, 6, 9)).astype(np.float32)
    cols = rng.uniform(-50, 50, (3, 6, 9)).astype(np.float32)
    ref = np.asarray(js.sample_frozen_flow(jnp.asarray(screens), rows, cols))
    got = ts.sample_frozen_flow(*(torch.from_numpy(x)
                                  for x in (screens, rows, cols)))
    assert got.shape == (6, 9, 9)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the layer screens: same distribution (variance per layer of the sum
    # of PSD df^2, within 25% for one 48^2 screen each)
    sqrt_ps = (rng.random((3, 48, 48)) + 0.5).astype(np.float32)
    scr = ts.synthesize_layer_screens(torch.Generator().manual_seed(3),
                                      torch.from_numpy(sqrt_ps), 0.7)
    ref = np.asarray(js.synthesize_layer_screens(jax.random.key(3), sqrt_ps,
                                                 0.7))
    assert scr.shape == ref.shape and scr.dtype == torch.float32
    expect = ((sqrt_ps * 0.7) ** 2).sum((1, 2))
    np.testing.assert_allclose(scr.numpy().var((1, 2)), expect, rtol=0.25)
    np.testing.assert_allclose(ref.var((1, 2)), expect, rtol=0.25)


def ar_inputs(L=2, N=32, seed=5):
    rng = np.random.default_rng(seed)
    a0 = (rng.normal(size=(L, N, N))
          + 1j * rng.normal(size=(L, N, N))).astype(np.complex64)
    ph = np.exp(1j * rng.uniform(-3, 3, (L, N, N))).astype(np.complex64)
    sqrt_psd_df = rng.uniform(0.5, 2.0, (L, N, N)).astype(np.float32)
    return a0, ph, sqrt_psd_df


def test_ar_flow_series_and_couplings_match_jax_without_boiling():
    import jax
    import jax.numpy as jnp
    from fast_tpu import synthesis as js
    L, N, nsteps, lo, hi = 2, 32, 6, 8, 24
    a0, ph, spd = ar_inputs(L, N)
    ones = np.ones((L, 1, 1), np.float32)
    a_ref, _, A_ref = js.ar_flow_series(
        jnp.asarray(a0), jax.random.key(0), jnp.asarray(ph), jnp.asarray(spd),
        jnp.asarray(ones), jnp.asarray(0 * ones), nsteps, False)
    t = [torch.from_numpy(x) for x in (a0, ph, spd, ones, 0 * ones)]
    a, A = ts.ar_flow_series(t[0], None, *t[1:], nsteps, False)
    assert A.shape == (nsteps, N, N) and A.dtype == torch.complex64
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=2e-6)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), atol=4e-6)

    rng = np.random.default_rng(6)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((hi - lo, hi - lo)).astype(np.float32)
    chi = (0.1 * rng.normal(size=nsteps)).astype(np.float32)
    a0s = 0.02 * a0  # a screen of a few radians
    a_ref, _, out_ref = js.ar_flow_couplings(
        jnp.asarray(a0s), jax.random.key(0), jnp.asarray(ph),
        jnp.asarray(spd), jnp.asarray(ones), jnp.asarray(0 * ones),
        jnp.asarray(chi), W, pm, 0.01, 0.3, False, precision="highest")
    a, out = ts.ar_flow_couplings(
        torch.from_numpy(a0s), None, *t[1:], torch.from_numpy(chi),
        torch.from_numpy(W), torch.from_numpy(pm), 0.01, 0.3, False)
    assert out.shape == (nsteps,) and out.dtype == torch.complex64
    ref = np.asarray(out_ref)
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), atol=1e-7)


def test_ar_boiling_takes_a_generator_or_the_kernels_stream():
    L, N = 2, 16
    a0, ph, spd = (torch.from_numpy(x) for x in ar_inputs(L, N))
    alpha = torch.full((L, 1, 1), 0.9)
    s1ma = torch.sqrt(1 - alpha ** 2)
    stream = af.NoiseStream(7, L, N, end=5, noise="gauss")
    a, A = ts.ar_flow_series(a0, stream, ph, spd, alpha, s1ma, 3, True,
                             step0=2)
    z1, z2 = af.ar_noise(7, 2, 3, L, N, "gauss")
    b = a0
    for t in range(3):
        b = alpha * (ph * b) + s1ma * (torch.complex(z1[t], z2[t]) * spd)
        assert torch.equal(A[t], b.sum(0))
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(1)
    a2, _ = ts.ar_flow_series(a0, g, ph, spd, alpha, s1ma, 3, True)
    assert a2.shape == a0.shape and not torch.equal(a2, a)


def test_pure_frozen_flow_is_exact_translation():
    """alpha = 1: step t is the (t + 1)-pixel periodic roll of step 0
    (``tests/test_temporal.py``, the same tolerances)."""
    from fast_tpu_torch.ops.fourier import ift2
    N, dx = 32, 0.02
    df = 2 * np.pi / (N * dx)
    fxm = np.tile(np.arange(-N / 2, N / 2) * df, (N, 1))
    rng = np.random.default_rng(2)
    spd = torch.from_numpy(rng.uniform(0.5, 1, (1, N, N)).astype(np.float32))
    # a wind of exactly one pixel per step along x (dt = 1)
    phase = ts.ar_step_phase(fxm, fxm.T, [[dx, 0.0]], 1.0)
    assert np.abs(phase).max() <= np.pi
    ph = torch.from_numpy(np.exp(1j * phase).astype(np.complex64))
    a0 = torch.from_numpy((rng.normal(size=(1, N, N)) + 1j * rng.normal(
        size=(1, N, N))).astype(np.complex64)) * spd
    one = torch.ones((1, 1, 1))
    _, A = ts.ar_flow_series(a0, None, ph, spd, one, 0 * one, 5, False)
    scr = ift2(A, 1.0).real.numpy()
    scr0 = ift2(a0.sum(0), 1.0).real.numpy()
    for t in range(5):
        np.testing.assert_allclose(scr[t], np.roll(scr0, -(t + 1), axis=1),
                                   rtol=2e-4, atol=2e-5)


def test_coloured_logamp_matches_jax_on_injected_noise(jax_sims):
    import jax
    from fast_tpu import synthesis as js
    sim = jax_sims["screens"]
    key = jax.random.key(1)
    ref = np.asarray(js.draw_logamp(
        key, sim.Niter, sim.logamp_var,
        temporal_powerspec=sim.temporal_logamp_powerspec, dtype=np.float64))
    z = np.asarray(js.complex_normal(key, (sim.Niter,), dtype=np.complex128))
    got = ts.draw_logamp(None, sim.Niter, sim.logamp_var,
                         temporal_powerspec=sim.temporal_logamp_powerspec,
                         dtype=torch.float64,
                         r_fourier=torch.from_numpy(z.copy()))
    assert got.dtype == torch.float64 and got.shape == (sim.Niter,)
    close(got.numpy(), ref, rel=1e-9)
    # its own draw: the variance and a positive lag-1 correlation
    own = ts.draw_logamp(torch.Generator().manual_seed(5), 4000,
                         sim.logamp_var, temporal_powerspec=np.interp(
                             np.linspace(0, 1, 4000), np.linspace(0, 1, 200),
                             sim.temporal_logamp_powerspec),
                         dtype=torch.float64).numpy()
    assert abs(own.var() / sim.logamp_var - 1) < 0.4
    assert (own[:-1] * own[1:]).mean() > 0.2 * own.var()


# --------------------------------------------------------------------------
# (e) the JAX engine's tables through tables_from_numpy
# --------------------------------------------------------------------------


def test_ar_tables_from_the_jax_engine(jax_sims, port_sims):
    js, ps = jax_sims["ar"], port_sims["ar"]
    C = {k: np.asarray(v)
         for k, v in js._run_all_fn_temporal_ar().keywords["C"].items()}
    phase = ts.ar_step_phase(js.freq.main.fx, js.freq.main.fy,
                             js.wind_vector, js.dt)
    T = tables_from_numpy(dict(
        powerspec=js.powerspec, pupil_mode=js.pupil * js.pupil_mode,
        W_pruned=C["w2"][0] + 1j * C["w2"][1], df=float(js.freq.main.df),
        dx=js.dx, norm=js._norm, logamp_var=js.logamp_var,
        diffraction_limit=js.diffraction_limit, pup_crop=js.pup_crop,
        powerspec_per_layer=js.powerspec_per_layer,
        temporal_ps=js.temporal_logamp_powerspec, step_phase=phase,
        ar_alpha=js._ar_alpha))
    for k, ck in (("sqrt_psd_df", "sqrt_psd_df"), ("alpha", "alpha"),
                  ("pm", "pm"), ("temporal_ps", "temporal_ps")):
        np.testing.assert_allclose(T[k].numpy(), C[ck], rtol=1e-6, atol=0)
    # the phase is wrapped in float64 before the cast in both
    np.testing.assert_allclose(T["step_phase"].numpy(), C["step_phase"],
                               atol=1e-6)
    assert np.array_equal(T["W"].numpy(),
                          (C["w2"][0] + 1j * C["w2"][1]).astype(np.complex64))
    # the kernels' tables, folded in float64 as the JAX engine folds them
    # for the TPU kernel (``fast_tpu/engine.py``, _build_run_all_fn_
    # temporal_ar)
    alpha = np.float64(js._ar_alpha)
    ph = (np.exp(1j * phase) * alpha[:, None, None]).astype(np.complex64)
    ns = (np.sqrt(np.maximum(0.0, 1.0 - alpha ** 2))[:, None, None]
          * np.float64(C["sqrt_psd_df"])).astype(np.float32)
    assert np.array_equal(T["ph"].numpy(), ph)
    assert np.array_equal(T["ns"].numpy(), ns)
    assert "mix" not in T and "wind_px" not in T
    for k in ("sqrt_psd_df", "step_phase", "step_phasor", "alpha", "ph",
              "ns", "W", "pm", "temporal_ps", "sqrt_psd_layers"):
        torch.testing.assert_close(ps.tables[k], T[k], rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# (d) the slice as a whole
# --------------------------------------------------------------------------


def lag1(x):
    x = x / x.mean() - 1
    return (x[:-1] * x[1:]).mean() / (x * x).mean()


def in_distribution(sim, jsim):
    r = np.asarray(sim.result.power) / sim.diffraction_limit
    ref = np.asarray(jsim.result.power) / jsim.diffraction_limit
    assert r.shape == ref.shape == (sim.Niter,) and np.isfinite(r).all()
    assert (r >= 0).all()
    assert abs(np.log(ref.mean() / r.mean())) < 0.5
    assert abs(lag1(ref) - lag1(r)) < 0.3
    assert lag1(r) > 0.5


@pytest.mark.parametrize("which", ["screens", "ar"])
def test_run_in_distribution(jax_sims, port_sims, which):
    in_distribution(port_sims[which], jax_sims[which])
    assert port_sims[which]._ar_route == (None if which == "screens"
                                          else "kernel")


def test_ar_kernel_route_equals_fft_route_from_one_seed(jax_sims, port_sims):
    """The port's twin of ``test_fused_coupling_path_matches_fft_path``:
    the same noise stream through the per-step pruned DFT (the kernel's
    plain version on the CPU) and through the batched exact ift2."""
    s_ft = fast_tpu_torch.Fast(params(**AR, SYNTH="fft"), device="cpu")
    assert s_ft._ar_route == "fft" and port_sims["ar"]._ar_route == "kernel"
    before = af.ar_flow_fused.LAUNCHES
    I_ft = np.asarray(s_ft.run().power)
    assert af.ar_flow_fused.LAUNCHES == before
    np.testing.assert_allclose(np.asarray(port_sims["ar"].result.power), I_ft,
                               rtol=2e-3, atol=1e-9)
    in_distribution(s_ft, jax_sims["ar"])


@pytest.mark.parametrize("overrides", [
    SCREENS, AR, dict(AR, SYNTH="fft"), dict(AR, TEMPORAL_NOISE="gauss"),
    dict(AR, DTYPE="float64", TEMPORAL_ALPHA="auto"),
    dict(SCREENS, DTYPE="float64")],
    ids=["screens", "ar", "ar-fft", "ar-gauss", "ar-float64",
         "screens-float64"])
def test_series_does_not_depend_on_nchunks(port_sims, overrides):
    one = fast_tpu_torch.Fast(params(**overrides, NCHUNKS=1), device="cpu")
    r1 = np.asarray(one.run().power)
    if overrides in (SCREENS, AR):
        r4 = np.asarray(port_sims["screens" if overrides is SCREENS
                                  else "ar"].result.power)
    else:
        r4 = np.asarray(fast_tpu_torch.Fast(params(**overrides),
                                            device="cpu").run().power)
    assert one.Nchunks == 1 and r1.dtype == r4.dtype
    np.testing.assert_array_equal(r1, r4)


def test_float64_and_coherent_runs(jax_sims):
    sim = fast_tpu_torch.Fast(params(**AR, DTYPE="float64", COHERENT=True),
                              device="cpu")
    assert sim._ar_route == "fft" and sim._synth == "fft"
    res = sim.run()
    assert np.iscomplexobj(res._r) and res._r.dtype == np.complex128
    power = np.abs(res._r) ** 2
    ref = (np.asarray(jax_sims["ar"].result.power)
           / jax_sims["ar"].diffraction_limit)
    assert abs(np.log(ref.mean() / power.mean())) < 0.5
    assert lag1(power) > 0.5


@pytest.mark.parametrize("which", ["screens", "ar"])
def test_reference_api_reproduces_the_run(port_sims, which):
    """``compute_phs_temporal`` and ``compute_detector`` give the run's own
    chunk (AR: through the exact ift2, to the 2e-3 of the route test) and
    ``logamp`` the run's coloured series."""
    sim = port_sims[which]
    B = sim.Niter_per_chunk
    phs = sim.compute_phs_temporal(chunk=1)
    assert phs.shape == (B, sim.Npxls_pup, sim.Npxls_pup)
    got = sim.compute_detector(chunk=1) * sim.diffraction_limit
    np.testing.assert_allclose(got, np.asarray(sim.result.power)[B:2 * B],
                               rtol=2e-3 if which == "ar" else 1e-5)
    chi = sim.logamp
    assert chi.shape == (sim.Niter,) and np.array_equal(
        chi, sim.compute_logamp())
    assert (chi[:-1] * chi[1:]).mean() > 0


# --------------------------------------------------------------------------
# on the card (python -m pytest --noconftest tests/test_torch_temporal.py
# -m cuda)
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nlayers,kernel", [(4, "ar_flow_fused"),
                                            (10, "ar_flow_streamed")])
def test_ar_run_goes_through_the_kernel_on_card(cuda_device, nlayers, kernel):
    """On the card the float32 'ar' route launches K4 (K5 over 8 layers),
    one launch per chunk, equals the SYNTH='fft' route from the same seed
    and does not depend on NCHUNKS."""
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(nlayers)
    o = dict(AR, H_TURB=h, CN2_TURB=cn2, WIND_SPD=w,
             WIND_DIR=np.arange(nlayers) * (360.0 / nlayers))
    fused, streamed = af.ar_flow_fused, af.ar_flow_streamed
    fused.LAUNCHES = streamed.LAUNCHES = 0
    sim = fast_tpu_torch.Fast(params(**o), device=cuda_device)
    r4 = np.asarray(sim.run().power)
    assert getattr(af, kernel).LAUNCHES == sim.Nchunks
    assert fused.LAUNCHES + streamed.LAUNCHES == sim.Nchunks
    r1 = np.asarray(fast_tpu_torch.Fast(params(**o, NCHUNKS=1),
                                        device=cuda_device).run().power)
    np.testing.assert_array_equal(r1, r4)
    r_ft = np.asarray(fast_tpu_torch.Fast(params(**o, SYNTH="fft"),
                                          device=cuda_device).run().power)
    np.testing.assert_allclose(r4, r_ft, rtol=2e-3, atol=1e-9)


@pytest.mark.cuda
def test_ar_kernel_refuses_a_wide_pupil_on_card(cuda_device):
    """A 202 px pupil used to be refused on the card; the AR kernels now
    tile it, and the kernel route equals the SYNTH='fft' route."""
    o = dict(TEMPORAL_SYNTH="ar", NPXLS=512, D_GROUND=2.0, NITER=64,
             NCHUNKS=2, TEMPORAL_ALPHA=0.98)
    af.ar_flow_fused.LAUNCHES = 0
    sim = fast_tpu_torch.Fast(params(**o), device=cuda_device)
    assert sim.Npxls_pup == 202 and sim._ar_route == "kernel"
    r = np.asarray(sim.run().power)
    assert af.ar_flow_fused.LAUNCHES == 2
    r_ft = np.asarray(fast_tpu_torch.Fast(params(**o, SYNTH="fft"),
                                          device=cuda_device).run().power)
    np.testing.assert_allclose(r, r_ft, rtol=2e-3, atol=1e-9)
