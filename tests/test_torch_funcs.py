"""The reference-name modules of fast_tpu_torch against fast_tpu's, on the
CPU: ``funcs``, ``ao_power_spectra`` and the ``models.ao`` functions they
need.

* Values: each function agrees with ``fast_tpu``'s to 1e-10 relative (of
  the largest |value|) in float64 on inputs made with numpy from a seed;
  the host numpy functions (frequency grids, beam parameters, PDFs,
  autocorrelation) exactly. ``make_phase_fft`` and ``make_phase_subharm``
  take the same coefficients in both packages; the temporal log-amplitude
  branch takes the same complex normal draws (each package's draw
  replaced by one numpy draw).
* Draws: ``generate_random_coefficients`` (a ``torch.Generator`` where
  ``fast_tpu`` takes a JAX key) and the iid log-amplitude draws agree in
  distribution with what both packages promise: mean 0 within 5 standard
  errors, variance within 5 standard errors of 1 (per part) or of the
  log-amplitude variance; the draws land on the generator's device.
* Names: ``ao_power_spectra`` has every name of ``fast_tpu``'s and each
  is the port's own function.
"""

import numpy as np
import pytest
import torch

import fast_tpu
import fast_tpu_torch
from fast_tpu import funcs as jf
from fast_tpu import grids as jg
from fast_tpu.models import ao as ja
from fast_tpu_torch import funcs as tf
from fast_tpu_torch import grids as tg
from fast_tpu_torch.models import ao as ta

torch.set_num_threads(1)

REL = 1e-10


def close(got, ref, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= rel * scale


def grid(N=32, dx=0.02):
    df = 2 * np.pi / (N * dx)
    return jg.SpatialFrequencyStruct(np.arange(-N / 2, N / 2) * df)


# ---------------------------------------------------------------------------
# funcs: host numpy functions, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("f_grid_linear", (25.0, 0.01)), ("f_grid_linear", (25.0, 0.001, 256)),
    ("f_grid_dx", (32, 0.05)), ("f_grid_log", (25.0, 0.01, 65)),
    ("f_grid_log", (25.0, 0.01, 64, False))], ids=str)
def test_frequency_grids_equal_fast_tpus(name, args):
    for a, b in zip(getattr(tf, name)(*args), getattr(jf, name)(*args)):
        np.testing.assert_array_equal(a, b)


def test_beam_parameters_and_pdfs_equal_fast_tpus():
    for args in ((1000.0, np.inf, 0.1, 1.55e-6), (5e5, 2e5, 0.05, 1e-6)):
        np.testing.assert_array_equal(
            tf.calc_gaussian_beam_parameters(*args),
            jf.calc_gaussian_beam_parameters(*args))
    Is = np.random.default_rng(1).uniform(1e-3, 5.0, 257)
    np.testing.assert_array_equal(tf.pdf_lognorm(Is, 0.4, 1.2),
                                  jf.pdf_lognorm(Is, 0.4, 1.2))
    for s2 in (0.2, 1.5):
        a, b = tf.gammagamma_parameters(s2)
        assert (a, b) == jf.gammagamma_parameters(s2)
        np.testing.assert_array_equal(tf.pdf_gammagamma(Is, a, b),
                                      jf.pdf_gammagamma(Is, a, b))
    I = np.random.default_rng(2).normal(size=300).cumsum()
    np.testing.assert_array_equal(tf.temporal_autocorrelation(I),
                                  jf.temporal_autocorrelation(I))


def test_pupil_filter_array_and_sampler():
    pupil = fast_tpu_torch.funcs.circle(10, 32)
    g = grid()
    close(tf.pupil_filter(g, pupil), jf.pupil_filter(g, pupil))
    sampler_t = tf.pupil_filter(g, pupil, spline=True)
    sampler_j = jf.pupil_filter(g, pupil, spline=True)
    rng = np.random.default_rng(3)
    rows = rng.uniform(g.fx_axis[0], g.fx_axis[-1], 17)
    cols = rng.uniform(g.fy_axis[0], g.fy_axis[-1], 9)
    close(sampler_t(rows, cols), sampler_j(rows, cols))


def test_reexports_are_the_ports_own():
    from fast_tpu_torch import engine
    from fast_tpu_torch.ops import apertures, integrate, rng
    for name in ("circle", "gaussian2d", "compute_pupil",
                 "compute_gaussian_mode", "coupling_loss", "optimize_fibre"):
        assert getattr(tf, name) is getattr(apertures, name)
    assert tf.integrate_path is integrate.integrate_path
    assert tf.integrate_powerspectrum is integrate.integrate_powerspectrum
    assert tf.complex_normal is rng.complex_normal
    assert tf.l_path is engine.l_path
    for zeta in (0.0, 30.0, 60.0):
        assert tf.l_path(500e3, zeta) == jf.l_path(500e3, zeta)
    h = np.array([0.0, 5e3, 10e3])
    np.testing.assert_array_equal(
        tf.calculate_wind_correction(h, [3600, 1800], 1.0),
        jf.calculate_wind_correction(h, [3600, 1800], 1.0))


# ---------------------------------------------------------------------------
# funcs: screens and draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("double", [False, True])
def test_make_phase_fft_same_coefficients(double):
    rng = np.random.default_rng(4)
    rand = rng.normal(size=(3, 32, 32)) + 1j * rng.normal(size=(3, 32, 32))
    got = tf.make_phase_fft(rand, 0.7, double=double)
    assert got.dtype == torch.float64
    close(got, jf.make_phase_fft(rand, 0.7, double=double))


@pytest.mark.parametrize("double", [False, True])
def test_make_phase_subharm_same_coefficients(double):
    N, dx = 32, 0.05
    jfreq, tfreq = jg.SpatialFrequencies(N, dx), tg.SpatialFrequencies(N, dx)
    jfreq.make_subharm_freqs()
    tfreq.make_subharm_freqs()
    rng = np.random.default_rng(5)
    rand = rng.normal(size=(4, 3, 3, 3)) + 1j * rng.normal(size=(4, 3, 3, 3))
    close(tf.make_phase_subharm(torch.from_numpy(rand), tfreq, N, dx,
                                double=double),
          jf.make_phase_subharm(rand, jfreq, N, dx, double=double))


def moments_agree(x, mean, var, sigmas=5.0):
    """Sample mean and variance of ``x`` within ``sigmas`` standard errors
    of ``mean`` and ``var`` (the variance's SE from the fourth moment)."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    assert abs(x.mean() - mean) <= sigmas * np.sqrt(var / n)
    se_var = np.sqrt((((x - x.mean()) ** 2 - x.var()) ** 2).mean() / n)
    assert abs(x.var() - var) <= sigmas * se_var


def test_random_coefficients_in_distribution():
    import jax
    gen = torch.Generator().manual_seed(6)
    z = tf.generate_random_coefficients(gen, (64, 128))
    assert z.dtype == torch.complex128 and z.shape == (64, 128)
    assert tf.generate_random_coefficients(
        gen, (3,), dtype=np.complex64).dtype == torch.complex64
    ref = np.asarray(jf.generate_random_coefficients(jax.random.key(6),
                                                     (64, 128)))
    for part in (np.real, np.imag):
        moments_agree(part(z.numpy()), 0.0, 1.0)
        moments_agree(part(ref), 0.0, 1.0)


def test_logamp_draws_iid_in_distribution():
    import jax
    gen = torch.Generator().manual_seed(7)
    x = tf.generate_random_coefficients_logamp(gen, 20000, 0.04)
    assert x.dtype == torch.float64 and x.shape == (20000,)
    moments_agree(x.numpy(), 0.0, 0.04)
    moments_agree(np.asarray(jf.generate_random_coefficients_logamp(
        jax.random.key(7), 20000, 0.04)), 0.0, 0.04)


def test_logamp_draws_temporal_same_draws(monkeypatch):
    """The coloured branch on identical complex normal draws."""
    import jax.numpy as jnp
    from fast_tpu import synthesis as js
    from fast_tpu_torch import synthesis as ts
    n = 512
    rng = np.random.default_rng(8)
    z = rng.normal(size=n) + 1j * rng.normal(size=n)
    ps = rng.random(n) ** 3
    monkeypatch.setattr(js, "complex_normal",
                        lambda key, shape, dtype: jnp.asarray(z, dtype))
    monkeypatch.setattr(ts, "complex_normal",
                        lambda shape, gen, dtype: torch.from_numpy(z))
    import jax
    close(tf.generate_random_coefficients_logamp(
        torch.Generator(), n, 0.05, temporal=True, temporal_powerspecs=ps),
        jf.generate_random_coefficients_logamp(
            jax.random.key(0), n, 0.05, temporal=True,
            temporal_powerspecs=ps))


# ---------------------------------------------------------------------------
# models.ao: the eight functions of the reference-name modules
# ---------------------------------------------------------------------------


def tensors(g):
    return [torch.from_numpy(a) for a in (g.fabs, g.fx, g.fy)]


@pytest.mark.parametrize("j", [1, 2, 3, 4, 5, 6, 7, 8, 11, 16])
def test_zernike_ft(j):
    g = grid()
    phi = np.arctan2(g.fy, g.fx)
    got = ta.zernike_ft(torch.from_numpy(g.fabs), torch.from_numpy(phi), 0.8,
                        j)
    assert got.dtype == torch.complex128
    close(got, ja.zernike_ft(g.fabs, phi, 0.8, j))
    close(ta.zernike_ft(g.fabs, phi, 0.8, j, x_max=60.0),
          ja.zernike_ft(g.fabs, phi, 0.8, j, x_max=60.0))


@pytest.mark.parametrize("kw", [dict(), dict(n_noll_start=2),
                                dict(gamma=[0.5, 1.0, 2.0]),
                                dict(n_noll_start=4, gamma=0.7)], ids=str)
def test_zernike_filter(kw):
    g = grid()
    fabs, fx, fy = tensors(g)
    close(ta.zernike_filter(fabs, fx, fy, 0.8, 10, **kw),
          ja.zernike_filter(g.fabs, g.fx, g.fy, 0.8, 10, **kw))


@pytest.mark.parametrize("name", ["piston_filter", "tiptilt_filter",
                                  "piston_tiptilt_filter"])
@pytest.mark.parametrize("x_max", [None, 70.0])
def test_bessel_highpass_filters(name, x_max):
    g = grid()
    close(getattr(ta, name)(torch.from_numpy(g.fabs), 0.8, x_max=x_max),
          getattr(ja, name)(g.fabs, 0.8, x_max=x_max))


@pytest.mark.parametrize("kw", [dict(), dict(modal=True, modal_mult=0.8),
                                dict(modal=True, Zmax=10, D=0.8),
                                dict(modal=True, Zmax=10, D=0.8, Gtilt=True)],
                         ids=str)
def test_mask_hf(kw):
    g = grid()
    close(ta.mask_hf(tg.SpatialFrequencyStruct(g.fx_axis), 0.1, **kw),
          ja.mask_hf(g, 0.1, **kw))


@pytest.mark.parametrize("mode", ["perfect", "zernike"])
def test_dm_transfer_function(mode):
    g = grid()
    fabs, fx, fy = tensors(g)
    got = ta.DM_transfer_function(fx, fy, fabs, mode, Zmax=6, D=0.8,
                                  dsubap=0.1)
    ref = ja.DM_transfer_function(g.fx, g.fy, g.fabs, mode, Zmax=6, D=0.8,
                                  dsubap=0.1)
    if mode == "perfect":
        assert got == ref == 1.0
    else:
        close(got, ref)
    with pytest.raises(NotImplementedError):
        ta.DM_transfer_function(fx, fy, fabs, "piezo")


H = [0.0, 5000.0, 10000.0]
WINDS = np.random.default_rng(9).normal(size=(3, 2)) * 10


@pytest.mark.parametrize("kw", [
    dict(),
    dict(v=WINDS, dtheta=(4, 1), Delta_t=0.001, tl=0.001, gloop=0.5),
    dict(v=WINDS, DM="zernike", Zmax=6, D=0.8, nu=0.7, Delta_t=0.002,
         dsubap=0.1, modal=True, modal_mult=0.9)], ids=["defaults", "winds",
                                                        "zernike DM"])
def test_g_ao_paola_closedloop(kw):
    g = grid()
    fabs, fx, fy = tensors(g)
    close(ta.G_AO_PAOLA_closedloop(fx, fy, fabs, H, **kw),
          ja.G_AO_PAOLA_closedloop(g.fx, g.fy, g.fabs, H, **kw))


# ---------------------------------------------------------------------------
# ao_power_spectra
# ---------------------------------------------------------------------------


def test_ao_power_spectra_names():
    from fast_tpu import ao_power_spectra as japs
    from fast_tpu_torch import ao_power_spectra as taps
    from fast_tpu_torch.models import atmosphere, scintillation
    names = [n for n in dir(japs) if not n.startswith("_")]
    assert len(names) == 16
    for n in names:
        own = getattr(ta, n, None) or getattr(scintillation, n, None) \
            or getattr(atmosphere, n)
        assert getattr(taps, n) is own
    assert fast_tpu_torch.ao_power_spectra is taps
    assert fast_tpu.ao_power_spectra is japs
