"""The public surface of fast_tpu_torch against fast_tpu's, on the CPU.

* Signatures: every function below has ``fast_tpu``'s parameter list,
  names, kinds, order and defaults (the five ``parallel`` functions,
  ``Fast.compute_phs_temporal`` and the tooling's ``trace``, ``annotate``,
  ``integrated_autocorr_time``, ``ks_2samp_correlated`` and ``table_key``
  among them). Two differences are kept: a
  ``torch.Generator`` (``generator``) where JAX takes a PRNG key (``key``),
  and a last keyword ``device=None``, the run device, on the comms
  functions that ``fast_tpu`` runs as jitted programs (``DEVICE_ARG``).
* Values: each of them agrees with ``fast_tpu``'s to 1e-10 relative in
  float64 on inputs made with numpy from a seed, for every argument the
  port gained (``freq`` with a per-layer grid, ``pupilfilter`` as array,
  sampler or None, ``layer=``, ``h=``, ``Gtilt=``, ``gamma=``,
  ``plusminus=``, ``v=None``, ``wvl=``, ``x_max=``, ``crop=``, ``dtype=``).
  The subharmonic screens draw their weights from a generator or a key,
  so both packages' normal draws are replaced by the same numpy values.
* Names: every public name of a ``fast_tpu`` module that the port has is
  in the port's module too, but for the names in ``LEFT_OUT``, each with
  its reason; ``Fast`` has every method of ``fast_tpu.Fast``;
  ``fast_tpu_torch.__all__`` is ``fast_tpu.__all__`` with ``interop``, its
  modules attributes after ``import fast_tpu_torch``; no message of the
  port names a ROADMAP item.
* ``Fast.compute_mean_irradiance`` (both ``onaxis`` values) equals
  ``fast_tpu.Fast``'s to 1e-10 relative on a small link and on
  ``conf.DEFAULTS``; ``sample_screens`` gives ``fast_tpu``'s shapes and a
  pixel variance within 5 standard errors of ``sum(PSD) df^2``, the
  variance of a pixel of an FFT screen.
"""

import functools
import importlib
import inspect
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fast_tpu
import fast_tpu_torch
from fast_tpu import grids as jg
from fast_tpu_torch import grids as tg

torch.set_num_threads(1)

REL = 1e-10

# (module, function) pairs that share a name and now a signature
FUNCTIONS = [
    ("models.atmosphere", "turb_powerspectrum_vonKarman"),
    ("models.scintillation", "logamp_powerspec"),
    ("ops.integrate", "integrate_path"),
    ("models.ao", "mask_lf"),
    ("models.ao", "zernike_squared_filter"),
    ("models.ao", "Jol_alias_openloop"),
    ("models.ao", "G_AO_PAOLA"),
    ("models.ao", "piston_gtilt_filter"),
    ("ops.bessel", "besselj"),
    ("synthesis", "synthesize_subharm_complex"),
    ("synthesis", "make_subharm_modes"),
    ("synthesis", "synthesize_screens_pruned"),
    ("synthesis", "synthesize_screens_colfac"),
    ("grids", "mesh_frequency_axes"),
    ("models.ao", "zernike_ft"),
    ("models.ao", "zernike_filter"),
    ("models.ao", "piston_filter"),
    ("models.ao", "tiptilt_filter"),
    ("models.ao", "piston_tiptilt_filter"),
    ("models.ao", "mask_hf"),
    ("models.ao", "DM_transfer_function"),
    ("models.ao", "G_AO_PAOLA_closedloop"),
] + [("funcs", n) for n in (
    "f_grid_linear", "f_grid_dx", "f_grid_log",
    "calc_gaussian_beam_parameters", "pdf_lognorm", "pdf_gammagamma",
    "gammagamma_parameters", "pupil_filter", "generate_random_coefficients",
    "generate_random_coefficients_logamp", "make_phase_fft",
    "make_phase_subharm", "temporal_autocorrelation")] + [
    ("comms", n) for n in (
        "define_constellation", "gray_labels_qam", "fade_prob", "fade_dur",
        "Q", "ber_ook", "sep_qam", "ber_qam", "convolve_awgn_qam",
        "generalised_mutual_information_qam", "mutual_information_qam",
        "pack_payload", "unpack_payload", "flip_bits", "Modulator")] + [
    ("parallel", n) for n in (
        "make_mesh", "run_sharded", "sharded_moments", "make_scan_mesh",
        "run_scan_sharded")] + [("engine", "Fast.compute_phs_temporal")] + [
    ("utils.profiling", "trace"), ("utils.profiling", "annotate"),
    ("utils.stats", "integrated_autocorr_time"),
    ("utils.stats", "ks_2samp_correlated"), ("utils.diskcache", "table_key")]

# the comms functions that fast_tpu runs as jitted programs on its default
# backend: the port's take the run device as a last keyword, device=None
# (a tensor input's device, else "cuda")
DEVICE_ARG = {("comms", n) for n in (
    "Modulator", "fade_dur", "convolve_awgn_qam",
    "generalised_mutual_information_qam", "mutual_information_qam")}

# public names of fast_tpu modules that the port leaves out, with the reason
LEFT_OUT = {
    "engine": {"make_key": "a JAX PRNG key: the port takes a "
                           "torch.Generator"},
    "ops.rng": {"make_key": "a JAX PRNG key: the port takes a "
                            "torch.Generator"},
    "funcs": {"make_key": "a JAX PRNG key: the port takes a "
                          "torch.Generator"},
    "parallel.mesh": {"FastResult": "an import of the JAX module, not its "
                                    "surface (fast_tpu_torch.FastResult)"},
    "parallel.scan": {"make_key": "a JAX PRNG key: the port takes a "
                                  "torch.Generator",
                      "FastResult": "an import of the JAX module, not its "
                                    "surface (fast_tpu_torch.FastResult)"},
}
MODULES = ["", "engine", "grids", "synthesis", "psd", "conf", "orbit",
           "sweep", "turbulence_models", "complete_orbit_simulation", "ops",
           "models", "models.ao", "models.atmosphere", "models.scintillation",
           "ops.integrate", "ops.bessel", "ops.fourier", "ops.apertures",
           "ops.zernike", "ops.interp", "ops.rng", "parallel",
           "parallel.mesh", "parallel.scan", "utils", "utils.fits",
           "utils.log", "utils.profiling", "utils.stats", "utils.diskcache",
           "funcs", "ao_power_spectra", "comms"]


def _mod(pkg, name):
    return importlib.import_module(pkg + ("." + name if name else ""))


def _default(v):
    """A default for comparison: dtypes by their numpy dtype."""
    try:
        return ("dtype", np.dtype(v)) if isinstance(v, type) else v
    except TypeError:
        return v


@pytest.mark.parametrize("mod,name", FUNCTIONS, ids=lambda x: str(x))
def test_signature_is_fast_tpus(mod, name):
    def find(pkg):
        return functools.reduce(getattr, name.split("."), _mod(pkg, mod))

    ref, got = inspect.signature(find("fast_tpu")), inspect.signature(
        find("fast_tpu_torch"))

    def params(sig):
        return [("generator" if p.name == "key" else p.name, p.kind,
                 _default(p.default)) for p in sig.parameters.values()]

    got = params(got)
    if (mod, name) in DEVICE_ARG:
        assert got.pop() == ("device", inspect.Parameter.POSITIONAL_OR_KEYWORD,
                             None)
    assert got == params(ref)


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m or "fast_tpu")
def test_public_names_are_present(mod):
    ref, got = _mod("fast_tpu", mod), _mod("fast_tpu_torch", mod)
    names = getattr(ref, "__all__", None) or [
        n for n in dir(ref) if not n.startswith("_")
        and getattr(getattr(ref, n), "__module__", "").startswith("fast_tpu")]
    missing = {n for n in names if not hasattr(got, n)
               and not inspect.ismodule(getattr(ref, n))}
    assert missing == set(LEFT_OUT.get(mod, {}))


def test_package_namespace_is_fast_tpus():
    """``fast_tpu_torch.__all__`` is ``fast_tpu.__all__`` with ``interop``,
    and every module of it is an attribute after ``import
    fast_tpu_torch``."""
    assert sorted(fast_tpu_torch.__all__) == sorted(fast_tpu.__all__
                                                    + ["interop"])
    for name in fast_tpu_torch.__all__:
        assert getattr(fast_tpu_torch, name) is not None
        if inspect.ismodule(getattr(fast_tpu, name, None)):
            assert getattr(fast_tpu_torch, name) is importlib.import_module(
                f"fast_tpu_torch.{name}")


def test_no_message_names_a_roadmap_item():
    """The port's messages say what they refuse, not where a plan files
    it."""
    root = pathlib.Path(fast_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "ROADMAP" not in text and "queue 1" not in text, path


def test_compute_phs_temporal_takes_a_generator():
    """``generator`` draws the screen seed, as ``sample_screens`` takes
    one; the default is the run's own trajectory."""
    p = dict(fast_tpu_torch.conf.DEFAULTS, NPXLS=32, DX=0.04, NITER=8,
             NCHUNKS=2, TEMPORAL=True, TEMPORAL_SYNTH="screens",
             LOGLEVEL="WARNING")
    sim = fast_tpu_torch.Fast(p, device="cpu")
    own = sim.compute_phs_temporal(1)
    seed = fast_tpu_torch.ops.rng.draw_seed(
        fast_tpu_torch.ops.rng.make_generator(5))
    got = sim.compute_phs_temporal(1, generator=(
        fast_tpu_torch.ops.rng.make_generator(5)))
    assert got.shape == own.shape == (4, sim.Npxls_pup, sim.Npxls_pup)
    assert not np.array_equal(got, own)
    sim._run_seeds = lambda: (0, seed)
    np.testing.assert_array_equal(sim.compute_phs_temporal(1), got)


def test_fast_has_every_method_of_fast_tpus():
    ref = {n for n in dir(fast_tpu.Fast) if not n.startswith("_")}
    got = {n for n in dir(fast_tpu_torch.Fast) if not n.startswith("_")}
    assert ref - got == set()
    assert fast_tpu_torch.Fast.compute_phs is fast_tpu_torch.Fast.sample_screens


def test_fastfsoc_and_modulator_have_every_method_of_fast_tpus():
    for cls in ("FastFSOC", "Modulator"):
        ref = {n for n in dir(getattr(fast_tpu.comms, cls))
               if not n.startswith("_")}
        got = {n for n in dir(getattr(fast_tpu_torch.comms, cls))
               if not n.startswith("_")}
        assert ref - got == set()
    assert issubclass(fast_tpu_torch.FastFSOC, fast_tpu_torch.Fast)


# ---------------------------------------------------------------------------
# values against fast_tpu, float64
# ---------------------------------------------------------------------------


def close(got, ref, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= rel * scale


def grids(per_layer=False, N=32, seed=3):
    """The same frequency grid in both packages: the main grid of an
    N x N screen, or three rotated per-layer grids."""
    df = 2 * np.pi / (N * 0.02)
    ax = np.arange(-N / 2, N / 2) * df
    if not per_layer:
        return jg.SpatialFrequencyStruct(ax), tg.SpatialFrequencyStruct(ax)
    rng = np.random.default_rng(seed)
    fx = ax[None] * rng.uniform(0.5, 1.5, (3, 1))
    fy = np.tile(ax, (3, 1))
    rot = rng.uniform(0, 2 * np.pi, 3)
    return (jg.SpatialFrequencyStruct(fx, fy, rot=rot, freq_per_layer=True),
            tg.SpatialFrequencyStruct(fx, fy, rot=rot, freq_per_layer=True))


CN2 = np.array([3e-14, 1e-14, 4e-15])
H = np.array([0.0, 5000.0, 10000.0])


@pytest.mark.parametrize("per_layer,cn2", [(False, 2e-14), (False, CN2),
                                           (True, CN2)],
                         ids=["scalar", "layers", "per-layer grid"])
def test_von_karman_takes_the_frequency_struct(per_layer, cn2):
    from fast_tpu.models import atmosphere as ja
    from fast_tpu_torch.models import atmosphere as ta
    jf, tf = grids(per_layer)
    close(ta.turb_powerspectrum_vonKarman(tf, cn2, L0=20.0, l0=0.005),
          ja.turb_powerspectrum_vonKarman(jf, cn2, L0=20.0, l0=0.005))


@pytest.mark.parametrize("case", ["array", "none", "sampler", "path"])
def test_logamp_powerspec_arguments(case):
    from fast_tpu.models import scintillation as js
    from fast_tpu_torch.models import scintillation as ts
    rng = np.random.default_rng(4)
    jf, tf = grids(per_layer=case == "sampler")
    kw = dict(L0=25.0, l0=0.01)
    if case == "array":
        pf = rng.random((32, 32))
        jp, tp = pf, torch.from_numpy(pf)
    elif case == "sampler":
        ax = np.linspace(-400.0, 400.0, 41)
        pf = rng.random((41, 41))
        jp, tp = (js.PupilFilterSampler(pf, ax, ax),
                  ts.PupilFilterSampler(pf, ax, ax))
    else:
        jp = tp = None
    if case == "path":  # Simpson over uniform heights
        kw["layer"] = False
    close(ts.logamp_powerspec(tf, H, CN2, 1550e-9, tp, **kw),
          js.logamp_powerspec(jf, H, CN2, 1550e-9, jp, **kw))


@pytest.mark.parametrize("n", [2, 5, 6])
@pytest.mark.parametrize("axis", [0, 1])
def test_integrate_path_layers_or_heights(n, axis):
    from fast_tpu.ops import integrate as ji
    from fast_tpu_torch.ops import integrate as ti
    rng = np.random.default_rng(n)
    x = np.moveaxis(rng.random((n, 7, 3)), 0, axis)
    h = np.linspace(0.0, 12000.0, n)
    for layer in (True, False):
        close(ti.integrate_path(torch.from_numpy(x), h=h, layer=layer,
                                axis=axis),
              ji.integrate_path(jnp.asarray(x), h=h, layer=layer, axis=axis))


def test_mask_lf_gtilt():
    from fast_tpu.models import ao as ja
    from fast_tpu_torch.models import ao as ta
    jf, tf = grids()
    for kw in (dict(modal=True, Zmax=10, D=0.8, Gtilt=True),
               dict(modal=True, Zmax=10, D=0.8),
               dict(modal=True, modal_mult=0.8)):
        close(ta.mask_lf(tf, 0.1, **kw), ja.mask_lf(jf, 0.1, **kw))
    close(ta.piston_gtilt_filter(torch.from_numpy(jf.fabs),
                                 torch.from_numpy(jf.fx),
                                 torch.from_numpy(jf.fy), 0.8, x_max=60.0),
          ja.piston_gtilt_filter(jf.fabs, jf.fx, jf.fy, 0.8, x_max=60.0))


@pytest.mark.parametrize("kw", [dict(gamma=[0.5, 1.0, 2.0]),
                                dict(plusminus=True), dict(x_max=80.0),
                                dict(n_noll_start=2, plusminus=True,
                                     gamma=0.7)], ids=str)
def test_zernike_squared_filter_arguments(kw):
    from fast_tpu.models import ao as ja
    from fast_tpu_torch.models import ao as ta
    jf, _ = grids()
    t = [torch.from_numpy(a) for a in (jf.fabs, jf.fx, jf.fy)]
    close(ta.zernike_squared_filter(*t, 0.8, 6, **kw),
          ja.zernike_squared_filter(jf.fabs, jf.fx, jf.fy, 0.8, 6, **kw))


def test_jol_alias_openloop_defaults_and_wvl():
    from fast_tpu.models import ao as ja
    from fast_tpu_torch.models import ao as ta
    jf, tf = grids()
    rng = np.random.default_rng(5)
    lf = (rng.random((32, 32)) > 0.3).astype(float)
    v = rng.normal(size=(3, 2)) * 10
    for kw in (dict(), dict(v=v), dict(v=v, Delta_t=0.002, wvl=1550e-9),
               dict(wvl=1e-6, L0=20.0)):
        close(ta.Jol_alias_openloop(tf, 0.1, CN2, torch.from_numpy(lf),
                                    lmax=1, kmax=1, **kw),
              ja.Jol_alias_openloop(jf, 0.1, CN2, lf, lmax=1, kmax=1, **kw))


@pytest.mark.parametrize("mode", ["AO", "LGSAO"])
def test_g_ao_paola_arguments(mode):
    from fast_tpu.models import ao as ja
    from fast_tpu_torch.models import ao as ta
    jf, tf = grids()
    rng = np.random.default_rng(6)
    mask = (rng.random((32, 32)) > 0.3).astype(float)
    v = rng.normal(size=(3, 2)) * 10
    for kw in (dict(v=v, dtheta=(4, 1), Tx=0.8, tl=0.001, Delta_t=0.001),
               dict(dtheta=(2, 0), Tx=0.8, wvl=1550e-9, Zmax=10,
                    Dsubap=0.1, modal=True, modal_mult=0.9, x_max=70.0)):
        close(ta.G_AO_PAOLA(tf, torch.from_numpy(mask), mode, H, **kw),
              ja.G_AO_PAOLA(jf, mask, mode, H, **kw))


def test_besselj_x_max():
    from fast_tpu.ops import bessel as jb
    from fast_tpu_torch.ops import bessel as tb
    x = np.random.default_rng(7).uniform(-30, 30, (5, 9))
    for kw in (dict(x_max=30.0), dict(x_max=90.0), dict(M=200)):
        close(tb.besselj([0, 1, 4], torch.from_numpy(x), **kw),
              jb.besselj([0, 1, 4], x, **kw))


def test_mesh_frequency_axes():
    rng = np.random.default_rng(8)
    fx, fy = rng.random((2, 5)), rng.random((2, 7))
    for rot in (None, rng.random(2)):
        for a, b in zip(tg.mesh_frequency_axes(fx, fy, rot),
                        jg.mesh_frequency_axes(fx, fy, rot)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_make_subharm_modes_dtype(dtype):
    from fast_tpu import synthesis as js
    from fast_tpu_torch import synthesis as ts
    g = tg.SpatialFrequencies(32, 0.02)
    g.make_subharm_freqs()
    got = ts.make_subharm_modes(g.subharm.fx, g.subharm.fy, 32, 0.02,
                                dtype=dtype)
    ref = np.asarray(js.make_subharm_modes(g.subharm.fx, g.subharm.fy, 32,
                                           0.02, dtype=dtype))
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("crop", [None, (9, 23)])
def test_synthesize_subharm_complex_modes_and_crop(monkeypatch, crop):
    """The same weights through both packages: the normal draws of each
    replaced by one numpy draw."""
    import jax
    from fast_tpu import synthesis as js
    from fast_tpu_torch import synthesis as ts
    g = tg.SpatialFrequencies(32, 0.02)
    g.make_subharm_freqs()
    modes = ts.make_subharm_modes(g.subharm.fx, g.subharm.fy, 32, 0.02)
    rng = np.random.default_rng(9)
    sqrt_ps = rng.random((3, 3, 3))
    df = np.asarray(g.subharm.df)
    z = rng.normal(size=(5, 3, 3, 3)) + 1j * rng.normal(size=(5, 3, 3, 3))
    monkeypatch.setattr(js, "complex_normal",
                        lambda key, shape, dtype: jnp.asarray(z, dtype))
    monkeypatch.setattr(ts, "complex_normal",
                        lambda shape, gen, dtype: torch.from_numpy(z))
    ref = js.synthesize_subharm_complex(jax.random.PRNGKey(0), sqrt_ps, df,
                                        jnp.asarray(modes), 5, crop=crop)
    got = ts.synthesize_subharm_complex(
        torch.Generator(), torch.from_numpy(sqrt_ps), torch.from_numpy(df),
        modes, 5, crop=crop)
    close(got, ref)


# ---------------------------------------------------------------------------
# Fast's reference-API methods
# ---------------------------------------------------------------------------


def small_link():
    h, cn2, w = fast_tpu.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu.conf.DEFAULTS)
    p.update({"NPXLS": "auto", "DX": 0.01, "NITER": 16, "NCHUNKS": 1,
              "D_GROUND": 0.8, "WVL": 1550e-9, "ZENITH_ANGLE": 55,
              "DTHETA": [4, 0], "AO_MODE": "AO", "DSUBAP": 0.1,
              "TLOOP": 0.001, "TEXP": 0.001, "ALIAS": True, "H_TURB": h,
              "CN2_TURB": cn2, "WIND_SPD": w,
              "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 1234,
              "LOGLEVEL": "WARNING"})
    return p


def defaults():
    p = dict(fast_tpu.conf.DEFAULTS)
    p.update({"NITER": 16, "NCHUNKS": 1, "LOGLEVEL": "WARNING"})
    return p


_SIMS = {}


def sims(name):
    if name not in _SIMS:
        p = {"small link": small_link, "defaults": defaults}[name]()
        _SIMS[name] = (fast_tpu.Fast(p), fast_tpu_torch.Fast(p, device="cpu"))
    return _SIMS[name]


@pytest.mark.parametrize("onaxis", [True, False])
@pytest.mark.parametrize("name", ["small link", "defaults"])
def test_compute_mean_irradiance_equals_fast_tpus(name, onaxis):
    ref, got = sims(name)
    close(got.compute_mean_irradiance(onaxis=onaxis),
          ref.compute_mean_irradiance(onaxis=onaxis))


def test_sample_screens_shapes_and_variance():
    ref, got = sims("small link")
    assert got.sample_screens(3).shape == ref.sample_screens(3).shape
    gen = torch.Generator().manual_seed(3)
    phs = got.sample_screens(96, generator=gen).astype(np.float64)
    assert phs.shape == (96, got.Npxls_pup, got.Npxls_pup)
    assert got.compute_phs(2, generator=gen).shape == (
        2, got.Npxls_pup, got.Npxls_pup)
    # a pixel of an FFT screen has variance sum(PSD) df^2; per screen the
    # pixel mean of phs^2, then its mean and standard error over screens
    m = (phs ** 2).mean((-2, -1))
    expect = float((got.powerspec * got.freq.main.df ** 2).sum())
    assert abs(m.mean() - expect) <= 5 * m.std(ddof=1) / np.sqrt(m.size)


def test_init_no_ops_and_engine_namespace():
    _, got = sims("small link")
    assert got.init_fftw() is None and got.init_phs_logamp() is None
    from fast_tpu_torch import engine
    assert engine.coherenceTime is engine.coherence_time
    assert engine.isoplanaticAngle is engine.isoplanatic_angle
    assert isinstance(engine.SpatialFrequencyStruct(np.arange(4.0)).fabs,
                      np.ndarray)
    assert isinstance(fast_tpu_torch.ops.ft2, types.FunctionType)
