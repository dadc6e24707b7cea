"""Parameter scans of fast_tpu_torch (``parallel.run_scan_sharded`` on a
(1, 1) mesh) and K6 (``ops/ar_flow.ar_flow_fused_batch``) against
fast_tpu, on the CPU at 64^2 with 2 samples.

* The scan's argument checks raise with the JAX package's messages; a
  (1, 1) mesh is this process's CPU, and (2, 1) and (1, 4) meshes are
  taken by worlds of 2 and 4 spawned ranks (``tests/test_torch_mesh.py``
  runs the scans past one device).
* iid scans ('matmul', 'colfac', 'pallas_fused' through K2's plain
  version, and 'matmul' with SUBHARM) against ``fast_tpu.parallel.
  run_scan_sharded`` on a (1, 1) CPU mesh: per-sample tables equal the JAX
  sims' to float32 round-off (the float64 scalars to 1e-10), per-sample
  mean power within 5 combined standard errors, scintillation index within
  25% (one standard error of the index is 7-11% at 2048 realizations).
* Temporal scans, AR and screens, against the JAX scan in distribution:
  per sample, mean power within 5 combined standard errors over scans
  from 3 seeds in each package, lag-1 autocorrelations within 0.3; the
  scan's kernel route (the plain K6 here) equals its SYNTH='fft' route to
  2e-3 from one seed; a scan of one sim gives that sim's ``run()`` bit for
  bit.
* K6's plain version against ``pallas_synth.ar_flow_fused_batch`` in the
  Pallas interpreter with zero bits (``precision="highest"``), with the
  tolerances of K4's test (couplings 2e-4 of the largest |sum|, state
  2e-6); series 0 of the plain K6 equals the plain K4 from one seed, bit
  for bit in the state; K4's and K6's plain versions at a 144 px pupil
  against a float64 numpy evaluation (1e-3 of the largest |sum|); the
  plain K6 from the series offset k (``series0``) gives series k .. of a
  larger batch bit for bit.
* The engine's AR route at a 130 px pupil agrees with ``fast_tpu.Fast``.
* ``run(progress=True)`` gives ``run()``'s numbers bit for bit.
* On the card: K6 against its plain version from identical Philox bits
  (state bit for bit, couplings within KERNEL_REL of the largest |sum|) at
  64^2, at a 144 px pupil on a 192^2 grid and at a 402 px pupil on a
  1024^2 grid; K6 with one series equals K4; K6 from a series offset
  equals those series of the whole batch; a scan launches K6 and no K4 or
  K5; a scan mesh on the card refuses sims on the CPU.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_scan.py -m cuda
"""

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch import orbit, parallel, sweep
from fast_tpu_torch import synthesis as ts
from fast_tpu_torch.ops import ar_flow as af
from fast_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

KERNEL_REL = 4e-6
SEED = 0xABCDEF0123
NITER = 2048
CPU = ["cpu"]


def params(**overrides):
    """The flagship link at NPXLS=64, DX=0.02 (a 42 px pupil)."""
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": NITER, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 21, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


AR = dict(TEMPORAL=True, TEMPORAL_SYNTH="ar", NITER=120, NCHUNKS=4,
          TEMPORAL_ALPHA=0.98, DT=0.001)
SCREENS = dict(TEMPORAL=True, TEMPORAL_SYNTH="screens", NPXLS=128,
               NITER=120, NCHUNKS=4, DT=0.001)
ZENITHS = np.array([30.0, 60.0])
SEEDS = (4, 5, 6)  # the temporal scans' replicates


def geometry(n=2):
    provider = orbit.circular_orbit_provider(550e3, offset_angle_deg=5.0)
    return orbit.sample_pass_geometry(provider, np.linspace(-90, 90, n),
                                      0.001)


def port_orbit(device="cpu", **overrides):
    d = orbit.FAST_sat_orbit_from_geometry(params(**overrides), geometry(),
                                           device=device)
    return [d[f"simulation_{i}"] for i in range(2)]


def rel(r, s):
    return np.asarray(r.power, np.float64) / s.diffraction_limit


def agree(r, ref, si_rel=0.25):
    """Mean within 5 combined standard errors, scintillation index within
    ``si_rel``."""
    assert r.shape == ref.shape and np.isfinite(r).all()
    se = np.hypot(r.std() / np.sqrt(r.size), ref.std() / np.sqrt(ref.size))
    assert abs(r.mean() - ref.mean()) <= 5 * se
    si, si_ref = r.var() / r.mean() ** 2, ref.var() / ref.mean() ** 2
    assert abs(si - si_ref) <= si_rel * si_ref


def lag1(x):
    x = x / x.mean() - 1
    return (x[:-1] * x[1:]).mean() / (x * x).mean()


def in_distribution(r, ref, mean=True):
    assert r.shape == ref.shape and np.isfinite(r).all() and (r >= 0).all()
    assert not mean or abs(np.log(ref.mean() / r.mean())) < 0.5
    assert abs(lag1(ref) - lag1(r)) < 0.3
    assert lag1(r) > 0.5


def means_agree(runs, refs):
    """Per-sample mean power of R scans from R seeds in each package
    ((R, samples) series means): within 5 combined standard errors, each
    from the spread of its R means. A 120-step series is too short to
    estimate its own autocorrelation time: the frozen-flow screens repeat
    for longer than that, and their means spread over 2x between seeds."""
    m, m_ref = np.asarray(runs), np.asarray(refs)
    se = np.hypot(m.std(0, ddof=1) / np.sqrt(len(m)),
                  m_ref.std(0, ddof=1) / np.sqrt(len(m_ref)))
    assert (np.abs(m.mean(0) - m_ref.mean(0)) <= 5 * se).all(), (m, m_ref)


# --------------------------------------------------------------------------
# the mesh and the argument checks
# --------------------------------------------------------------------------


def test_mesh_is_one_device():
    """A (1, 1) mesh is this process's device; a (2, 1) and a (1, 4) mesh
    are taken by worlds of 2 and 4 ranks, rank r at ``divmod(r, n_mc)``."""
    with parallel.make_scan_mesh(1, 1, CPU) as mesh:
        assert mesh.devices.shape == (1, 1)
        assert mesh.devices[0, 0] == torch.device("cpu")
    for shape in ((2, 1), (1, 4)):
        n = shape[0] * shape[1]
        views = dryrun.spawn(dryrun.mesh_summary, n, shape, timeout=120)
        for r, v in enumerate(views):
            assert v["axis_names"] == ("scan", "mc")
            assert v["shape"] == shape and v["devices"] == ["cpu"] * n
            assert v["backend"] == "gloo"
            assert v["index"] == dict(zip(("scan", "mc"),
                                          divmod(r, shape[1])))


@pytest.mark.parametrize("case,match", [
    ("niter", "sims must share grid geometry and NITER"),
    ("synth", "sims must share SYNTH and SUBHARM settings"),
    ("pallas", "the screens-out 'pallas' kernel is not scan-shardable"),
    ("ar_boiling", r"sims must agree on boiling \(alpha < 1\)"),
    ("ar_mixed", "sims must all use TEMPORAL_SYNTH='ar'"),
    ("screens_chunks", "sims must share grid geometry, NITER and NCHUNKS"),
    ("device", "the mesh's device is cpu, a sim runs on cuda"),
])
def test_argument_checks(case, match):
    """The JAX scan's checks and messages (``fast_tpu/parallel/scan.py``),
    and the mesh's device (a sim made on the card, against a mesh on the
    CPU: a mesh on a card needs one)."""
    def sim(**o):
        return fast_tpu_torch.Fast(params(**{"NITER": 8, **o}),
                                   device="cpu")

    exc = NotImplementedError if case == "pallas" else ValueError
    sims = {
        "niter": lambda: [sim(), sim(NITER=16)],
        "synth": lambda: [sim(SYNTH="matmul"), sim(SYNTH="colfac")],
        "pallas": lambda: [sim(SYNTH="pallas")],
        "ar_boiling": lambda: [sim(**dict(AR, NITER=8)),
                               sim(**dict(AR, NITER=8, TEMPORAL_ALPHA=1.0))],
        "ar_mixed": lambda: [sim(**dict(AR, NITER=8)),
                             sim(**dict(AR, NITER=8,
                                        TEMPORAL_SYNTH="screens"))],
        "screens_chunks": lambda: [
            sim(**dict(SCREENS, NPXLS=64, NITER=8, NCHUNKS=2)),
            sim(**dict(SCREENS, NPXLS=64, NITER=8, NCHUNKS=1))],
        "device": lambda: [sim()],
    }[case]()
    if case == "device":
        sims[0].device = torch.device("cuda")
    with parallel.make_scan_mesh(1, 1, CPU) as mesh:
        with pytest.raises(exc, match=match):
            parallel.run_scan_sharded(sims, mesh)


# --------------------------------------------------------------------------
# iid scans against the JAX scan
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_iid():
    """The JAX sweeps ('matmul', with and without SUBHARM) and their scans
    on a (1, 1) CPU mesh."""
    import fast_tpu
    from fast_tpu import parallel as jpar
    from fast_tpu import sweep as jsweep
    out = {}
    for sh in (False, True):
        sims = jsweep.build_sweep(params(SYNTH="matmul", SUBHARM=sh),
                                  {"ZENITH_ANGLE": ZENITHS})
        res = jpar.run_scan_sharded(sims, jpar.make_scan_mesh(1, 1), seed=5)
        out[sh] = (sims, [rel(r, s) for r, s in zip(res, sims)])
    assert fast_tpu.Fast is not None
    return out


@pytest.mark.parametrize("synth,sh", [("matmul", False), ("colfac", False),
                                      ("pallas_fused", False),
                                      ("matmul", True)],
                         ids=["matmul", "colfac", "pallas_fused", "subharm"])
def test_iid_scan_matches_jax(jax_iid, synth, sh):
    jsims, jrel = jax_iid[sh]
    sims = sweep.build_sweep(params(SYNTH=synth, SUBHARM=sh),
                             {"ZENITH_ANGLE": ZENITHS}, device="cpu")
    before = fast_tpu_torch.ops.synth_detect.synth_detect.LAUNCHES
    res = parallel.run_scan_sharded(sims, parallel.make_scan_mesh(1, 1, CPU),
                                    seed=5)
    assert fast_tpu_torch.ops.synth_detect.synth_detect.LAUNCHES == before
    for s, js, r, jr in zip(sims, jsims, res, jrel):
        assert s.result is r and s._synth == synth
        T = s.tables
        np.testing.assert_allclose(T["sqrt_psd"].numpy(), js._sqrt_psd,
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(T["pm"].numpy(), js._pm, rtol=1e-6)
        for k, v in (("norm", js._norm), ("logamp_var", js.logamp_var),
                     ("diffraction_limit", js.diffraction_limit)):
            assert abs(float(T[k]) - v) <= 1e-10 * abs(v), k
        if sh:
            np.testing.assert_allclose(T["sqrt_psd_sh"].numpy(),
                                       js._sqrt_psd_sh, rtol=1e-6)
        agree(rel(r, s), jr)
    # the samples differ: zenith 30 degrees fades less than 60
    assert res[0].scintillation_index < res[1].scintillation_index


def test_scan_of_one_sim_is_its_run():
    for o in (dict(NITER=256), dict(AR, NITER=40),
              dict(AR, NITER=40, SYNTH="fft"),
              dict(SCREENS, NITER=40)):
        s = fast_tpu_torch.Fast(params(**o), device="cpu")
        ref = np.asarray(s.run().power)
        with parallel.make_scan_mesh(1, 1, CPU) as mesh:
            got = parallel.run_scan_sharded([s], mesh)[0]
        np.testing.assert_array_equal(np.asarray(got.power), ref)


@pytest.mark.parametrize("temporal", [False, True], ids=["iid", "ar"])
def test_progress_run_equals_run(temporal, capsys):
    o = dict(AR, NITER=40) if temporal else dict(NITER=512)
    s = fast_tpu_torch.Fast(params(**o), device="cpu")
    ref = np.asarray(s.run().power)
    np.testing.assert_array_equal(np.asarray(s.run(progress=True).power),
                                  ref)
    err = capsys.readouterr().err
    assert f"chunk {s.Nchunks}/{s.Nchunks}" in err


# --------------------------------------------------------------------------
# temporal scans against the JAX scan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["ar", "screens"])
def test_temporal_scan_matches_jax(mode):
    from fast_tpu import orbit as jorbit
    from fast_tpu import parallel as jpar
    o = AR if mode == "ar" else SCREENS
    geo = geometry()
    jd = jorbit.FAST_sat_orbit_from_geometry(params(**o), geo)
    jsims = [jd[f"simulation_{i}"] for i in range(2)]
    sims = port_orbit(**o)
    means, jmeans = [], []
    for seed in SEEDS:
        jres = jpar.run_scan_sharded(jsims, jpar.make_scan_mesh(1, 1),
                                     seed=seed)
        res = orbit.run_orbit_sweep(
            {f"simulation_{i}": s for i, s in enumerate(sims)},
            parallel.make_scan_mesh(1, 1, CPU), seed=seed)
        jmeans.append([rel(r, s).mean() for r, s in zip(jres, jsims)])
        means.append([rel(s.result, s).mean() for s in sims])
        if seed != SEEDS[0]:
            continue
        for i, (s, js) in enumerate(zip(sims, jsims)):
            assert res[f"simulation_{i}"] is s.result
            T = s.tables
            np.testing.assert_allclose(T["sqrt_psd_layers"].numpy(),
                                       js._sqrt_psd_layers, rtol=1e-6)
            np.testing.assert_allclose(T["pm"].numpy(), js._pm, rtol=1e-6)
            assert abs(float(T["norm"]) - js._norm) <= 1e-10 * js._norm
            if mode == "ar":
                np.testing.assert_allclose(s._ar_alpha, js._ar_alpha,
                                           rtol=1e-12)
            in_distribution(rel(s.result, s), rel(jres[i], js), mean=False)
    means_agree(means, jmeans)


def test_scan_kernel_route_equals_fft_route():
    """The plain K6 (one call for both series) against the stock-op
    recursion and exact ift2, series by series, from one seed: the same
    noise stream, series 1 on the state rows 4 .. 7."""
    before = af.ar_flow_fused_batch.LAUNCHES
    with parallel.make_scan_mesh(1, 1, CPU) as mesh:
        k = [r.power for r in parallel.run_scan_sharded(port_orbit(**AR),
                                                        mesh, seed=9)]
        f = [r.power for r in parallel.run_scan_sharded(
            port_orbit(**AR, SYNTH="fft"), mesh, seed=9)]
    assert af.ar_flow_fused_batch.LAUNCHES == before
    for rk, rf in zip(k, f):
        np.testing.assert_allclose(np.asarray(rk), np.asarray(rf), rtol=2e-3,
                                   atol=1e-9)
    assert not np.allclose(k[0], k[1])


# --------------------------------------------------------------------------
# K6's plain version
# --------------------------------------------------------------------------


def k6_inputs(B=3, L=2, N=64, lo=20, hi=44, seed=11, boiling=False,
              alpha=0.9):
    """Numpy inputs of B series (``tests/test_pallas.py``'s batch test):
    states of about 0.02 per mode and noise scales of up to 0.01 up to
    128^2 (screens of a few radians), sized to screens of about a radian
    on larger grids (the sums' round-off grows with the phase times
    sqrt(N)); random unit phasors times ``alpha`` if boiling, W and
    per-series pupil * mode."""
    npup = hi - lo
    rng = np.random.default_rng(seed)
    scale, ns_scale = (0.02, 0.01) if N <= 128 else (0.5 / N, 0.07 / N)
    a0 = (scale * (rng.normal(size=(B, L, N, N))
                   + 1j * rng.normal(size=(B, L, N, N)))).astype(np.complex64)
    ph = np.exp(1j * rng.uniform(-3, 3, (B, L, N, N)))
    ph = ((alpha if boiling else 1.0) * ph).astype(np.complex64)
    ns = ((ns_scale * rng.random((B, L, N, N))).astype(np.float32)
          if boiling else None)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pms = rng.random((B, npup, npup)).astype(np.float32)
    return a0, ph, ns, W, pms


def tensors(inputs, device="cpu"):
    return tuple(None if x is None else torch.from_numpy(x).to(device)
                 for x in inputs)


@pytest.mark.parametrize("noise", [None, "uniform", "gauss"])
def test_plain_k6_matches_pallas_interpret(noise):
    import jax.numpy as jnp
    from fast_tpu.ops import pallas_synth
    nsteps = 6
    a0, ph, ns, W, pms = inp = k6_inputs(boiling=noise is not None)
    c_ref, a_ref = pallas_synth.ar_flow_fused_batch(
        1, jnp.asarray(a0), jnp.asarray(ph),
        None if ns is None else jnp.asarray(ns), W, pms, nsteps,
        interpret=True, precision="highest", noise=noise or "uniform")
    c_ref, a_ref = np.asarray(c_ref), np.asarray(a_ref)
    if noise is None:
        c, a = af.ar_flow_fused_batch(1, *tensors(inp), nsteps)
    else:
        c, a = af.ar_flow_batch_reference(1, *tensors(inp), nsteps,
                                          noise=noise, bits="zero")
    assert c.shape == (nsteps, 3, 2) and c.dtype == torch.float32
    assert a.shape == a0.shape and a.dtype == torch.complex64
    assert np.abs(c.numpy() - c_ref).max() <= 2e-4 * np.abs(c_ref).max()
    assert np.abs(a.numpy() - a_ref).max() <= 2e-6


@pytest.mark.parametrize("noise", ["uniform", "gauss"])
def test_plain_k6_series0_is_k4(noise):
    a0, ph, ns, W, pms = t = tensors(k6_inputs(L=3, boiling=True))
    c6, a6 = af.ar_flow_fused_batch(SEED, *t, 7, noise=noise, step0=3)
    c4, a4 = af.ar_flow_fused(SEED, a0[0], ph[0], ns[0], W, pms[0], 7,
                              noise=noise, step0=3)
    assert torch.equal(a6[0], a4)
    np.testing.assert_allclose(c6[:, 0].numpy(), c4.numpy(), rtol=1e-6,
                               atol=1e-6 * float(c4.abs().max()))
    # series 1 draws other bits: its state differs from series 0's process
    c1, a1 = af.ar_flow_fused(SEED, a0[1], ph[1], ns[1], W, pms[1], 7,
                              noise=noise, step0=3)
    assert not torch.equal(a6[1], a1)
    # the counter rows of series 1 are the rows 3 .. 5 of one K4 draw
    b = af.ar_bits(SEED, 3, 2, 6, 64)
    b1 = af.ar_bits(SEED, 3, 2, 3, 64, layer0=3)
    assert torch.equal(b[0][:, 3:], b1[0]) and torch.equal(b[1][:, 3:], b1[1])


@pytest.mark.parametrize("k", [1, 2])
def test_plain_k6_series_offset_is_series_k_of_a_batch(k):
    """The plain K6 on series k .. of a batch with ``series0=k`` draws their
    rows of the Philox counter: states and sums equal the whole batch's
    for those series, bit for bit (what a scan rank holding them runs)."""
    t = tensors(k6_inputs(B=4, L=3, boiling=True))
    c, a = af.ar_flow_fused_batch(SEED, *t, 7, step0=3)
    part = [x if x is None or x.ndim == 2 else x[k:] for x in t]
    ck, ak = af.ar_flow_fused_batch(SEED, *part, 7, step0=3, series0=k)
    assert torch.equal(ak, a[k:]) and torch.equal(ck, c[:, k:])
    c0, _ = af.ar_flow_fused_batch(SEED, *part, 7, step0=3)
    assert not torch.equal(c0, c[:, k:])


def definition_numpy(a0, ph, ns, W, pm, nsteps, z):
    """One series from its definition in float64 numpy; ``z`` (nsteps, L,
    N, N) complex noise."""
    a = a0.astype(np.complex128)
    W = W.astype(np.complex128)
    out = np.zeros((nsteps, 2))
    for t in range(nsteps):
        a = ph.astype(np.complex128) * a + z[t] * ns
        phi = (W @ a.sum(0) @ W.T).real
        out[t] = (pm * np.cos(phi)).sum(), (pm * np.sin(phi)).sum()
    return out, a


def test_plain_at_a_144px_pupil_against_numpy():
    """K4's and K6's plain versions with a pupil of 144 px (one W slice of
    144 px on the card) on a 160^2 grid, against float64 numpy on the same
    uniform Philox noise."""
    nsteps, L, N = 4, 2, 160
    inp = k6_inputs(B=2, L=L, N=N, lo=8, hi=152, seed=4, boiling=True)
    c6, a6 = af.ar_flow_fused_batch(SEED, *tensors(inp), nsteps)
    s3 = np.sqrt(3.0)
    b1, b2 = (b.numpy().reshape(nsteps, 2, L, N, N) >> 8
              for b in af.ar_bits(SEED, 0, nsteps, 2 * L, N))
    z = ((b1 * (s3 * 2.0 ** -23) - s3) + 1j * (b2 * (s3 * 2.0 ** -23) - s3))
    a0, ph, ns, W, pms = inp
    for s in range(2):
        ref, a_ref = definition_numpy(a0[s], ph[s], ns[s], W, pms[s], nsteps,
                                      z[:, s])
        assert np.abs(c6[:, s].numpy() - ref).max() <= 1e-3 * np.abs(
            ref).max()
        assert np.abs(a6[s].numpy() - a_ref).max() <= 1e-6
    c4, a4 = af.ar_flow_fused(SEED, *(torch.from_numpy(x[0]) for x in
                                      (a0, ph, ns)),
                              torch.from_numpy(W), torch.from_numpy(pms[0]),
                              nsteps)
    assert torch.equal(a4, a6[0])


def test_engine_ar_route_at_a_130px_pupil_matches_jax():
    """A 1.28 m telescope at DX = 0.01 m: a 130 px pupil on a 144^2 grid
    through the AR route (the plain K4 here, K4 on the card) against
    ``fast_tpu.Fast``."""
    import fast_tpu
    o = dict(AR, NPXLS=144, DX=0.01, D_GROUND=1.28, DSUBAP=0.16, NITER=64,
             NCHUNKS=2)
    js = fast_tpu.Fast(params(**o))
    js.run()
    s = fast_tpu_torch.Fast(params(**o), device="cpu")
    assert s.Npxls_pup == js.Npxls_pup == 130 and s._ar_route == "kernel"
    s.run()
    in_distribution(rel(s.result, s), rel(js.result, js))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


# (B, L, N, lo, hi, steps, max_steps): two launches with the states
# carried; more layers than one thread holds (layer blocks); a 144 px pupil
# (one W slice); the 4 m link's 402 px pupil (two slices of 208 px)
K6_CASES = [(3, 3, 64, 20, 44, 300, 256), (2, 10, 64, 20, 44, 40, 4096),
            (2, 2, 192, 24, 168, 40, 4096), (2, 2, 1024, 311, 713, 6, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", K6_CASES,
                         ids=lambda c: f"B{c[0]}L{c[1]}N{c[2]}P{c[4] - c[3]}")
@pytest.mark.parametrize("noise", [None, "uniform", "gauss"])
def test_k6_matches_plain_on_card(cuda_device, noise, case):
    B, L, N, lo, hi, nsteps, max_steps = case
    t = tensors(k6_inputs(B=B, L=L, N=N, lo=lo, hi=hi, seed=9,
                          boiling=noise is not None, alpha=0.99), cuda_device)
    kw = {"noise": noise or "uniform", "step0": 7}
    before = af.ar_flow_fused_batch.LAUNCHES
    c, a = af.ar_flow_fused_batch(SEED, *t, nsteps, max_steps=max_steps,
                                  **kw)
    c_ref, a_ref = af.ar_flow_batch_reference(SEED, *t, nsteps, **kw)
    torch.cuda.synchronize()
    assert af.ar_flow_fused_batch.LAUNCHES == before + -(-nsteps // max_steps)
    assert c.shape == (nsteps, B, 2) and bool(torch.isfinite(c).all())
    assert torch.equal(a, a_ref)
    err = float((c - c_ref).abs().max())
    assert err <= KERNEL_REL * float(c_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("N,lo,hi", [(64, 20, 44), (192, 24, 168)])
def test_k6_with_one_series_is_k4_on_card(cuda_device, N, lo, hi):
    a0, ph, ns, W, pms = tensors(k6_inputs(B=1, L=4, N=N, lo=lo, hi=hi,
                                           boiling=True), cuda_device)
    c6, a6 = af.ar_flow_fused_batch(SEED, a0, ph, ns, W, pms, 70)
    c4, a4 = af.ar_flow_fused(SEED, a0[0], ph[0], ns[0], W, pms[0], 70)
    assert torch.equal(c6[:, 0], c4) and torch.equal(a6[0], a4)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_k6_series_offset_on_card(cuda_device, k):
    """K6 from the series offset k equals series k .. of the batch's one
    call, states bit for bit, sums too (the same passes on the same
    data), and its plain version from the same offset."""
    t = tensors(k6_inputs(B=4, L=3, N=64, seed=9, boiling=True,
                          alpha=0.99), cuda_device)
    c, a = af.ar_flow_fused_batch(SEED, *t, 70, step0=5)
    part = [x if x is None or x.ndim == 2 else x[k:] for x in t]
    ck, ak = af.ar_flow_fused_batch(SEED, *part, 70, step0=5, series0=k)
    cr, ar = af.ar_flow_batch_reference(SEED, *part, 70, step0=5, series0=k)
    torch.cuda.synchronize()
    assert torch.equal(ak, a[k:]) and torch.equal(ck, c[:, k:])
    assert torch.equal(ak, ar)
    assert float((ck - cr).abs().max()) <= KERNEL_REL * float(
        cr.abs().max())


@pytest.mark.cuda
def test_scan_launches_k6_on_card(cuda_device):
    """A temporal orbit scan on the card: one K6 launch, no K4 or K5, and
    the SYNTH='fft' route's series from one seed; an iid sweep scan
    launches K2."""
    from fast_tpu_torch.ops import synth_detect as sd
    K4, K5, K6 = af.ar_flow_fused, af.ar_flow_streamed, af.ar_flow_fused_batch
    K4.LAUNCHES = K5.LAUNCHES = K6.LAUNCHES = 0
    with parallel.make_scan_mesh(1, 1, [cuda_device]) as mesh:
        k = parallel.run_scan_sharded(port_orbit(cuda_device, **AR), mesh,
                                      seed=9)
        assert (K6.LAUNCHES, K4.LAUNCHES, K5.LAUNCHES) == (1, 0, 0)
        f = parallel.run_scan_sharded(port_orbit(cuda_device, **AR,
                                                 SYNTH="fft"), mesh, seed=9)
        for rk, rf in zip(k, f):
            np.testing.assert_allclose(np.asarray(rk.power),
                                       np.asarray(rf.power), rtol=2e-3,
                                       atol=1e-9)
        sd.synth_detect.LAUNCHES = 0
        sims = sweep.build_sweep(params(), {"ZENITH_ANGLE": ZENITHS},
                                 device=cuda_device)
        assert sims[0]._synth == "pallas_fused"
        res = parallel.run_scan_sharded(sims, mesh)
        assert sd.synth_detect.LAUNCHES == 2 * sims[0].Nchunks
        assert all(np.isfinite(np.asarray(r.power)).all() for r in res)
        with pytest.raises(ValueError, match="the mesh's device is cuda"):
            parallel.run_scan_sharded(port_orbit(**AR), mesh)
