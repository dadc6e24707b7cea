"""K7 (screens out) of fast_tpu_torch against fast_tpu: the plain version
against the TPU kernel in the Pallas interpreter and against numpy, K7's
screens against K2's couplings, SYNTH='pallas' runs, and the CUDA kernel
against its plain version where a card is present.

* The interpreter's PRNG yields zero bits, so the plain version is fed
  zero bits too: screens within 1e-3 of max |phi| of
  ``pallas_synth.fused_synthesis(..., interpret=True)`` (float32 products
  in another order). Zero bits give every grid point the same noise, so
  random bits are also checked against float64 numpy (1e-3 of max |phi|).
* K7 draws K2's 'gauss' noise: from one seed, the stock-op detector on
  K7's screens gives K2's couplings (1e-3 of the sums on the CPU, where
  both plain versions form the same screens).
* ``Fast(SYNTH='pallas', device='cpu').run()`` agrees with
  ``fast_tpu.Fast(SYNTH='matmul')`` in distribution: mean within 5
  combined standard errors, scintillation index within 20%.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_screens.py -m cuda
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch import synthesis as ts
from fast_tpu_torch.ops import synth_detect as sd

torch.set_num_threads(1)

NITER = 2048
SCREEN_REL = 1e-3   # of max |phi|, plain version against another evaluation



def kernel_rel(N):
    """Limit of kernel against plain version on the card, of max |phi|: a
    screen value is a sum of N products per DFT side, each rounded to 2^-24
    relative and accumulated in another order by the kernel than by the
    plain version; 2N 2^-24 bounds that to first order, and TF32 products
    (2^-11 each) land outside it."""
    return 2 * N * 2.0 ** -24


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
        "SEED": 41, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def k7_inputs(N=64, lo=20, hi=44, seed=5, phase_rms=2.0):
    """K7's inputs from a seed, the PSD scaled so that the screens have
    about ``phase_rms`` rad rms; ``wr``, ``wi`` and ``pm_t`` padded as the
    kernels take them."""
    npup = hi - lo
    rng = np.random.default_rng(seed)
    sqrt_ps = (rng.random((N, N)) + 0.2).astype(np.float32)
    df = phase_rms / float(np.sqrt((sqrt_ps.astype(np.float64) ** 2).sum()))
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((npup, npup)).astype(np.float32)
    wr, wi, pm_t = sd.pad_pupil(
        torch.from_numpy(np.ascontiguousarray(W.real)),
        torch.from_numpy(np.ascontiguousarray(W.imag)),
        torch.from_numpy(np.ascontiguousarray(pm.T)))
    t = dict(
        s_t=torch.from_numpy(np.ascontiguousarray(sqrt_ps.T * np.float32(df))),
        wr=wr, wi=wi, pm_t=pm_t, pm=torch.from_numpy(pm), npup=npup)
    return (sqrt_ps, df, W, pm), t


def screens_numpy(bits, sqrt_ps, df, W):
    """K7's function in float64 numpy: Box-Muller noise on the transposed
    grid coloured by ``sqrt(PSD) df``, ``W X W^T``, real parts first."""
    b1, b2 = (np.asarray(b, np.int64) >> 8 for b in bits)
    r = np.sqrt(-2 * np.log(b1 * 2.0 ** -24 + 2.0 ** -25))
    z = r * np.exp(2j * np.pi * (b2 * 2.0 ** -24))
    X = np.swapaxes(z, 1, 2) * (sqrt_ps.astype(np.float64) * df)
    W = W.astype(np.complex128)
    scr = W @ X @ W.T
    return np.concatenate([scr.real, scr.imag])


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------


def test_plain_matches_pallas_interpret_zero_bits():
    from fast_tpu.ops import pallas_synth
    (sqrt_ps, df, W, _), t = k7_inputs()
    nbatch = 3
    ref = np.asarray(pallas_synth.fused_synthesis(
        1, sqrt_ps, df, nbatch, W, interpret=True, precision="highest"))
    zero = torch.zeros((nbatch, 64, 64), dtype=torch.int64)
    got = sd.synth_screens_reference(0, t["s_t"], t["wr"], t["wi"], nbatch,
                                     npup=t["npup"], bits=(zero, zero))
    assert got.shape == ref.shape == (2 * nbatch, 24, 24)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert np.abs(got.numpy() - ref).max() <= SCREEN_REL * np.abs(ref).max()


# a 24 px pupil, and 144 px on a 160^2 grid (tiled on the card)
@pytest.mark.parametrize("shape", [(64, 20, 44), (160, 8, 152)])
def test_plain_matches_numpy_on_random_bits(shape):
    N, lo, hi = shape
    (sqrt_ps, df, W, _), t = k7_inputs(N, lo, hi)
    nbatch = 3
    rng = np.random.default_rng(2)
    bits = [torch.from_numpy(rng.integers(0, 2 ** 32, (nbatch, N, N)))
            for _ in range(2)]
    got = sd.synth_screens_reference(0, t["s_t"], t["wr"], t["wi"], nbatch,
                                     npup=hi - lo, bits=bits)
    ref = screens_numpy(bits, sqrt_ps, df, W)
    assert got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= SCREEN_REL * np.abs(ref).max()
    assert 1.0 < got.std() < 3.0  # screens of ~2 rad rms, as asked


@pytest.mark.parametrize("shape", [(64, 20, 44), (160, 8, 152)])
def test_detector_on_k7_screens_gives_k2_gauss_couplings(shape):
    """From one seed, stream and draw index K7 writes the screens that K2
    with Box-Muller noise detects."""
    _, t = k7_inputs(*shape)
    nbatch = 5
    scr = sd.synth_screens(0xFEED, t["s_t"], t["wr"], t["wi"], nbatch,
                           npup=t["npup"], stream=3)
    c7 = ts.detector_coupling(scr, t["pm"], 1.0, 1.0)
    c2 = sd.synth_detect(0xFEED, t["s_t"], t["wr"], t["wi"], t["pm_t"],
                         nbatch, mix=None, stream=3)
    c2 = torch.complex(c2[:, 0], c2[:, 1])
    assert c7.shape == c2.shape == (2 * nbatch,)
    assert float((c7 - c2).abs().max()) <= 1e-3 * float(c2.abs().max())
    # and not those of another stream of the seed
    c2b = sd.synth_detect(0xFEED, t["s_t"], t["wr"], t["wi"], t["pm_t"],
                          nbatch, mix=None, stream=4)
    assert float((c7 - torch.complex(c2b[:, 0], c2b[:, 1])).abs().max()) > 1.0


def test_screens_are_cropped_not_padded():
    """The padded rows of W give no screen pixels: the crop to ``npup``
    equals the screens of the unpadded tables."""
    (_, _, W, _), t = k7_inputs()
    wr = torch.from_numpy(np.ascontiguousarray(W.real))
    wi = torch.from_numpy(np.ascontiguousarray(W.imag))
    a = sd.synth_screens_reference(5, t["s_t"], t["wr"], t["wi"], 2, npup=24)
    b = sd.synth_screens_reference(5, t["s_t"], wr, wi, 2)
    full = sd.synth_screens_reference(5, t["s_t"], t["wr"], t["wi"], 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert full.shape == (4, 32, 32)
    torch.testing.assert_close(full[:, :24, :24], a, rtol=0, atol=0)
    assert float(full[:, 24:].abs().max()) == 0.0


def test_plain_draw_offset_continues_the_stream(monkeypatch):
    _, t = k7_inputs()
    args = (0x77, t["s_t"], t["wr"], t["wi"])
    full = sd.synth_screens_reference(*args, 6, npup=24, stream=1)
    head = sd.synth_screens_reference(*args, 4, npup=24, stream=1)
    tail = sd.synth_screens_reference(*args, 2, npup=24, stream=1, draw0=4)
    torch.testing.assert_close(full[:6], torch.cat([head[:4], tail[:2]]),
                               rtol=0, atol=0)
    torch.testing.assert_close(full[6:], torch.cat([head[4:], tail[2:]]),
                               rtol=0, atol=0)
    monkeypatch.setattr(sd, "_REF_POINTS", 2 * 64 * 64)
    torch.testing.assert_close(
        sd.synth_screens_reference(*args, 6, npup=24, stream=1), full,
        rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu():
    _, t = k7_inputs()
    args = (11, t["s_t"], t["wr"], t["wi"], 3)
    got = sd.synth_screens(*args, npup=24, stream=2)
    ref = sd.synth_screens_reference(*args, npup=24, stream=2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert sd.synth_screens.LAUNCHES == 0
    assert torch.isfinite(got).all()


def test_wrapper_checks_inputs():
    _, t = k7_inputs()
    with pytest.raises(ValueError, match="wr"):
        sd.synth_screens(1, t["s_t"], t["wr"][:, :32], t["wi"], 2)
    with pytest.raises(TypeError, match="float32"):
        sd.synth_screens(1, t["s_t"].double(), t["wr"], t["wi"], 2)
    with pytest.raises(ValueError, match="npup"):
        sd.synth_screens(1, t["s_t"], t["wr"], t["wi"], 2, npup=33)
    with pytest.raises(ValueError, match="seed"):
        sd.synth_screens(-1, t["s_t"], t["wr"], t["wi"], 2)
    with pytest.raises(ValueError, match="nbatch"):
        sd.synth_screens(1, t["s_t"], t["wr"], t["wi"], 0)


# --------------------------------------------------------------------------
# SYNTH='pallas' runs
# --------------------------------------------------------------------------


def in_distribution(r, ref, si_rel=0.2):
    r, ref = np.asarray(r, np.float64), np.asarray(ref, np.float64)
    assert r.shape == ref.shape and np.isfinite(r).all()
    se = np.hypot(r.std(), ref.std()) / np.sqrt(r.size)
    assert abs(r.mean() - ref.mean()) <= 5 * se
    si, si_ref = r.var() / r.mean() ** 2, ref.var() / ref.mean() ** 2
    assert abs(si - si_ref) <= si_rel * si_ref


@pytest.fixture(scope="module")
def jax_matmul():
    import fast_tpu
    out = {}
    for subharm in (False, True):
        sim = fast_tpu.Fast(small_params(SYNTH="matmul", SEED=42,
                                         SUBHARM=subharm))
        out[subharm] = sim.run().power / sim.diffraction_limit
    return out


@pytest.mark.parametrize("subharm", [False, True])
def test_pallas_run_in_distribution(jax_matmul, monkeypatch, subharm):
    import fast_tpu_torch
    from fast_tpu_torch import engine
    calls = []

    def spy(*args, **kw):
        calls.append(args[4])
        return sd.synth_screens(*args, **kw)

    monkeypatch.setattr(engine, "synth_screens", spy)
    sim = fast_tpu_torch.Fast(small_params(SYNTH="pallas", SUBHARM=subharm),
                              device="cpu")
    assert sim._synth == "pallas"
    res = sim.run()
    assert calls == [NITER // 4] * 2  # one call per chunk
    assert sd.synth_screens.LAUNCHES == 0  # CPU: plain version only
    in_distribution(res.power / res._dl, jax_matmul[subharm])


def test_pallas_run_draws_box_muller_whatever_mc_noise_says():
    """``_synth_kernel`` has no 'mixed' mode: SYNTH='pallas' gives the same
    series under both settings of MC_NOISE, and it is K2's 'gauss' series
    of that seed up to the detector's rounding."""
    import fast_tpu_torch
    kw = dict(NITER=256, SEED=7)
    a, b, c = (fast_tpu_torch.Fast(small_params(**kw, **o), device="cpu")
               .run().power
               for o in ({"SYNTH": "pallas", "MC_NOISE": "mixed"},
                         {"SYNTH": "pallas", "MC_NOISE": "gauss"},
                         {"SYNTH": "pallas_fused", "MC_NOISE": "gauss"}))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, c, rtol=1e-3)


def test_pallas_float64_run_detects_float32_screens():
    import fast_tpu_torch
    sim = fast_tpu_torch.Fast(small_params(SYNTH="pallas", DTYPE="float64",
                                           NITER=64), device="cpu")
    assert sim._synth == "pallas"
    power = sim.run().power
    assert power.shape == (64,) and np.isfinite(power).all()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


# (N, lo, hi, draws): one tile, 4100 draws in two launches; a grid side
# that is no multiple of 64 with its pupil as wide as the grid; 144 px on
# 160^2 (two tiles an axis, the second ragged); a 402 px pupil's tiling
KERNEL_CASES = [(64, 20, 44, 4100), (102, 0, 102, 64), (160, 8, 152, 130),
                (416, 7, 409, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"N{c[0]}x{c[3]}")
def test_kernel_matches_plain_on_card(cuda_device, case):
    N, lo, hi, nbatch = case
    t = {k: v.to(cuda_device) if torch.is_tensor(v) else v
         for k, v in k7_inputs(N, lo, hi, phase_rms=1.5)[1].items()}
    args = (0xABCDEF0123, t["s_t"], t["wr"], t["wi"], nbatch)
    before = sd.synth_screens.LAUNCHES
    got = sd.synth_screens(*args, npup=hi - lo, stream=4)
    ref = sd.synth_screens_reference(*args, npup=hi - lo, stream=4)
    torch.cuda.synchronize()
    per = sd.draws_per_launch(N, t["wr"].shape[0])
    assert sd.synth_screens.LAUNCHES == before + -(-nbatch // per)
    assert got.shape == ref.shape == (2 * nbatch, hi - lo, hi - lo)
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= kernel_rel(N) * float(ref.abs().max())
    # the stock-op detector on the kernel's screens gives K2's couplings
    c7 = ts.detector_coupling(got, t["pm"], 1.0, 1.0)
    c2 = sd.synth_detect(args[0], t["s_t"], t["wr"], t["wi"], t["pm_t"],
                         nbatch, mix=None, stream=4)
    c2 = torch.complex(c2[:, 0], c2[:, 1])
    assert float((c7 - c2).abs().max()) <= 1e-5 * float(c2.abs().max())
