"""The colfac path of fast_tpu_torch against fast_tpu: the column-factor
build, K1's plain version against the TPU kernel in the Pallas
interpreter and against numpy, the path rules, the stock-op
SYNTH='colfac' and the Monte Carlo runs, and the CUDA kernel against its
plain version where a card is present.

* Factors: the float64 build agrees with ``fast_tpu.synthesis.
  column_factors`` to 1e-9 of max|L| (float64, other sum order); the
  float32 build reproduces the float64 column covariances to 1e-4
  relative, as ``tests/test_synthesis.py`` holds the JAX package's.
* K1's plain version on the JAX package's own tables with zero bits
  equals the TPU kernel in the Pallas interpreter, whose PRNG yields zero
  bits (1e-3: float32 products in another order, as for K2). Zero bits
  give every column the same noise, so random bits are also checked
  against a float64 numpy evaluation of the definition (1e-3).
* Monte Carlo runs agree with the JAX package's in distribution: mean
  within 5 combined standard errors, scintillation index within 20%.
* On the card the kernel and the plain version draw identical Philox bits
  and agree to KERNEL_REL times the largest |sum|; its two passes alone
  (pass 1's G' within GPRIME_REL N 2^-24 max |G'|, the detect pass's sums
  within KERNEL_REL) against their plain versions.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_colfac.py -m cuda
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
# pass 1 alone, G' against its plain version element by element, in units
# of N 2^-24 max |G'|, as K2's pass 1 is held
# (test_torch_synth_detect.GPRIME_REL)
GPRIME_REL = 1.0


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
        "SEED": 21, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def k1_inputs(N=64, lo=20, hi=44, seed=5, phase_rms=2.0, mixed=True):
    """Random factors ``L`` scaled so that the screens have about
    ``phase_rms`` rad rms, the pruned DFT matrix, a pupil * mode table, and
    the kernel's tables built from them."""
    npup = hi - lo
    rng = np.random.default_rng(seed)
    L = (rng.normal(size=(N, npup, npup))
         + 1j * rng.normal(size=(N, npup, npup)))
    L = (L * phase_rms / np.sqrt(2 * npup * N)).astype(np.complex64)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((npup, npup)).astype(np.float32)
    wr, wi, pm_t = sd.pad_pupil(
        torch.from_numpy(np.ascontiguousarray(W.real)),
        torch.from_numpy(np.ascontiguousarray(W.imag)),
        torch.from_numpy(np.ascontiguousarray(pm.T)))
    t = dict(S=cd.pack_tables(torch.from_numpy(L), mixed=mixed), wr=wr,
             wi=wi, pm_t=pm_t)
    return (L, W, pm), t


def plain_numpy(bits, L, W, pm, mixed, sh=None):
    """K1's function in float64 numpy, from its definition: per column
    ``z = u M`` (or Box-Muller), ``G[:, m] = L_m z_m``, screen ``G W^T``
    (+ ``sh``), then the detector; (2 * nbatch, 2) as the kernel's."""
    b1, b2 = (np.asarray(b, np.int64) >> 8 for b in bits)
    npup = L.shape[1]
    if mixed:
        s3 = np.sqrt(3.0)
        M = sd.mixing_matrix(cd.LANES).astype(np.float64)
        z = ((b1 * (s3 * 2.0 ** -23) - s3) @ M
             + 1j * ((b2 * (s3 * 2.0 ** -23) - s3) @ M))
    else:
        r = np.sqrt(-2 * np.log(b1 * 2.0 ** -24 + 2.0 ** -25))
        z = r * np.exp(2j * np.pi * (b2 * 2.0 ** -24))
    G = np.einsum("mpq,bmq->bpm", L.astype(np.complex128), z[..., :npup])
    scr = G @ W.astype(np.complex128).T
    if sh is not None:
        scr = scr + sh
    sums = [np.stack([(pm * np.cos(phi)).sum((1, 2)),
                      (pm * np.sin(phi)).sum((1, 2))], -1)
            for phi in (scr.real, scr.imag)]
    return np.concatenate(sums)


# --------------------------------------------------------------------------
# column factors
# --------------------------------------------------------------------------


def factor_inputs(N=64, lo=20, hi=44, seed=7):
    rng = np.random.default_rng(seed)
    sqrt_ps = rng.random((N, N)) + 0.1
    sqrt_ps[:, 5] = 0.0  # one fully masked column
    return sqrt_ps, ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex128)


def test_column_factors_match_jax():
    from fast_tpu import synthesis as js
    sqrt_ps, W = factor_inputs()
    ref = js.column_factors(sqrt_ps, 0.7, W)
    got = ts.column_factors(sqrt_ps, 0.7, W)
    assert got.dtype == torch.complex128 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-9 * np.abs(ref).max()


def test_column_factors_f32_reproduce_the_covariances():
    sqrt_ps, W = factor_inputs()
    L64 = ts.column_factors(sqrt_ps, 0.7, W).numpy()
    L32 = ts.column_factors_device(sqrt_ps, 0.7, W.astype(np.complex64),
                                   "cpu")
    assert L32.dtype == torch.complex64
    assert bool(torch.isfinite(torch.view_as_real(L32)).all())
    L32 = L32.numpy().astype(np.complex128)
    C64 = np.einsum("mpq,mrq->mpr", L64, L64.conj())
    C32 = np.einsum("mpq,mrq->mpr", L32, L32.conj())
    assert np.abs(C32 - C64).max() / np.abs(C64).max() < 1e-4


def test_colfac_handles_masked_columns():
    """Fully zero PSD columns still factor, and their screens are finite
    (``tests/test_synthesis.py``)."""
    N, lo, hi = 32, 10, 22
    sqrt_ps = np.zeros((N, N))
    sqrt_ps[12:20, 12:20] = 1.0
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex128)
    for L in (ts.column_factors(sqrt_ps, 0.5, W),
              ts.column_factors_device(sqrt_ps, 0.5, W, "cpu")):
        assert bool(torch.isfinite(torch.view_as_real(L)).all())
        scr = ts.synthesize_screens_colfac(
            torch.Generator().manual_seed(0), L.to(torch.complex64),
            torch.from_numpy(W.astype(np.complex64)), 100)
        assert scr.shape == (100, 12, 12)
        assert bool(torch.isfinite(torch.view_as_real(scr)).all())


def test_failed_f32_factor_is_marked_nan():
    """A column whose Cholesky fails comes back NaN, not raised."""
    C = torch.eye(3, dtype=torch.complex64).repeat(4, 1, 1)
    C[2] = -C[2]
    L = ts._factor(C, 0.0, 1e-30)
    assert bool(torch.isnan(L[2].real).all())
    assert bool(torch.isfinite(torch.view_as_real(L[[0, 1, 3]])).all())


def test_f32_factor_nan_falls_back_to_f64(monkeypatch):
    """A NaN-marked float32 build on the card falls back to the float64
    build (``tests/test_engine.py``), cast to complex64."""
    import fast_tpu_torch
    from fast_tpu_torch import engine
    sim = fast_tpu_torch.Fast(small_params(SYNTH="colfac", NITER=256),
                              device="cpu")
    calls = []

    def nan_factors(sqrt_ps, df, W, device, jitter=3e-6):
        calls.append(device)
        n, npup = W.shape[1], W.shape[0]
        return torch.full((n, npup, npup), float("nan"),
                          dtype=torch.complex64)

    monkeypatch.setattr(engine.synthesis, "column_factors_device",
                        nan_factors)
    sim.device = torch.device("cuda")  # the card's branch, run here
    W64 = ts.pruned_ift2_matrix(sim.Npxls, *sim.pup_crop,
                                dtype=np.complex128)
    L = sim._column_factors(W64)
    assert calls and L.dtype == np.complex64 and np.isfinite(L).all()
    L64 = ts.column_factors(np.sqrt(sim.powerspec),
                            float(sim.freq.main.df), W64).numpy()
    np.testing.assert_array_equal(L, L64.astype(np.complex64))


# --------------------------------------------------------------------------
# K1's plain version
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_sim():
    import fast_tpu
    return fast_tpu.Fast(small_params(SYNTH="colfac"))


def jax_arrays(sim):
    return dict(
        powerspec=np.asarray(sim.powerspec),
        pupil_mode=np.asarray(sim.pupil * sim.pupil_mode),
        W_pruned=np.asarray(sim._W_pruned), df=float(sim.freq.main.df),
        dx=sim.dx, norm=sim._norm, logamp_var=sim.logamp_var,
        diffraction_limit=sim.diffraction_limit, pup_crop=sim.pup_crop,
        L_colfac=np.asarray(sim._L_colfac))


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_plain_matches_pallas_interpret_on_jax_tables(jax_sim, noise):
    """The weights carried across: the JAX package's own factors, DFT
    matrix and pupil through ``tables_from_numpy``, zero bits."""
    from fast_tpu.ops import pallas_synth
    from fast_tpu_torch.interop import tables_from_numpy
    T = tables_from_numpy(jax_arrays(jax_sim), noise=noise)
    nbatch = 4
    c = np.asarray(pallas_synth.fused_colfac_detect(
        1, np.asarray(jax_sim._L_colfac), np.asarray(jax_sim._W_pruned),
        np.asarray(jax_sim._pm), nbatch, interpret=True,
        precision="highest", noise=noise))
    scale = jax_sim.dx ** 2 / jax_sim._norm
    N, lanes = jax_sim.Npxls, T["S_colfac"].shape[1] // 2
    zero = torch.zeros((nbatch, N, lanes), dtype=torch.int64)
    got = cd.colfac_detect_reference(
        0, T["S_colfac"], T["wr"], T["wi"], T["pm_t"], nbatch,
        mixed=noise == "mixed", bits=(zero, zero))
    assert got.shape == c.shape == (2 * nbatch, 2)
    np.testing.assert_allclose(got.numpy() * scale, c * scale, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_plain_matches_numpy_on_random_bits(noise):
    mixed = noise == "mixed"
    (L, W, pm), t = k1_inputs(mixed=mixed)
    nbatch, N = 3, 64
    lanes = t["S"].shape[1] // 2
    assert lanes == (128 if mixed else 32)
    rng = np.random.default_rng(2)
    bits = [torch.from_numpy(rng.integers(0, 2 ** 32, (nbatch, N, lanes)))
            for _ in range(2)]
    got = cd.colfac_detect_reference(0, t["S"], t["wr"], t["wi"], t["pm_t"],
                                     nbatch, mixed=mixed, bits=bits)
    ref = plain_numpy(bits, L, W, pm, mixed)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_philox_counter_layout():
    seed = 0x0123_4567_89AB_CDEF
    b1, b2 = cd.colfac_bits(seed, 3, 5, 16, stream=7, draw0=4)
    m, q, d = 3, 11, 2
    ref = sd.philox4x32_10(*[torch.tensor(v, dtype=torch.int64)
                             for v in (m * 128 + q, 4 + d, 7, 1)],
                           seed & 0xFFFFFFFF, seed >> 32)
    assert int(b1[d, m, q]) == int(ref[0])
    assert int(b2[d, m, q]) == int(ref[1])
    # lane q of a column has the same bits however many lanes are drawn
    c1, _ = cd.colfac_bits(seed, 3, 5, 128, stream=7, draw0=4)
    torch.testing.assert_close(c1[..., :16], b1, rtol=0, atol=0)


def test_plain_draw_offset_continues_the_stream(monkeypatch):
    _, t = k1_inputs()
    args = (0x77, t["S"], t["wr"], t["wi"], t["pm_t"])
    full = cd.colfac_detect_reference(*args, 6, stream=1)
    head = cd.colfac_detect_reference(*args, 4, stream=1)
    tail = cd.colfac_detect_reference(*args, 2, stream=1, draw0=4)
    torch.testing.assert_close(full[:6], torch.cat([head[:4], tail[:2]]),
                               rtol=0, atol=0)
    torch.testing.assert_close(full[6:], torch.cat([head[4:], tail[2:]]),
                               rtol=0, atol=0)
    monkeypatch.setattr(cd, "_REF_POINTS", 2 * 64 * 128)
    torch.testing.assert_close(
        cd.colfac_detect_reference(*args, 6, stream=1), full, rtol=0, atol=0)


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_pack_tables_layout(noise):
    mixed = noise == "mixed"
    (L, _, _), t = k1_inputs(N=8, lo=2, hi=6, mixed=mixed)
    S = t["S"]
    assert S.shape == (8, 256 if mixed else 32, 16, 2) and S.is_contiguous()
    B = L.transpose(0, 2, 1).astype(np.complex128)
    if mixed:
        B = sd.mixing_matrix(128).astype(np.float64)[:, :4] @ B
    S = S.numpy()
    nq = B.shape[1]  # 128 mixed lanes, or the 4 live ones of 'gauss'
    np.testing.assert_allclose(S[:, 0:2 * nq:2, :4, 0], B.real, atol=1e-6)
    np.testing.assert_allclose(S[:, 0:2 * nq:2, :4, 1], B.imag, atol=1e-6)
    np.testing.assert_array_equal(S[:, 1::2, :, 0], -S[:, 0::2, :, 1])
    np.testing.assert_array_equal(S[:, 1::2, :, 1], S[:, 0::2, :, 0])
    assert not S[:, :, 4:].any()
    if not mixed:
        assert not S[:, 8:].any()  # lanes past the pupil meet zero rows


def _word(col, depth):
    """Word of column ``col`` and depth ``depth`` within an 8-deep step of
    wgmma's B layout (csrc/wgmma.cuh), in the kernels' depth-slot order:
    slot s holds depth 2 (s % 4) + s // 4 (the A fragments' order)."""
    s = (0, 2, 4, 6, 1, 3, 5, 7).index(depth % 8)
    return (col // 8) * 64 + (s // 4) * 32 + (col % 8) * 4 + s % 4


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_lay_tables_lays_out_split_operands(noise):
    """Every element of K1's laid table where pass 1 reads it: S_m's TF32
    hi and lo parts per 8-deep step, output column 16 (p // 8) + 8 part +
    p % 8 of pupil pixel p (8 Re, then 8 Im a block), the parts summing to
    the element to 22 bits."""
    mixed = noise == "mixed"
    S = k1_inputs(N=6, lo=2, hi=26, mixed=mixed)[1]["S"]   # P = 32
    N, K, P, _ = S.shape
    laid = cd.lay_tables(S)
    assert isinstance(laid, cd.LaidTable) and not laid.split
    assert laid.shape == S.shape and laid.data.is_contiguous()
    assert laid.data.shape == (N, K // 8, 2, 16 * P)
    hi, lo = sd._hi_lo(S)
    k = np.arange(K)[:, None, None]
    p = np.arange(P)[None, :, None]
    part = np.arange(2)[None, None, :]
    col = 16 * (p // 8) + 8 * part + p % 8
    word = np.vectorize(_word)(col, k)
    # (N, hi/lo, K, P, part)
    got = laid.data.transpose(1, 2)[:, :, k // 8, word]
    assert torch.equal(got[:, 0], hi) and torch.equal(got[:, 1], lo)
    assert float((S - hi - lo).abs().max()) <= 2.0 ** -21 * float(
        S.abs().max())


@pytest.mark.parametrize("npup,noise", [(20, "mixed"), (20, "gauss"),
                                        (150, "mixed"), (150, "gauss")])
def test_laid_table_is_the_plain_table_laid_out(npup, noise):
    """``laid_table`` (the engine's table on the card, K3's built 64
    columns at a time) is the plain table laid out, bit for bit, over 70
    columns; ``kernel_table`` on the CPU is the plain table."""
    mixed = noise == "mixed"
    rng = np.random.default_rng(4)
    L = torch.from_numpy((rng.normal(size=(70, npup, npup))
                          + 1j * rng.normal(size=(70, npup, npup)))
                         .astype(np.complex64))
    split = npup > 128
    plain = (cd.pack_tables_split if split else cd.pack_tables)(L, mixed)
    want = (cd.lay_tables_split if split else cd.lay_tables)(plain)
    got = cd.laid_table(L, mixed)
    assert got.split == split and got.shape == plain.shape
    assert torch.equal(got.data, want.data)
    assert torch.equal(cd.kernel_table(L, mixed), plain)


def test_laid_tables_run_only_on_the_card():
    """The plain version takes the unsplit table: a LaidTable on the CPU
    raises, as does one of the other kernel's layout or of a wrong
    shape."""
    _, t = k1_inputs()
    laid = cd.lay_tables(t["S"])
    with pytest.raises(ValueError, match="only on the card"):
        cd.colfac_detect(1, laid, t["wr"], t["wi"], t["pm_t"], 2)
    with pytest.raises(ValueError, match="only on the card"):
        cd.colfac_pass1(1, laid, 2)
    T = cd.pack_tables_split(torch.from_numpy(k1_inputs()[0][0]))
    with pytest.raises(ValueError, match="laid out for K3"):
        cd.colfac_pass1(1, cd.lay_tables_split(T), 2, mixed=False)
    bad = cd.LaidTable(laid.data[:, 1:].contiguous(), t["S"].shape, False)
    with pytest.raises(ValueError, match="must hold"):
        cd.colfac_pass1(1, bad, 2)


# (kernel, N, P, K or Kq, noise): shapes the kernels took before pass 1
# moved to wgmma (their C `takes`): K1 up to 128 px, 'mixed' 256 rows,
# 'gauss' 2P; K3 any pupil, Kq = LW ('mixed') or P ('gauss'). The default
# config (102 px, P = 112), the flagships' 82 px (P = 96), 16 and 128 px;
# K3 at 24, 144, 402 (P = 416, two slices), 530 (P = 544, three slices,
# the last partial), 1000 (P = 1008, five) and 1680 px (nine slices: no
# cluster)
PARENT_SHAPES = [
    ("K1", 102, 112, 256, "mixed"), ("K1", 102, 112, 224, "gauss"),
    ("K1", 512, 96, 256, "mixed"), ("K1", 512, 96, 192, "gauss"),
    ("K1", 64, 16, 256, "mixed"), ("K1", 64, 16, 32, "gauss"),
    ("K1", 256, 128, 256, "mixed"), ("K1", 256, 128, 256, "gauss"),
    ("K1", 65535, 32, 64, "gauss"),
    ("K3", 64, 32, 128, "mixed"), ("K3", 64, 16, 16, "gauss"),
    ("K3", 160, 144, 256, "mixed"), ("K3", 160, 144, 144, "gauss"),
    ("K3", 1024, 416, 512, "mixed"), ("K3", 1024, 416, 416, "gauss"),
    ("K3", 544, 544, 640, "mixed"), ("K3", 1024, 1008, 1024, "mixed"),
    ("K3", 1024, 1008, 1008, "gauss"), ("K3", 2048, 1680, 1792, "mixed"),
]


@pytest.mark.parametrize("shape", PARENT_SHAPES,
                         ids=lambda c: f"{c[0]}-N{c[1]}P{c[2]}K{c[3]}{c[4]}")
def test_parent_shapes_still_taken(shape):
    """Each shape the kernels took is still taken by the wrappers' checks,
    within a block's shared memory (the Python mirrors of the CUDA
    sources' ``pass1_smem``) and the grid's limits; K3's slices cover the
    pupil and run as clusters of at most 8."""
    kernel, N, P, K, noise = shape
    mixed = noise == "mixed"
    tab = torch.empty((N, K, P, 2), device="meta")
    if kernel == "K1":
        assert cd._check_table(tab, mixed) == (N, K, P)
        cd._check_launch(N, P, 0)
        smem = cd._pass1_smem(P)
    else:
        assert cd._check_split_table(tab, None)[:3] == (N, K, P)
        PB, nz, cs = cd._split_geom(P)
        assert PB % 16 == 0 and PB <= 208 and P <= nz * PB < P + 16 * nz
        assert cs == (nz if nz <= 8 else 1) and nz % cs == 0
        smem = cd._split_smem(P)
    assert smem <= 232448
    assert N <= 65535 and sd.draws_per_launch(N, P) <= 4096


def test_wrapper_runs_plain_version_on_cpu():
    _, t = k1_inputs()
    before = cd.colfac_detect.LAUNCHES
    args = (11, t["S"], t["wr"], t["wi"], t["pm_t"], 3)
    got = cd.colfac_detect(*args, stream=2)
    ref = cd.colfac_detect_reference(*args, stream=2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert cd.colfac_detect.LAUNCHES == before == 0
    assert torch.isfinite(got).all()


def test_wrapper_checks_inputs():
    _, t = k1_inputs()
    gauss = k1_inputs(mixed=False)[1]
    with pytest.raises(ValueError, match="wr"):
        cd.colfac_detect(1, t["S"], t["wr"][:, :32], t["wi"], t["pm_t"], 2)
    with pytest.raises(ValueError, match="'mixed'"):
        cd.colfac_detect(1, gauss["S"], t["wr"], t["wi"], t["pm_t"], 2)
    with pytest.raises(TypeError, match="float32"):
        cd.colfac_detect(1, t["S"].double(), t["wr"], t["wi"], t["pm_t"], 2)
    with pytest.raises(ValueError, match="sh_t"):
        cd.colfac_detect(1, t["S"], t["wr"], t["wi"], t["pm_t"], 2,
                         sh_t=torch.zeros(2, 2, 24, 24))


# --------------------------------------------------------------------------
# rules and runs
# --------------------------------------------------------------------------

CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("args,synth", [
    (("auto", torch.float32, CUDA, 512, 82), "pallas_colfac"),
    (("auto", torch.float32, CUDA, 4096, 128), "pallas_colfac"),
    (("auto", torch.float32, CPU, 512, 82), "pallas_colfac"),
    (("auto", torch.float32, CUDA, 256, 82), "pallas_fused"),
    (("auto", torch.float32, CPU, 512, 130), "pallas_fused"),
    (("auto", torch.float64, CUDA, 512, 82), "fft"),
    (("colfac", torch.float32, CUDA, 512, 130), "colfac"),
])
def test_resolve_synth_colfac_rule(args, synth):
    from fast_tpu_torch.engine import resolve_synth
    assert resolve_synth(*args) == synth


@pytest.mark.parametrize("device", [CPU, CUDA])
def test_pinned_pallas_colfac_refuses_wide_pupils(device):
    """Pinned 'pallas_colfac' used to refuse a pupil over 128 px; it now
    refuses no width and takes the split-layout kernel K3 there."""
    from fast_tpu_torch.engine import resolve_synth
    for npup in (130, 402, 1000):
        assert resolve_synth("pallas_colfac", torch.float32, device, 1024,
                             npup) == "pallas_colfac"
        assert cd.colfac_layout(npup) == "split"
    assert cd.colfac_layout(128) == cd.colfac_layout(82) == "merged"


def test_plain_path_memory_warning(caplog):
    import fast_tpu_torch
    sim = fast_tpu_torch.Fast(small_params(SYNTH="matmul", NITER=256),
                              device="cpu")
    sim.Niter_per_chunk = 2 ** 20  # 2^19 draws of 64 x 64 complex64: 17 GB
    with caplog.at_level("WARNING"):
        sim._prepare_device_constants()
    assert "increase NCHUNKS" in caplog.text


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
    sim = fast_tpu.Fast(small_params(SYNTH="matmul", SEED=22))
    return sim.run().power / sim.diffraction_limit


# K1's plain version draws its Philox bits in int64 torch ops: 2048
# realizations keep the file well inside its time
@pytest.mark.parametrize("synth,niter", [("pallas_colfac", 2048),
                                         ("colfac", NITER)])
def test_run_in_distribution(jax_sim, jax_matmul, synth, niter):
    import fast_tpu_torch
    sim = fast_tpu_torch.Fast(small_params(SYNTH=synth, NITER=niter),
                              device="cpu")
    assert sim._synth == synth
    before = cd.colfac_detect.LAUNCHES
    res = sim.run()
    assert cd.colfac_detect.LAUNCHES == before  # CPU: plain version only
    in_distribution(res.power / res._dl, jax_matmul[:niter])
    # the factors the port built agree with the JAX package's
    L = sim.tables["L"].numpy()
    ref = np.asarray(jax_sim._L_colfac)
    assert np.abs(L - ref).max() <= 1e-5 * np.abs(ref).max()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


# (N, lo, hi, draws): 4100 draws take two launches, the second from draw
# 4096; a grid side that is no multiple of 64 (nor of the 4 columns a block
# takes) with its pupil as wide as the grid; the 512^2 flagship's shapes;
# a 128 px pupil (one chunk of pass 1 in flight) over 100 draws, the
# second warpgroup's 64 partial
KERNEL_CASES = [(64, 20, 44, 4100), (102, 0, 102, 64), (512, 215, 297, 4100),
                (128, 0, 128, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"N{c[0]}x{c[3]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_kernel_matches_plain_on_card(cuda_device, noise, case):
    N, lo, hi, nbatch = case
    mixed = noise == "mixed"
    t = {k: v.to(cuda_device)
         for k, v in k1_inputs(N, lo, hi, phase_rms=1.5, mixed=mixed)[1].items()}
    args = (0xABCDEF0123, t["S"], t["wr"], t["wi"], t["pm_t"], nbatch)
    before = cd.colfac_detect.LAUNCHES
    got = cd.colfac_detect(*args, mixed=mixed, stream=4)
    ref = cd.colfac_detect_reference(*args, mixed=mixed, stream=4)
    torch.cuda.synchronize()
    assert cd.colfac_detect.LAUNCHES == before + -(-nbatch // sd._MAX_DRAWS)
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= KERNEL_REL * float(ref.abs().max())


# (N, lo, hi, draws) of the passes alone: 64^2; the default config's 102^2
# with its pupil as wide as the grid; the 512^2 flagship's shapes; a 12 px
# pupil (P = 16: 32 output columns, the tail alone) and a 128 px one over
# draws that leave a partial 64-draw tile
PASS_CASES = [(64, 20, 44, 37), (102, 0, 102, 16), (512, 215, 297, 70),
              (64, 26, 38, 100), (128, 0, 128, 67)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PASS_CASES, ids=lambda c: f"N{c[0]}x{c[3]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_pass1_matches_plain_on_card(cuda_device, noise, case):
    """G' of K1's pass 1 alone (fast_colfac_pass1, 3xTF32 on the tensor
    cores) against its plain version, element by element, within
    GPRIME_REL N 2^-24 max |G'|."""
    N, lo, hi, nbatch = case
    mixed = noise == "mixed"
    S = k1_inputs(N, lo, hi, phase_rms=1.5, mixed=mixed)[1]["S"]
    S = S.to(cuda_device)
    before = cd.colfac_pass1.LAUNCHES
    gr, gi = cd.colfac_pass1(0xABCDEF0123, S, nbatch, mixed=mixed, stream=4,
                             draw0=5)
    rr, ri = cd.colfac_pass1_reference(0xABCDEF0123, S, nbatch, mixed=mixed,
                                       stream=4, draw0=5)
    torch.cuda.synchronize()
    assert cd.colfac_pass1.LAUNCHES == before + 1
    assert gr.shape == gi.shape == rr.shape == (nbatch, N, S.shape[2])
    assert bool(torch.isfinite(gr).all() and torch.isfinite(gi).all())
    top = max(float(rr.abs().max()), float(ri.abs().max()))
    err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
    assert err <= GPRIME_REL * N * 2.0 ** -24 * top


@pytest.mark.cuda
@pytest.mark.parametrize("npup", [82, 402])
def test_engine_table_runs_as_the_plain_table_on_card(cuda_device, npup):
    """The engine's table on the card (``kernel_table``: laid out once,
    K3's 64 columns at a time) gives the G' of the plain table laid out
    for the call, bit for bit: K1 at 82 px, K3 at 402 px (two slices, a
    cluster of two), 70 columns."""
    rng = np.random.default_rng(6)
    L = ((rng.normal(size=(70, npup, npup))
          + 1j * rng.normal(size=(70, npup, npup))) / npup).astype(
        np.complex64)
    L = torch.from_numpy(L).to(cuda_device)
    laid = cd.kernel_table(L)
    assert isinstance(laid, cd.LaidTable)
    if npup > 128:
        plain = cd.pack_tables_split(L)
        got = cd.split_pass1(0xABCDEF0123, laid, 67, stream=4)
        want = cd.split_pass1(0xABCDEF0123, plain, 67, stream=4)
    else:
        plain = cd.pack_tables(L)
        got = cd.colfac_pass1(0xABCDEF0123, laid, 67, stream=4)
        want = cd.colfac_pass1(0xABCDEF0123, plain, 67, stream=4)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", PASS_CASES, ids=lambda c: f"N{c[0]}x{c[3]}")
def test_detect_pass_matches_plain_on_card(cuda_device, case):
    """The detect pass alone (fast_detect_pass, H = W G' in 3xTF32 on the
    tensor cores) on the plain pass 1's G', with and without subharmonic
    screens, against its plain version within KERNEL_REL."""
    N, lo, hi, nbatch = case
    t = {k: v.to(cuda_device)
         for k, v in k1_inputs(N, lo, hi, phase_rms=1.5)[1].items()}
    gr, gi = cd.colfac_pass1_reference(0xABCDEF0123, t["S"], nbatch)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    sh = torch.complex(*torch.randn((2, nbatch, hi - lo, hi - lo),
                                    device=cuda_device, generator=g))
    sh_t = sd.pack_subharm(sh, t["wr"].shape[0])
    for shk in (None, sh_t):
        before = cd.detect_pass.LAUNCHES
        got = cd.detect_pass(gr, gi, t["wr"], t["wi"], t["pm_t"], shk)
        ref = sd.detect_reference(gr, gi, t["wr"], t["wi"], t["pm_t"], shk)
        torch.cuda.synchronize()
        assert cd.detect_pass.LAUNCHES == before + 1
        assert got.shape == ref.shape == (nbatch, 4)
        assert bool(torch.isfinite(got).all())
        err = float((got - ref).abs().max())
        assert err <= KERNEL_REL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_pass1_at_default_matches_plain_on_card(cuda_device, noise):
    """K1's pass 1 at PRECISION='default' from the table laid out for one
    TF32 pass, against its plain version at 'default': 'mixed' noise
    (the same float32 operands) within GPRIME_REL N 2^-24 max |G'|,
    Box-Muller noise (computed otherwise on the card) within ONE_PASS_MAX
    and ONE_PASS_RMS of the TF32 distance (tests/test_torch_tf32x3.py); a
    table laid out for the other pass count is refused."""
    from test_torch_tf32x3 import ONE_PASS_MAX, ONE_PASS_RMS, tf32_readings
    N, lo, hi, nbatch = 512, 215, 297, 70
    mixed = noise == "mixed"
    S = k1_inputs(N, lo, hi, phase_rms=1.5, mixed=mixed)[1]["S"]
    S = S.to(cuda_device)
    laid = cd.lay_tables(S, passes=1)
    assert laid.data.shape[2] == 1
    kw = dict(mixed=mixed, stream=4)
    g = cd.colfac_pass1(0xABCDEF0123, laid, nbatch, precision="default",
                        **kw)
    p1, p3 = (cd.colfac_pass1_reference(0xABCDEF0123, S, nbatch,
                                        precision=p, **kw)
              for p in ("default", "highest"))
    torch.cuda.synchronize()
    if mixed:
        top = max(float(x.abs().max()) for x in p1)
        err = max(float((x - y).abs().max()) for x, y in zip(g, p1))
        assert err <= GPRIME_REL * N * 2.0 ** -24 * top
    else:
        mx, rms = tf32_readings(g, p1, p3)
        assert mx <= ONE_PASS_MAX and rms <= ONE_PASS_RMS
    with pytest.raises(ValueError, match="TF32 pass"):
        cd.colfac_pass1(0xABCDEF0123, laid, nbatch, **kw)
