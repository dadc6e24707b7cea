"""Pupils over 128 px in fast_tpu_torch against fast_tpu: K3 (the
split-layout colfac kernel) and the widened K2, on the CPU through their
plain versions, and on the card against them.

* K3's plain version on the JAX package's split tables' inputs with zero
  bits equals the TPU kernel ``_colfac_detect_kernel`` in the Pallas
  interpreter, whose PRNG yields zero bits (1e-3 of the sums: float32
  products in another order). Zero bits give every column the same noise,
  so random bits are also checked against a float64 numpy evaluation of
  the definition, at a pupil of 144 px on a 160^2 grid: two tiles of 80 px
  per axis on the card, the last one ragged.
* ``pack_tables_split`` is ``colfac_pack_tables(L, W, 'highest', noise)``
  transposed and cropped, to float32 round-off (1e-6 of the largest
  entry); ``colfac_layout`` and the lane width follow the JAX rule.
* K2's plain version at the same wide pupil against numpy (1e-3).
* Monte Carlo runs at a 130 px pupil (a 2.56 m telescope at DX = 0.02 m on
  a 144^2 grid) agree with ``fast_tpu.Fast(SYNTH='matmul')`` in
  distribution: mean within 5 combined standard errors, scintillation
  index within 20%.
* On the card each kernel and its plain version draw identical Philox bits
  and agree to KERNEL_REL times the largest |sum|; K3's pass 1 alone (G'
  within GPRIME_REL N 2^-24 max |G'|) and the tiled detect pass alone
  (sums within KERNEL_REL) against their plain versions.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_wide_pupil.py -m cuda
"""

import numpy as np
import pytest
import torch

import test_torch_colfac

from fast_tpu_torch import synthesis as ts
from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops import synth_detect as sd

torch.set_num_threads(1)

NITER = 1024
KERNEL_REL = 4e-6
# K3's pass 1 alone, G' against its plain version element by element, in
# units of N 2^-24 max |G'|, as K2's pass 1 is held
# (test_torch_synth_detect.GPRIME_REL)
GPRIME_REL = 1.0


def wide_params(**overrides):
    """The flagship link with a 2.56 m telescope at DX = 0.02 m: a 130 px
    pupil on a 144^2 grid."""
    import fast_tpu_torch
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 144, "DX": 0.02, "NITER": NITER, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 2.56, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.32, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 31, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def small_params(**overrides):
    """The flagship link at NPXLS=64, DX=0.02: a 42 px pupil."""
    return wide_params(**{"NPXLS": 64, "D_GROUND": 0.8, "DSUBAP": 0.1,
                          "SEED": 21, **overrides})


def jax_arrays(sim, **more):
    return dict(
        powerspec=np.asarray(sim.powerspec),
        pupil_mode=np.asarray(sim.pupil * sim.pupil_mode),
        W_pruned=np.asarray(sim._W_pruned), df=float(sim.freq.main.df),
        dx=sim.dx, norm=sim._norm, logamp_var=sim.logamp_var,
        diffraction_limit=sim.diffraction_limit, pup_crop=sim.pup_crop,
        **more)


def k2_inputs(N, lo, hi, seed=5, phase_rms=2.0):
    """K2's inputs from a seed, the PSD scaled so that the screens have
    about ``phase_rms`` rad rms."""
    npup = hi - lo
    rng = np.random.default_rng(seed)
    sqrt_ps = (rng.random((N, N)) + 0.2).astype(np.float32)
    df = phase_rms / float(np.sqrt((sqrt_ps.astype(np.float64) ** 2).sum()))
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((npup, npup)).astype(np.float32)
    t = dict(
        s_t=torch.from_numpy(np.ascontiguousarray(sqrt_ps.T * np.float32(df))),
        wr=torch.from_numpy(np.ascontiguousarray(W.real)),
        wi=torch.from_numpy(np.ascontiguousarray(W.imag)),
        pm_t=torch.from_numpy(np.ascontiguousarray(pm.T)),
        mix=torch.from_numpy(sd.mixing_matrix(N).copy()))
    return (sqrt_ps, df, W, pm), t


def k3_inputs(N=64, lo=20, hi=44, seed=5, phase_rms=2.0, mixed=True,
              device="cpu"):
    """Random factors ``L`` scaled so that the screens have about
    ``phase_rms`` rad rms, the pruned DFT matrix, a pupil * mode table, and
    K3's tables built from them on ``device``."""
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
    t = dict(T=cd.pack_tables_split(torch.from_numpy(L).to(device),
                                    mixed=mixed),
             wr=wr.to(device), wi=wi.to(device), pm_t=pm_t.to(device))
    return (L, W, pm), t


def detect_numpy(scr, pm):
    sums = [np.stack([(pm * np.cos(phi)).sum((1, 2)),
                      (pm * np.sin(phi)).sum((1, 2))], -1)
            for phi in (scr.real, scr.imag)]
    return np.concatenate(sums)


def k3_numpy(bits, L, W, pm, mixed, sh=None):
    """K3's function in float64 numpy, from its definition: per column
    ``z = u M`` over the lane width (or Box-Muller), ``G[:, m] = L_m z_m``,
    screen ``G W^T`` (+ ``sh``), then the detector."""
    b1, b2 = (np.asarray(b, np.int64) >> 8 for b in bits)
    npup = L.shape[1]
    if mixed:
        s3 = np.sqrt(3.0)
        M = sd.mixing_matrix(cd.lane_width(npup)).astype(np.float64)
        z = ((b1 * (s3 * 2.0 ** -23) - s3) @ M
             + 1j * ((b2 * (s3 * 2.0 ** -23) - s3) @ M))
    else:
        r = np.sqrt(-2 * np.log(b1 * 2.0 ** -24 + 2.0 ** -25))
        z = r * np.exp(2j * np.pi * (b2 * 2.0 ** -24))
    G = np.einsum("mpq,bmq->bpm", L.astype(np.complex128), z[..., :npup])
    scr = G @ W.astype(np.complex128).T
    return detect_numpy(scr if sh is None else scr + sh, pm)


# --------------------------------------------------------------------------
# K3: tables, rule, plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("npup", [1, 82, 127, 128, 129, 256, 257, 402, 1000])
def test_colfac_layout_matches_jax(npup):
    from fast_tpu.ops import pallas_synth
    assert cd.colfac_layout(npup) == pallas_synth.colfac_layout(
        "auto", npup, "highest")
    assert cd.lane_width(npup) == pallas_synth._round_up(npup, 128)
    # the padded pupil's lane width is the pupil's: 'gauss' tables, whose
    # lanes are the padded pupil, take the same counter stride
    assert cd.lane_width(sd.padded_pupil(npup)) == cd.lane_width(npup)


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
@pytest.mark.parametrize("npup", [24, 150])
def test_pack_tables_split_matches_jax(noise, npup):
    from fast_tpu.ops import pallas_synth
    N = 6
    rng = np.random.default_rng(9)
    L = (rng.normal(size=(N, npup, npup))
         + 1j * rng.normal(size=(N, npup, npup))).astype(np.complex64)
    tab = cd.pack_tables_split(torch.from_numpy(L), mixed=noise == "mixed")
    T = tab.numpy()
    l2, _ = pallas_synth.colfac_pack_tables(
        L, np.zeros((npup, N), np.complex64), "highest", noise=noise)
    assert l2.dtype == np.float32
    P, LW = sd.padded_pupil(npup), cd.lane_width(npup)
    Kq = LW if noise == "mixed" else P
    assert T.shape == (N, Kq, P, 2) and tab.is_contiguous()
    # l2[c, m, p, q] is the table's [m, q, p, c]
    ref = np.transpose(l2, (1, 3, 2, 0))[:, :Kq, :npup]
    assert np.abs(T[:, :, :npup] - ref).max() <= 1e-6 * np.abs(ref).max()
    assert not T[:, :, npup:].any()
    if noise == "gauss":
        assert not T[:, npup:].any()  # lanes past the pupil meet zero rows


@pytest.fixture(scope="module")
def jax_sim():
    import fast_tpu
    return fast_tpu.Fast(small_params(SYNTH="colfac"))


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_split_plain_matches_pallas_interpret_on_jax_tables(jax_sim, noise):
    """The weights carried across: the JAX package's own factors, DFT
    matrix and pupil, through the split kernel on both sides, zero bits."""
    from fast_tpu.ops import pallas_synth
    from fast_tpu_torch.interop import tables_from_numpy
    mixed = noise == "mixed"
    T = tables_from_numpy(
        jax_arrays(jax_sim, L_colfac=np.asarray(jax_sim._L_colfac)),
        noise=noise)
    tab = cd.pack_tables_split(T["L"], mixed=mixed)
    nbatch = 4
    c = np.asarray(pallas_synth.fused_colfac_detect(
        1, np.asarray(jax_sim._L_colfac), np.asarray(jax_sim._W_pruned),
        np.asarray(jax_sim._pm), nbatch, interpret=True,
        precision="highest", noise=noise, layout="split"))
    scale = jax_sim.dx ** 2 / jax_sim._norm
    zero = torch.zeros((nbatch, jax_sim.Npxls, tab.shape[1]),
                       dtype=torch.int64)
    got = cd.colfac_split_reference(0, tab, T["wr"], T["wi"], T["pm_t"],
                                    nbatch, mixed=mixed, bits=(zero, zero))
    assert got.shape == c.shape == (2 * nbatch, 2)
    np.testing.assert_allclose(got.numpy() * scale, c * scale, rtol=1e-3,
                               atol=1e-3)


# a 24 px pupil (one tile, 128 lanes) and a 144 px one on a 160^2 grid
# (256 lanes; two tiles of 80 px per axis, the second ragged)
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
@pytest.mark.parametrize("shape", [(64, 20, 44), (160, 8, 152)])
def test_split_plain_matches_numpy_on_random_bits(noise, shape):
    mixed = noise == "mixed"
    N, lo, hi = shape
    (L, W, pm), t = k3_inputs(N, lo, hi, mixed=mixed)
    nbatch, Kq = 3, t["T"].shape[1]
    assert Kq == (cd.lane_width(hi - lo) if mixed
                  else sd.padded_pupil(hi - lo))
    rng = np.random.default_rng(2)
    bits = [torch.from_numpy(rng.integers(0, 2 ** 32, (nbatch, N, Kq)))
            for _ in range(2)]
    got = cd.colfac_split_reference(0, t["T"], t["wr"], t["wi"], t["pm_t"],
                                    nbatch, mixed=mixed, bits=bits)
    ref = k3_numpy(bits, L, W, pm, mixed)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_split_plain_adds_subharmonic_screens():
    (L, W, pm), t = k3_inputs(160, 8, 152)
    nbatch, npup, Kq = 2, 144, t["T"].shape[1]
    rng = np.random.default_rng(3)
    bits = [torch.from_numpy(rng.integers(0, 2 ** 32, (nbatch, 160, Kq)))
            for _ in range(2)]
    sh = (rng.normal(size=(nbatch, npup, npup))
          + 1j * rng.normal(size=(nbatch, npup, npup)))
    sh_t = sd.pack_subharm(torch.from_numpy(sh.astype(np.complex64)))
    got = cd.colfac_split_reference(0, t["T"], t["wr"], t["wi"], t["pm_t"],
                                    nbatch, bits=bits, sh_t=sh_t)
    np.testing.assert_allclose(got.numpy(), k3_numpy(bits, L, W, pm, True, sh),
                               rtol=1e-3, atol=1e-3)


def test_split_philox_counter_layout():
    """Counter (m * LW + q, draw, stream, 3): the lane stride is the lane
    width of the pupil, not K1's 128, and the last word is K3's own."""
    seed = 0x0123_4567_89AB_CDEF
    kw = dict(stream=7, draw0=4, lane_stride=512, word=3)
    b1, b2 = cd.colfac_bits(seed, 3, 5, 416, **kw)
    m, q, d = 3, 411, 2
    ref = sd.philox4x32_10(*[torch.tensor(v, dtype=torch.int64)
                             for v in (m * 512 + q, 4 + d, 7, 3)],
                           seed & 0xFFFFFFFF, seed >> 32)
    assert int(b1[d, m, q]) == int(ref[0])
    assert int(b2[d, m, q]) == int(ref[1])
    # lane q of a column has the same bits however many lanes are drawn
    c1, _ = cd.colfac_bits(seed, 3, 5, 512, **kw)
    torch.testing.assert_close(c1[..., :416], b1, rtol=0, atol=0)
    # and K1's stream of the same seed is another one
    k1, _ = cd.colfac_bits(seed, 3, 5, 128, stream=7, draw0=4)
    assert not torch.equal(k1, c1[..., :128])


def test_split_plain_uses_the_counter_of_its_lane_width():
    """The plain version draws what ``colfac_bits`` gives at the table's
    lane stride: 'gauss' tables (lanes = the padded pupil) and 'mixed'
    tables (lanes = the lane width) of one pupil share the stride."""
    for mixed in (True, False):
        _, t = k3_inputs(160, 8, 152, mixed=mixed)
        Kq = t["T"].shape[1]
        bits = cd.colfac_bits(0x99, 2, 160, Kq, stream=5, lane_stride=256,
                              word=3)
        args = (0x99, t["T"], t["wr"], t["wi"], t["pm_t"], 2)
        torch.testing.assert_close(
            cd.colfac_split_reference(*args, mixed=mixed, stream=5),
            cd.colfac_split_reference(*args, mixed=mixed, bits=bits),
            rtol=0, atol=0)


def test_split_plain_draw_offset_continues_the_stream(monkeypatch):
    _, t = k3_inputs()
    args = (0x77, t["T"], t["wr"], t["wi"], t["pm_t"])
    full = cd.colfac_split_reference(*args, 6, stream=1)
    head = cd.colfac_split_reference(*args, 4, stream=1)
    tail = cd.colfac_split_reference(*args, 2, stream=1, draw0=4)
    torch.testing.assert_close(full[:6], torch.cat([head[:4], tail[:2]]),
                               rtol=0, atol=0)
    torch.testing.assert_close(full[6:], torch.cat([head[4:], tail[2:]]),
                               rtol=0, atol=0)
    monkeypatch.setattr(cd, "_REF_POINTS", 2 * 64 * 128)
    torch.testing.assert_close(
        cd.colfac_split_reference(*args, 6, stream=1), full, rtol=0, atol=0)


def test_lay_tables_split_lays_out_split_operands():
    """Every element of K3's laid table where pass 1 reads it: per pupil
    slice of PB px (448 px cut into three of 160, the last partial) and
    8-deep step of the lanes (80, padded to 128), B_r's TF32 hi and lo
    parts, then B_i's, in wgmma's core-matrix order; padding zero."""
    N, Kq, P = 3, 80, 448
    T = torch.from_numpy(np.random.default_rng(2).normal(
        size=(N, Kq, P, 2)).astype(np.float32))
    PB, nz, cs = cd._split_geom(P)
    assert (PB, nz, cs) == (160, 3, 3)
    laid = cd.lay_tables_split(T)
    assert laid.split and laid.shape == T.shape
    assert laid.data.shape == (N, nz, 128 // 8, 4, 8 * PB)
    hi, lo = sd._hi_lo(T)
    q = np.arange(Kq)[:, None]
    p = np.arange(P)[None, :]
    word = np.vectorize(test_torch_colfac._word)(p % PB, q)
    # (N, 4, Kq, P): B_r hi, B_r lo, B_i hi, B_i lo
    got = laid.data.permute(0, 3, 1, 2, 4)[:, :, p // PB, q // 8, word]
    want = torch.stack([hi[..., 0], lo[..., 0], hi[..., 1], lo[..., 1]], 1)
    assert torch.equal(got, want)
    assert float(laid.data[:, :, Kq // 8:].abs().max()) == 0.0
    last = laid.data[:, nz - 1].reshape(N, 128 // 8, 4, PB // 8, 64)
    assert float(last[:, :, :, (P - (nz - 1) * PB) // 8:].abs().max()) == 0.0


def test_split_wrapper_runs_plain_version_on_cpu():
    _, t = k3_inputs()
    args = (11, t["T"], t["wr"], t["wi"], t["pm_t"], 3)
    got = cd.colfac_detect_split(*args, stream=2)
    ref = cd.colfac_split_reference(*args, stream=2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert cd.colfac_detect_split.LAUNCHES == 0
    assert torch.isfinite(got).all()


def test_split_wrapper_checks_inputs():
    _, t = k3_inputs()
    with pytest.raises(ValueError, match="wr"):
        cd.colfac_detect_split(1, t["T"], t["wr"][:, :32], t["wi"],
                               t["pm_t"], 2)
    with pytest.raises(ValueError, match="lanes"):
        cd.colfac_detect_split(1, t["T"][:, :24].contiguous(), t["wr"],
                               t["wi"], t["pm_t"], 2)
    with pytest.raises(ValueError, match="lane stride"):
        cd.colfac_detect_split(1, t["T"], t["wr"], t["wi"], t["pm_t"], 2,
                               LW=64)
    with pytest.raises(TypeError, match="float32"):
        cd.colfac_detect_split(1, t["T"].double(), t["wr"], t["wi"],
                               t["pm_t"], 2)
    with pytest.raises(ValueError, match="sh_t"):
        cd.colfac_detect_split(1, t["T"], t["wr"], t["wi"], t["pm_t"], 2,
                               sh_t=torch.zeros(2, 2, 24, 24))


# --------------------------------------------------------------------------
# K2's plain version at a wide pupil
# --------------------------------------------------------------------------


def k2_numpy(bits, sqrt_ps, df, W, pm, mix, sh=None):
    """K2's function in float64 numpy: the full-grid noise coloured by
    ``sqrt(PSD) df``, ``W X W^T`` (+ ``sh``), the detector."""
    b1, b2 = (np.asarray(b, np.int64) >> 8 for b in bits)
    if mix is not None:
        s3 = np.sqrt(3.0)
        M = mix.astype(np.float64)
        z = ((b1 * (s3 * 2.0 ** -23) - s3) @ M
             + 1j * ((b2 * (s3 * 2.0 ** -23) - s3) @ M))
    else:
        r = np.sqrt(-2 * np.log(b1 * 2.0 ** -24 + 2.0 ** -25))
        z = r * np.exp(2j * np.pi * (b2 * 2.0 ** -24))
    # the kernel's noise is that of the transposed grid
    X = np.swapaxes(z, 1, 2) * (sqrt_ps.astype(np.float64) * df)
    W = W.astype(np.complex128)
    scr = W @ X @ W.T
    return detect_numpy(scr if sh is None else scr + sh, pm)


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_k2_plain_matches_numpy_at_a_wide_pupil(noise):
    N, lo, hi, nbatch = 160, 8, 152, 3
    (sqrt_ps, df, W, pm), t = k2_inputs(N, lo, hi)
    rng = np.random.default_rng(4)
    bits = [torch.from_numpy(rng.integers(0, 2 ** 32, (nbatch, N, N)))
            for _ in range(2)]
    sh = (rng.normal(size=(nbatch, hi - lo, hi - lo))
          + 1j * rng.normal(size=(nbatch, hi - lo, hi - lo)))
    mix = t["mix"] if noise == "mixed" else None
    wr, wi, pm_t = sd.pad_pupil(t["wr"], t["wi"], t["pm_t"])
    assert wr.shape[0] == 144 and sd.pupil_tiles(wr.shape[0]) == 2
    for s in (None, sh):
        sh_t = (None if s is None else
                sd.pack_subharm(torch.from_numpy(s.astype(np.complex64))))
        got = sd.synth_detect_reference(0, t["s_t"], wr, wi, pm_t, nbatch,
                                        mix=mix, bits=bits, sh_t=sh_t)
        ref = k2_numpy(bits, sqrt_ps, df, W, pm,
                       None if mix is None else mix.numpy(), s)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------
# tables and runs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_matmul():
    import fast_tpu
    sim = fast_tpu.Fast(wide_params(SYNTH="matmul", SEED=32))
    return sim, sim.run().power / sim.diffraction_limit


def test_tables_pick_the_split_table_for_a_wide_pupil(jax_sim, jax_matmul):
    from fast_tpu import synthesis as js
    from fast_tpu_torch.interop import tables_from_numpy
    narrow = tables_from_numpy(
        jax_arrays(jax_sim, L_colfac=np.asarray(jax_sim._L_colfac)))
    assert "S_colfac" in narrow and "T_colfac" not in narrow
    sim = jax_matmul[0]
    assert sim.Npxls_pup == 130
    L = js.column_factors(np.sqrt(sim.powerspec), float(sim.freq.main.df),
                          np.asarray(sim._W_pruned).astype(np.complex128))
    wide = tables_from_numpy(
        jax_arrays(sim, L_colfac=np.asarray(L).astype(np.complex64)))
    assert "T_colfac" in wide and "S_colfac" not in wide
    assert wide["T_colfac"].shape == (144, 256, 144, 2)
    assert wide["wr"].shape == (144, 144) and wide["pm_t"].shape == (144, 144)


def in_distribution(r, ref, si_rel=0.2):
    r, ref = np.asarray(r, np.float64), np.asarray(ref, np.float64)
    assert r.shape == ref.shape and np.isfinite(r).all()
    se = np.hypot(r.std(), ref.std()) / np.sqrt(r.size)
    assert abs(r.mean() - ref.mean()) <= 5 * se
    si, si_ref = r.var() / r.mean() ** 2, ref.var() / ref.mean() ** 2
    assert abs(si - si_ref) <= si_rel * si_ref


# pinned 'pallas_colfac' takes K3 at this pupil, 'auto' K2: their plain
# versions draw Philox bits in int64 torch ops, so 512 realizations each
@pytest.mark.parametrize("synth,resolved,counter", [
    ("pallas_colfac", "pallas_colfac", "colfac_detect_split"),
    ("auto", "pallas_fused", "synth_detect"),
])
def test_wide_pupil_run_in_distribution(jax_matmul, monkeypatch, synth,
                                        resolved, counter):
    import fast_tpu_torch
    from fast_tpu_torch import engine
    calls = []
    mod = sd if counter == "synth_detect" else cd
    inner = getattr(mod, counter)

    def spy(*args, **kw):
        calls.append(args[-1])
        return inner(*args, **kw)

    target = engine if counter == "synth_detect" else engine.cd
    monkeypatch.setattr(target, counter, spy)
    sim = fast_tpu_torch.Fast(wide_params(SYNTH=synth, NITER=512),
                              device="cpu")
    assert sim._synth == resolved and sim.Npxls_pup == 130
    assert ("T_colfac" in sim.tables) == (synth == "pallas_colfac")
    res = sim.run()
    assert calls == [128, 128]  # one call per chunk, through that wrapper
    assert inner.LAUNCHES == 0  # CPU: plain version only
    in_distribution(res.power / res._dl, jax_matmul[1][:512])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


# (N, lo, hi, draws): a narrow pupil through K3 (one tile); 144 px on 160^2
# (two tiles an axis, the second ragged), 4100 draws in two launches; a
# 402 px pupil's tiling (4 tiles of 112 px) at a small grid; 530 px: five
# tiles an axis and two pass-1 blocks along the pupil in K2
KERNEL_CASES = [(64, 20, 44, 70), (160, 8, 152, 4100), (416, 7, 409, 5),
                (544, 7, 537, 3)]
# K3's: the first three, then 530 px (pass 1 in three slices of 192 px,
# a cluster of three, the last slice partial) and the 402 px pupil over
# 70 draws (a partial second 64-draw tile)
SPLIT_CASES = KERNEL_CASES[:3] + [(544, 7, 537, 3), (416, 7, 409, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"N{c[0]}x{c[3]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_split_kernel_matches_plain_on_card(cuda_device, noise, case):
    N, lo, hi, nbatch = case
    mixed = noise == "mixed"
    t = k3_inputs(N, lo, hi, phase_rms=1.5, mixed=mixed,
                  device=cuda_device)[1]
    args = (0xABCDEF0123, t["T"], t["wr"], t["wi"], t["pm_t"], nbatch)
    before = cd.colfac_detect_split.LAUNCHES
    got = cd.colfac_detect_split(*args, mixed=mixed, stream=4)
    ref = cd.colfac_split_reference(*args, mixed=mixed, stream=4)
    torch.cuda.synchronize()
    per = sd.draws_per_launch(N, t["wr"].shape[0])
    assert cd.colfac_detect_split.LAUNCHES == before + -(-nbatch // per)
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= KERNEL_REL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES[1:],
                         ids=lambda c: f"N{c[0]}x{c[3]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_k2_kernel_matches_plain_at_wide_pupils_on_card(cuda_device, noise,
                                                        case):
    N, lo, hi, nbatch = case
    t = {k: v.to(cuda_device)
         for k, v in k2_inputs(N, lo, hi, phase_rms=1.5)[1].items()}
    g = torch.Generator(device=cuda_device).manual_seed(3)
    sh = torch.complex(*torch.randn((2, nbatch, hi - lo, hi - lo),
                                    device=cuda_device, generator=g))
    wr, wi, pm_t = sd.pad_pupil(t["wr"], t["wi"], t["pm_t"])
    sh_t = sd.pack_subharm(sh, wr.shape[0])
    mix = t["mix"] if noise == "mixed" else None
    args = (0xABCDEF0123, t["s_t"], wr, wi, pm_t, nbatch)
    for kw in ({}, {"sh_t": sh_t}):
        got = sd.synth_detect(*args, mix=mix, stream=4, **kw)
        ref = sd.synth_detect_reference(*args, mix=mix, stream=4, **kw)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        err = float((got - ref).abs().max())
        assert err <= KERNEL_REL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"N{c[0]}x{c[3]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_split_pass1_matches_plain_on_card(cuda_device, noise, case):
    """G' of K3's pass 1 alone (fast_split_pass1, 3xTF32 on the tensor
    cores) against its plain version, element by element, within
    GPRIME_REL N 2^-24 max |G'|."""
    N, lo, hi, nbatch = case
    mixed = noise == "mixed"
    T = k3_inputs(N, lo, hi, phase_rms=1.5, mixed=mixed,
                  device=cuda_device)[1]["T"]
    nbatch = min(nbatch, 70)
    before = cd.split_pass1.LAUNCHES
    gr, gi = cd.split_pass1(0xABCDEF0123, T, nbatch, mixed=mixed, stream=4,
                            draw0=5)
    rr, ri = cd.split_pass1_reference(0xABCDEF0123, T, nbatch, mixed=mixed,
                                      stream=4, draw0=5)
    torch.cuda.synchronize()
    assert cd.split_pass1.LAUNCHES == before + 1
    assert gr.shape == gi.shape == rr.shape == (nbatch, N, T.shape[2])
    assert bool(torch.isfinite(gr).all() and torch.isfinite(gi).all())
    top = max(float(rr.abs().max()), float(ri.abs().max()))
    err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
    assert err <= GPRIME_REL * N * 2.0 ** -24 * top


def detect_inputs(N, lo, hi, nbatch, seed=5, phase_rms=1.5, device="cpu"):
    """Inputs of the detect pass alone: W and pm padded to the kernel's
    width, and random G' (nbatch, N, P) whose screens have about
    ``phase_rms`` rad rms."""
    rng = np.random.default_rng(seed)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((hi - lo, hi - lo)).astype(np.float32)
    wr, wi, pm_t = sd.pad_pupil(
        torch.from_numpy(np.ascontiguousarray(W.real)),
        torch.from_numpy(np.ascontiguousarray(W.imag)),
        torch.from_numpy(np.ascontiguousarray(pm.T)))
    P = wr.shape[0]
    scale = phase_rms / np.sqrt((np.abs(W) ** 2).sum(1).mean())
    g = (rng.standard_normal((2, nbatch, N, P)) * scale).astype(np.float32)
    return [x.to(device) for x in (torch.from_numpy(g[0]),
                                   torch.from_numpy(g[1]), wr, wi, pm_t)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES[1:],
                         ids=lambda c: f"N{c[0]}x{c[3]}")
def test_detect_pass_matches_plain_at_wide_pupils_on_card(cuda_device, case):
    """The tiled detect pass alone (fast_detect_pass: tiles of H = W G' in
    3xTF32 on the tensor cores, partial sums added in tile order) with and
    without subharmonic screens, against its plain version within
    KERNEL_REL."""
    N, lo, hi, nbatch = case
    nbatch = min(nbatch, 37)
    gr, gi, wr, wi, pm_t = detect_inputs(N, lo, hi, nbatch,
                                         device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    sh = torch.complex(*torch.randn((2, nbatch, hi - lo, hi - lo),
                                    device=cuda_device, generator=g))
    sh_t = sd.pack_subharm(sh, wr.shape[0])
    for shk in (None, sh_t):
        before = cd.detect_pass.LAUNCHES
        got = cd.detect_pass(gr, gi, wr, wi, pm_t, shk)
        ref = sd.detect_reference(gr, gi, wr, wi, pm_t, shk)
        torch.cuda.synchronize()
        assert cd.detect_pass.LAUNCHES == before + 1
        assert got.shape == ref.shape == (nbatch, 4)
        assert bool(torch.isfinite(got).all())
        err = float((got - ref).abs().max())
        assert err <= KERNEL_REL * float(ref.abs().max())
