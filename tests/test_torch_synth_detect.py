"""K2 (synth-detect) of fast_tpu_torch: shared pieces, plain version
against the TPU kernel run in the Pallas interpreter, and the CUDA kernel
against the plain version where a card is present.

The interpreter's PRNG yields zero bits (tests/test_pallas.py), so the
plain version is fed zero bits too, and both then compute the same
deterministic function. Tolerance 1e-3 (rtol and atol), as in
tests/test_pallas.py: float32 products in another summation order.

On the card the kernel and the plain version draw identical Philox bits;
they must agree to KERNEL_REL times the largest |sum|: float32 products
and sums in another order differ by a few units in the last place of the
sums, and products at TF32 precision would not pass.

At PRECISION='default' (one TF32 pass) the card cases hold each pass
against its plain version at 'default' with the limits of
tests/test_torch_tf32x3.py: the 3xTF32 limits where both take the same
float32 operands, else in units of the TF32 distance |plain('default') -
plain('highest')| (ONE_PASS_MAX, ONE_PASS_RMS).

The JAX package is imported inside the tests that compare with it, so
that the card-only cases also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_synth_detect.py -m cuda
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch.ops import synth_detect as sd
from fast_tpu_torch.synthesis import pruned_ift2_matrix

torch.set_num_threads(1)

KERNEL_REL = 4e-6
# pass 1 alone, G' against its plain version element by element, in units
# of N 2^-24 max |G'|: the fp32 round-off of depth-N sums. The CPU
# emulation of the kernel's 3xTF32 products reads 0.01-0.05 of it, one
# TF32 pass 3.8-25 (tests/test_torch_tf32x3.py)
GPRIME_REL = 1.0


def k2_inputs(N=64, lo=20, hi=44, seed=5, phase_rms=None):
    """K2's inputs from a seed; ``phase_rms`` scales the PSD so that the
    screens have about that rms phase [rad], as a link's do."""
    npup = hi - lo
    rng = np.random.default_rng(seed)
    sqrt_ps = (rng.random((N, N)) + 0.2).astype(np.float32)
    df = 0.3
    if phase_rms is not None:
        df = phase_rms / float(np.sqrt((sqrt_ps.astype(np.float64) ** 2).sum()))
    W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((npup, npup)).astype(np.float32)
    t = dict(
        s_t=torch.from_numpy(np.ascontiguousarray(sqrt_ps.T * np.float32(df))),
        wr=torch.from_numpy(np.ascontiguousarray(W.real)),
        wi=torch.from_numpy(np.ascontiguousarray(W.imag)),
        pm_t=torch.from_numpy(np.ascontiguousarray(pm.T)),
        mix=torch.from_numpy(sd.mixing_matrix(N).copy()))
    return (sqrt_ps, df, W, pm), t


@pytest.mark.parametrize("n", [64, 256])
def test_mixing_matrix_bit_identical(n):
    from fast_tpu.ops import pallas_synth
    np.testing.assert_array_equal(sd.mixing_matrix(n),
                                  pallas_synth._mixing_matrix(n))


@pytest.mark.parametrize("scale", [1.0, 30.0, 1000.0, 4096.0])
def test_plain_sincos_accuracy(scale):
    phi = (np.random.default_rng(7).uniform(-1, 1, 100000)
           * scale).astype(np.float32)
    s, c = sd.sincos(torch.from_numpy(phi))
    p64 = phi.astype(np.float64)
    assert np.abs(s.numpy().astype(np.float64) - np.sin(p64)).max() < 2e-7
    assert np.abs(c.numpy().astype(np.float64) - np.cos(p64)).max() < 2e-7


def test_plain_sincos_quadrant_boundaries():
    phi = (np.arange(-64, 65) * (np.pi / 2)).astype(np.float32)
    s, c = sd.sincos(torch.from_numpy(phi))
    np.testing.assert_allclose(s.numpy(), np.sin(phi.astype(np.float64)),
                               atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.cos(phi.astype(np.float64)),
                               atol=1e-5)


# Random123 known-answer vectors of philox4x32-10
@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, expect):
    c = [torch.tensor(v, dtype=torch.int64) for v in ctr]
    out = sd.philox4x32_10(*c, *key)
    assert tuple(int(o) for o in out) == expect


def test_philox_bits_counter_layout():
    seed = 0x0123_4567_89AB_CDEF
    b1, b2 = sd.philox_bits(seed, 3, 8, stream=5)
    d, e = 2, 8 * 3 + 7
    ref = sd.philox4x32_10(*[torch.tensor(v, dtype=torch.int64)
                             for v in (e, d, 5, 0)],
                           seed & 0xFFFFFFFF, seed >> 32)
    assert int(b1[d, 3, 7]) == int(ref[0])
    assert int(b2[d, 3, 7]) == int(ref[1])
    u = (b1.double() / 2.0 ** 32).numpy()
    assert 0.3 < u.mean() < 0.7 and len(np.unique(b1.numpy())) == b1.numel()


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_plain_matches_pallas_interpret_zero_bits(noise):
    from fast_tpu.ops import pallas_synth
    (sqrt_ps, df, W, pm), t = k2_inputs()
    nbatch = 4
    ref = np.asarray(pallas_synth.fused_synthesis_detect(
        1, sqrt_ps, df, nbatch, W, pm, interpret=True, precision="highest",
        noise=noise))
    zero = torch.zeros((nbatch, 64, 64), dtype=torch.int64)
    got = sd.synth_detect_reference(
        0, t["s_t"], t["wr"], t["wi"], t["pm_t"], nbatch,
        mix=t["mix"] if noise == "mixed" else None, bits=(zero, zero))
    assert got.shape == ref.shape == (2 * nbatch, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


def test_padding_rows_change_nothing():
    _, t = k2_inputs()
    pad = torch.nn.functional.pad
    args = (9, t["s_t"], t["wr"], t["wi"], t["pm_t"], 3)
    padded = (9, t["s_t"], pad(t["wr"], (0, 0, 0, 8)),
              pad(t["wi"], (0, 0, 0, 8)), pad(t["pm_t"], (0, 8, 0, 8)), 3)
    np.testing.assert_allclose(sd.synth_detect_reference(*args).numpy(),
                               sd.synth_detect_reference(*padded).numpy(),
                               rtol=1e-6, atol=1e-4)


def test_plain_draw_offset_continues_the_stream(monkeypatch):
    """Draws [4, 6) from draw0=4 are draws 4 and 5 of one 6-draw call, and
    the plain version's slicing into bounded pieces changes nothing."""
    _, t = k2_inputs()
    args = (0x77, t["s_t"], t["wr"], t["wi"], t["pm_t"])
    full = sd.synth_detect_reference(*args, 6, mix=t["mix"], stream=1)
    head = sd.synth_detect_reference(*args, 4, mix=t["mix"], stream=1)
    tail = sd.synth_detect_reference(*args, 2, mix=t["mix"], stream=1,
                                     draw0=4)
    torch.testing.assert_close(full[:6], torch.cat([head[:4], tail[:2]]),
                               rtol=0, atol=0)
    torch.testing.assert_close(full[6:], torch.cat([head[4:], tail[2:]]),
                               rtol=0, atol=0)
    monkeypatch.setattr(sd, "_REF_POINTS", 2 * 64 * 64)
    torch.testing.assert_close(
        sd.synth_detect_reference(*args, 6, mix=t["mix"], stream=1), full,
        rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu():
    _, t = k2_inputs()
    before = sd.synth_detect.LAUNCHES
    args = (11, t["s_t"], t["wr"], t["wi"], t["pm_t"], 3)
    got = sd.synth_detect(*args, mix=t["mix"], stream=2)
    ref = sd.synth_detect_reference(*args, mix=t["mix"], stream=2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert sd.synth_detect.LAUNCHES == before
    assert torch.isfinite(got).all()


def test_wrapper_checks_inputs():
    _, t = k2_inputs()
    with pytest.raises(ValueError, match="wr"):
        sd.synth_detect(1, t["s_t"], t["wr"][:, :32], t["wi"], t["pm_t"], 2)
    with pytest.raises(TypeError, match="float32"):
        sd.synth_detect(1, t["s_t"].double(), t["wr"], t["wi"], t["pm_t"], 2)
    with pytest.raises(ValueError, match="contiguous"):
        sd.synth_detect(1, t["s_t"].T, t["wr"], t["wi"], t["pm_t"], 2)
    with pytest.raises(ValueError, match="seed"):
        sd.synth_detect(-1, t["s_t"], t["wr"], t["wi"], t["pm_t"], 2)


def test_kernel_shape_rule():
    assert sd.supports(256, 82) and sd.supports(64, 42)
    assert sd.supports(102, 102) and sd.supports(96, 30)  # any grid side
    assert sd.supports(512, 128) and sd.supports(2304, 128)
    # any pupil width: the pupil axis is tiled past 128 px
    assert sd.supports(256, 129) and sd.supports(1024, 402)
    # any grid side with 'mixed' noise too: pass 1 keeps two chunks of
    # uniforms where a grid's do not fit (the first kernel's envelope, 2304
    # px at a 128 px pupil, is gone); pupils up to 255 tiles of 128 px
    assert sd.supports(2368, 402) and sd.supports(4096, 402)
    assert sd.supports(2305, 128) and sd.supports(8192, 128)
    assert sd.supports(64, 255 * 128) and not sd.supports(64, 255 * 128 + 1)
    assert not sd.supports(0, 82) and not sd.supports(256, 0)
    # pupil slices of at most 208 columns a block: two at the 4 m link's
    assert sd._pass1_geom(96) == (96, 1) and sd._pass1_geom(144) == (144, 1)
    assert sd._pass1_geom(416) == (208, 2) and sd._pass1_geom(1040) == (208, 5)
    assert sd.pupil_tiles(128) == 1 and sd.pupil_tiles(416) == 4
    assert sd.draws_per_launch(256, 96) == 4096
    assert sd.draws_per_launch(1024, 416) == 630
    assert sd.draws_per_launch(1024, 416, 8) == 8
    # past 2304 px: 'mixed' keeps two chunks of uniforms, 'gauss' none
    assert sd.supports(2305, 128) and sd.supports(4096, 128)
    for N, P in [(2305, 128), (4096, 128), (4096, 402)]:
        for passes in (1, 3):
            assert sd._smem_bytes(N, P, True, passes) <= 232448
    # the flagship keeps all 8 chunks of its uniforms; the 1024^2 link
    # remakes two for every column tile, and its two slices' blocks make
    # every other x tile for both; 'gauss' keeps two x tiles
    assert sd._smem_bytes(256, 82, True) == 4 * (4 * 4096 + 8192
                                                 + 8 * 4096) + 96
    assert sd._smem_bytes(1024, 402, True) == 4 * (4 * 6656 + 2 * 8192
                                                   + 2 * 4096) + 96
    assert sd._smem_bytes(1024, 402, False) == 4 * (4 * 6656
                                                    + 2 * 8192) + 96
    # one TF32 pass: the hi planes alone, half the words of a ring slot
    assert sd._smem_bytes(256, 82, True, 1) == 4 * (4 * 2048 + 8192
                                                    + 8 * 4096) + 96
    assert sd._smem_bytes(1024, 402, False, 1) == 4 * (4 * 3328
                                                       + 2 * 8192) + 96
    assert sd.padded_pupil(82) == 96 and sd.padded_pupil(96) == 96


# (N, P, noise) shapes that the kernel of the parent design took, among
# them every shape the card tests, chip_smoke.py and the examples run:
# each is still taken, within a block's shared memory
PARENT_SHAPES = [
    (N, P, noise) for N, P, noise in [
        (64, 24, "mixed"), (64, 24, "gauss"), (64, 42, "mixed"),
        (96, 30, "mixed"), (102, 102, "mixed"), (102, 102, "gauss"),
        (128, 82, "mixed"), (192, 144, "mixed"), (192, 144, "gauss"),
        (256, 82, "mixed"), (256, 82, "gauss"), (256, 96, "mixed"),
        (256, 129, "mixed"), (512, 82, "mixed"), (512, 128, "mixed"),
        (1024, 402, "mixed"), (1024, 402, "gauss"), (1024, 416, "mixed"),
        (1600, 32, "mixed"), (1600, 32, "gauss"), (2048, 128, "mixed"),
        (2048, 128, "gauss"), (2304, 128, "mixed"), (2368, 402, "mixed"),
        (4096, 128, "gauss"), (4096, 402, "gauss")]]


@pytest.mark.parametrize("shape", PARENT_SHAPES,
                         ids=lambda s: f"N{s[0]}P{s[1]}{s[2]}")
def test_parent_shapes_still_taken(shape):
    N, P, noise = shape
    assert sd.supports(N, P)
    assert sd._smem_bytes(N, P, noise == "mixed") <= 232448


# (N, P, mixed, TF32 passes) of every route the rule draws a line between
ROUTE_CASES = {
    "ahead": [(256, 82, True, 1), (64, 82, True, 1), (128, 82, True, 1),
              (200, 82, True, 1), (320, 82, True, 1), (256, 96, True, 1),
              (1, 1, True, 1)],
    "inline": [(256, 82, True, 3), (256, 82, False, 1), (1024, 402, True, 1),
               (352, 82, True, 1), (512, 82, True, 1), (2048, 128, True, 1),
               (64, 82, False, 3), (256, 97, True, 1), (256, 112, True, 1),
               (256, 208, True, 1)],
}


@pytest.mark.parametrize("route", sorted(ROUTE_CASES))
def test_pass1_route_rule(route):
    """'ahead' (synth_pass1_ahead) for 'mixed' noise at one TF32 pass over
    one pupil slice of at most 96 columns where every chunk of uniforms
    is kept: the flagship and smaller grids up to 320 px at an 82 px
    pupil; 'inline' at three passes, with 'gauss' noise, over two slices,
    past 320 px, where the uniforms do not fit, and over a slice of more
    than 96 columns."""
    for args in ROUTE_CASES[route]:
        assert sd.pass1_route(*args) == route, args


def test_ahead_smem_fits_wherever_the_rule_takes_it():
    """synth_pass1_ahead's shared memory, as mirrored, within a block's
    wherever pass1_route says 'ahead'; the flagship's: the one-pass ring,
    one x tile, its 8 chunks and two more, 28 mbarriers."""
    ahead = 0
    for N in range(1, 400, 3):
        for P in (1, 16, 24, 42, 82, 96, 128, 144, 200, 208, 209, 402):
            if sd.pass1_route(N, P, True, 1) == "ahead":
                ahead += 1
                assert sd._ahead_smem_bytes(N, P) <= 232448, (N, P)
    assert ahead > 400
    assert sd._ahead_smem_bytes(256, 82) == 4 * (4 * 2048 + 8192
                                                 + 10 * 4096) + 8 * 28


def test_route_counters_count_no_cpu_run():
    """K2's wrappers count launches by route, K7's does not; their plain
    versions on the CPU launch nothing and count nothing."""
    _, t = k2_inputs(16, 3, 9)
    for w in (sd.synth_detect, sd.synth_pass1):
        assert sorted(w.LAUNCHES_BY_ROUTE) == ["ahead", "inline"]
    assert not hasattr(sd.synth_screens, "LAUNCHES_BY_ROUTE")
    before = [dict(w.LAUNCHES_BY_ROUTE)
              for w in (sd.synth_detect, sd.synth_pass1)]
    sd.synth_pass1(5, t["s_t"], t["wr"], t["wi"], 2, mix=t["mix"],
                   precision="default")
    sd.synth_detect(5, t["s_t"], t["wr"], t["wi"], t["pm_t"], 2,
                    mix=t["mix"], precision="default")
    assert [w.LAUNCHES_BY_ROUTE
            for w in (sd.synth_detect, sd.synth_pass1)] == before


def test_fast_logs_its_pass1_route():
    """Fast.pass1_route: None on the CPU, where K2's plain version runs and
    no kernel is launched, and off K2."""
    from fast_tpu_torch import Fast, conf, turbulence_models
    h, cn2, w = turbulence_models.HV57_Bufton_profile(4)
    p = dict(conf.DEFAULTS)
    p.update(NPXLS=64, DX=0.02, NITER=64, NCHUNKS=2, TEMPORAL=False,
             D_GROUND=0.8, DSUBAP=0.1, H_TURB=h, CN2_TURB=cn2, WIND_SPD=w,
             WIND_DIR=np.arange(4) * 90.0, LOGLEVEL="WARNING")
    sim = Fast(p, device="cpu")
    assert sim._synth == "pallas_fused" and sim.pass1_route is None
    assert Fast(dict(p, SYNTH="matmul"), device="cpu").pass1_route is None
    assert Fast(dict(p, TEMPORAL=True, TEMPORAL_SYNTH="ar", DT=0.001),
                device="cpu").pass1_route is None


def _word(col, depth):
    """Word of column ``col`` and depth ``depth`` within an 8-deep step of
    wgmma's B layout (csrc/wgmma.cuh), in the kernel's depth-slot order:
    slot s holds depth 2 (s % 4) + s // 4 (the A fragments' order)."""
    s = (0, 2, 4, 6, 1, 3, 5, 7).index(depth % 8)
    return (col // 8) * 64 + (s // 4) * 32 + (col % 8) * 4 + s % 4


def test_pass1_tables_lay_out_split_operands():
    """Every element of the kernel's tables where pass 1 reads it: W's
    pupil slices (two of 208 columns at 416 px) and the mixing matrix's
    64-column tiles of 32-deep slices, as TF32 hi and lo parts whose sum
    is the element to 22 bits; padding zero."""
    rng = np.random.default_rng(3)
    N, P = 100, 416
    wr, wi, mix = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((P, N), (P, N), (N, N)))
    wpack, mpack = sd.pass1_tables(wr, wi, mix)
    assert wpack.shape == (2, 128 // 8, 4, 8 * 208)
    assert mpack.shape == (2, 4, 4, 2, 512)
    hi, lo = sd._hi_lo(wr)
    for p, d in [(0, 0), (5, 7), (207, 99), (208, 8), (415, 63), (300, 41)]:
        z, c = divmod(p, 208)
        w = wpack[z, d // 8, :, _word(c, d)]
        assert float(w[0]) == float(hi[p, d]) and float(w[1]) == float(lo[p, d])
        assert float(w[2] + w[3]) == pytest.approx(float(wi[p, d]), rel=2e-6)
    assert float(wpack[:, 100 // 8 + 1:].abs().max()) == 0.0  # depth >= 104
    mh, ml = sd._hi_lo(mix)
    for r, c in [(0, 0), (31, 63), (32, 64), (99, 99), (77, 5)]:
        m = mpack[c // 64, r // 32, (r % 32) // 8, :, _word(c % 64, r)]
        assert float(m[0]) == float(mh[r, c]) and float(m[1]) == float(ml[r, c])
    assert float(mpack[:, 3, 1:].abs().max()) == 0.0  # depth >= 104
    assert float((wr - hi - lo).abs().max()) <= 2.0 ** -21 * float(
        wr.abs().max())


def test_pad_pupil_pads_to_the_kernel_width():
    _, t = k2_inputs()
    wr, wi, pm_t = sd.pad_pupil(t["wr"], t["wi"], t["pm_t"])
    assert wr.shape == wi.shape == (32, 64) and pm_t.shape == (32, 32)
    assert wr.is_contiguous() and pm_t.is_contiguous()
    torch.testing.assert_close(pm_t[:24, :24], t["pm_t"], rtol=0, atol=0)
    assert float(pm_t[24:].abs().sum() + wr[24:].abs().sum()) == 0.0
    again = sd.pad_pupil(wr, wi, pm_t)
    assert all(a is b for a, b in zip(again, (wr, wi, pm_t)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


# (N, lo, hi, draws): one launch at 64^2; 4100 draws, two launches with the
# second from draw 4096; a grid side that is no multiple of 64 (the default
# config's 102); a grid whose 'mixed' uniforms take one row per thread; and
# a grid past the first kernel's 2304 px at a 128 px pupil (two chunks of
# 'mixed' uniforms remade for every column tile)
KERNEL_CASES = [(64, 20, 44, 37), (64, 20, 44, 4100), (102, 0, 102, 64),
                (1600, 784, 816, 3), (2432, 1152, 1280, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: f"N{c[0]}x{c[3]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_kernel_matches_plain_on_card(cuda_device, noise, case):
    N, lo, hi, nbatch = case
    _, t = k2_inputs(N, lo, hi, phase_rms=1.5)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    args = (0xABCDEF0123, t["s_t"], t["wr"], t["wi"], t["pm_t"], nbatch)
    mix = t["mix"] if noise == "mixed" else None
    before = sd.synth_detect.LAUNCHES
    got = sd.synth_detect(*args, mix=mix, stream=4)
    ref = sd.synth_detect_reference(*args, mix=mix, stream=4)
    torch.cuda.synchronize()
    assert sd.synth_detect.LAUNCHES == before + -(-nbatch // sd._MAX_DRAWS)
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= KERNEL_REL * float(ref.abs().max())


# (N, lo, hi, draws) of pass 1 alone: 64^2, the default config's 102^2
# (no multiple of 64), the 256^2 flagship's grid at 96 px (one slice of
# the whole pupil, its uniforms kept), the 1024^2 link at 416 px (two
# slices of 208 px in pairs, the uniforms remade) and 320^2 at 240 px
# (pairs over an odd count of column tiles)
PASS1_CASES = [(64, 20, 44, 37), (102, 0, 102, 16), (256, 80, 176, 8),
               (1024, 304, 720, 3), (320, 40, 280, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PASS1_CASES,
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_pass1_matches_plain_on_card(cuda_device, noise, case):
    """G' of pass 1 alone (fast_synth_pass1) against its plain version,
    element by element, within GPRIME_REL N 2^-24 max |G'|."""
    N, lo, hi, nbatch = case
    _, t = k2_inputs(N, lo, hi, phase_rms=1.5)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    mix = t["mix"] if noise == "mixed" else None
    args = (0xABCDEF0123, t["s_t"], t["wr"], t["wi"], nbatch)
    before = sd.synth_pass1.LAUNCHES
    gr, gi = sd.synth_pass1(*args, mix=mix, stream=4, draw0=5)
    wr, wi, _ = sd.pad_pupil(t["wr"], t["wi"], None)
    rr, ri = sd.synth_pass1_reference(*((args[0], t["s_t"], wr, wi)
                                        + args[4:]),
                                      mix=mix, stream=4, draw0=5)
    torch.cuda.synchronize()
    assert sd.synth_pass1.LAUNCHES == before + 1
    assert gr.shape == gi.shape == rr.shape == (nbatch, N, wr.shape[0])
    assert bool(torch.isfinite(gr).all() and torch.isfinite(gi).all())
    top = max(float(rr.abs().max()), float(ri.abs().max()))
    err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
    assert err <= GPRIME_REL * N * 2.0 ** -24 * top


def tf32_distance_readings(got, plain1, plain3):
    """(max, rms) of |got - plain1| over those of |plain1 - plain3| (the
    TF32 distance), tensors or tuples of them."""
    from test_torch_tf32x3 import tf32_readings
    many = [(x,) if torch.is_tensor(x) else tuple(x)
            for x in (got, plain1, plain3)]
    return tf32_readings(*many)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(256, 87, 169, 64), (1024, 311, 713, 4),
                                  (2432, 1152, 1280, 2)],
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_passes_at_default_match_plain_on_card(cuda_device, noise, case):
    """At PRECISION='default': pass 1 (its one-pass instantiation, counted
    in LAUNCHES_BY_PASSES[1]) within ONE_PASS_MAX and ONE_PASS_RMS of the
    TF32 distance of its plain version at 'default'; the detect pass and
    K7's screens pass on that same G' within the 3xTF32 limits."""
    from fast_tpu_torch.ops import colfac_detect as cd
    from test_torch_tf32x3 import ONE_PASS_MAX, ONE_PASS_RMS
    N, lo, hi, nbatch = case
    _, t = k2_inputs(N, lo, hi, phase_rms=1.5)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    mix = t["mix"] if noise == "mixed" else None
    wr, wi, pm_t = sd.pad_pupil(t["wr"], t["wi"], t["pm_t"])
    laid = sd.laid_w(t["wr"], t["wi"], mix, precision="default")
    before = sd.synth_pass1.LAUNCHES_BY_PASSES[1]
    g = sd.synth_pass1(0xABCDEF0123, t["s_t"], t["wr"], t["wi"], nbatch,
                       mix=mix, stream=4, laid=laid, precision="default")
    p1, p3 = (sd.synth_pass1_reference(0xABCDEF0123, t["s_t"], wr, wi,
                                       nbatch, mix=mix, stream=4,
                                       precision=p)
              for p in ("default", "highest"))
    torch.cuda.synchronize()
    assert sd.synth_pass1.LAUNCHES_BY_PASSES[1] == before + 1
    mx, rms = tf32_distance_readings(g, p1, p3)
    assert mx <= ONE_PASS_MAX and rms <= ONE_PASS_RMS
    got = cd.detect_pass(*g, wr, wi, pm_t, laid=laid, precision="default")
    ref = sd.detect_reference(*g, wr, wi, pm_t, precision="default")
    assert float((got - ref).abs().max()) <= KERNEL_REL * float(
        ref.abs().max())
    if mix is None:
        npup = hi - lo
        got = sd.screens_pass(*g, wr, wi, npup, laid=laid,
                              precision="default")
        ref = sd.screens_pass_reference(*g, wr, wi, npup,
                                        precision="default")
        assert float((got - ref).abs().max()) <= 2 * N * 2.0 ** -24 * float(
            ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_kernel_at_default_matches_plain_on_card(cuda_device, noise):
    """K2 whole at PRECISION='default', two launches, against its plain
    version at 'default', in units of the TF32 distance; the engine's laid
    table at 'default' holds the hi planes alone and lays the 3xTF32 ones
    at their first use."""
    from test_torch_tf32x3 import ONE_PASS_MAX, ONE_PASS_RMS
    _, t = k2_inputs(64, 20, 44, phase_rms=1.5)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    mix = t["mix"] if noise == "mixed" else None
    laid = sd.laid_w(t["wr"], t["wi"], mix, precision="default")
    assert laid.wpack.shape[2] == 2 and laid.tables(3)[0].shape[2] == 4
    args = (0xABCDEF0123, t["s_t"], t["wr"], t["wi"], t["pm_t"], 4100)
    before = dict(sd.synth_detect.LAUNCHES_BY_PASSES)
    got = sd.synth_detect(*args, mix=mix, stream=4, laid=laid,
                          precision="default")
    p1, p3 = (sd.synth_detect_reference(*args, mix=mix, stream=4,
                                        precision=p)
              for p in ("default", "highest"))
    torch.cuda.synchronize()
    assert sd.synth_detect.LAUNCHES_BY_PASSES == {
        1: before[1] + 2, 3: before[3]}
    mx, rms = tf32_distance_readings(got, p1, p3)
    assert mx <= ONE_PASS_MAX and rms <= ONE_PASS_RMS


# (N, lo, hi) of the 'ahead' pass 1 at an 82 px pupil: a grid narrower
# than the pupil (one column tile, one row tile), one that is no multiple
# of 64 (ragged row and column tiles) and the flagship's
AHEAD_GRIDS = [(64, 0, 82), (200, 59, 141), (256, 87, 169)]


@pytest.mark.cuda
@pytest.mark.parametrize("nbatch", [1, 131, 4096])
@pytest.mark.parametrize("grid", AHEAD_GRIDS, ids=lambda g: f"N{g[0]}")
def test_ahead_pass1_matches_plain_on_card(cuda_device, grid, nbatch):
    """synth_pass1_ahead ('mixed', one TF32 pass; pass1_route 'ahead')
    within ONE_PASS_MAX and ONE_PASS_RMS of the TF32 distance of its plain
    version at 'default', for a draw alone, an odd count that leaves SMs
    idle and tiles ragged, and a whole launch; counted as 'ahead'."""
    from test_torch_tf32x3 import ONE_PASS_MAX, ONE_PASS_RMS
    N, lo, hi = grid
    assert sd.pass1_route(N, hi - lo, True, 1) == "ahead"
    _, t = k2_inputs(N, lo, hi, phase_rms=1.5)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    wr, wi, _ = sd.pad_pupil(t["wr"], t["wi"], None)
    laid = sd.laid_w(t["wr"], t["wi"], t["mix"], precision="default")
    before = dict(sd.synth_pass1.LAUNCHES_BY_ROUTE)
    g = sd.synth_pass1(0xABCDEF0123, t["s_t"], t["wr"], t["wi"], nbatch,
                       mix=t["mix"], stream=4, draw0=7, laid=laid,
                       precision="default")
    p1, p3 = (sd.synth_pass1_reference(0xABCDEF0123, t["s_t"], wr, wi,
                                       nbatch, mix=t["mix"], stream=4,
                                       draw0=7, precision=p)
              for p in ("default", "highest"))
    torch.cuda.synchronize()
    assert sd.synth_pass1.LAUNCHES_BY_ROUTE == {
        "ahead": before["ahead"] + 1, "inline": before["inline"]}
    assert bool(torch.isfinite(g[0]).all() and torch.isfinite(g[1]).all())
    mx, rms = tf32_distance_readings(g, p1, p3)
    assert mx <= ONE_PASS_MAX and rms <= ONE_PASS_RMS


@pytest.mark.cuda
def test_pass1_route_mirrors_the_library_on_card(cuda_device):
    """pass1_route, the Python mirror, says what the library's own rule
    (fast_pass1_ahead, dispatch_pass1's) says, at the rule's cases and
    over a grid of shapes."""
    lib, _ = sd._library()
    cases = [c for cs in ROUTE_CASES.values() for c in cs]
    cases += [(N, P, m, n) for N in range(1, 400, 7)
              for P in (1, 16, 42, 82, 96, 112, 113, 144, 208, 209, 402)
              for m in (True, False) for n in (1, 3)]
    for N, P, m, n in cases:
        Pp = sd.padded_pupil(P)
        assert sd._launch_route(lib, N, Pp, m, n) == sd.pass1_route(
            N, P, m, n), (N, P, m, n)


@pytest.mark.cuda
def test_ahead_walk_changes_no_draw_on_card(cuda_device):
    """Draw j of a 4096-draw launch of synth_pass1_ahead, whose blocks
    walk many (draw, row) tiles each, equals bit for bit that draw
    launched alone from draw0 = j, whose blocks take one tile each."""
    N, lo, hi = AHEAD_GRIDS[-1]
    _, t = k2_inputs(N, lo, hi, phase_rms=1.5)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    laid = sd.laid_w(t["wr"], t["wi"], t["mix"], precision="default")
    kw = dict(mix=t["mix"], stream=4, laid=laid, precision="default")
    args = (0xABCDEF0123, t["s_t"], t["wr"], t["wi"])
    gr, gi = sd.synth_pass1(*args, 4096, **kw)
    for j in (0, 1, 131, 132, 2047, 4095):
        ar, ai = sd.synth_pass1(*args, 1, draw0=j, **kw)
        assert torch.equal(gr[j], ar[0]) and torch.equal(gi[j], ai[0]), j


@pytest.mark.cuda
def test_flagship_run_takes_the_ahead_route_on_card(cuda_device):
    """A run() of the 256^2 flagship at its PRECISION 'default' launches
    K2 through synth_pass1_ahead alone: Fast.pass1_route 'ahead', one
    'ahead' launch a chunk."""
    from fast_tpu_torch import Fast, conf, turbulence_models
    h, cn2, w = turbulence_models.HV57_Bufton_profile(4)
    p = dict(conf.DEFAULTS)
    p.update(NPXLS=256, DX=0.01, NITER=32768, NCHUNKS=4, TEMPORAL=False,
             D_GROUND=0.8, WVL=1550e-9, ZENITH_ANGLE=55, AO_MODE="AO",
             DSUBAP=0.1, TLOOP=0.001, TEXP=0.001, ALIAS=True, H_TURB=h,
             CN2_TURB=cn2, WIND_SPD=w, WIND_DIR=np.arange(4) * 90.0,
             SEED=1, LOGLEVEL="WARNING")
    sim = Fast(p, device="cuda")
    assert sim._synth == "pallas_fused" and sim.pass1_route == "ahead"
    before = dict(sd.synth_detect.LAUNCHES_BY_ROUTE)
    r = sim.run()
    torch.cuda.synchronize()
    assert sd.synth_detect.LAUNCHES_BY_ROUTE == {
        "ahead": before["ahead"] + 4, "inline": before["inline"]}
    assert np.isfinite(np.asarray(r.power)).all()
