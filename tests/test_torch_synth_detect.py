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
    assert sd.supports(2368, 402) and not sd.supports(4096, 402)
    assert sd._rows_per_thread(1024, 402, True) == 2
    assert sd._pass1_geom(96) == (6, 1, 1) and sd._pass1_geom(144) == (3, 4, 1)
    assert sd._pass1_geom(416) == (7, 4, 1) and sd._pass1_geom(1040) == (6, 4, 3)
    assert sd.pupil_tiles(128) == 1 and sd.pupil_tiles(416) == 4
    assert sd.draws_per_launch(256, 96) == 4096
    assert sd.draws_per_launch(1024, 416) == 630
    assert sd.draws_per_launch(1024, 416, 8) == 8
    # 16 rows of 'mixed' uniforms overflow shared memory; 'gauss' keeps none
    assert not sd.supports(2305, 128) and sd.supports(4096, 128, mixed=False)
    assert sd._rows_per_thread(256, 82, True) == 2
    assert sd._rows_per_thread(2048, 128, True) == 1
    assert sd._rows_per_thread(2048, 128, False) == 2
    assert sd.padded_pupil(82) == 96 and sd.padded_pupil(96) == 96


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
# config's 102); a grid whose 'mixed' uniforms take one row per thread
KERNEL_CASES = [(64, 20, 44, 37), (64, 20, 44, 4100), (102, 0, 102, 64),
                (1600, 784, 816, 3)]


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
# (no multiple of 64), the 256^2 flagship's grid at 96 px (one group of
# the whole pupil) and the 1024^2 link at 416 px (four column groups)
PASS1_CASES = [(64, 20, 44, 37), (102, 0, 102, 16), (256, 80, 176, 8),
               (1024, 304, 720, 3)]


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
