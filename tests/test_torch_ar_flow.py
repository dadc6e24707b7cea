"""K4 and K5 of fast_tpu_torch (``ops/ar_flow``) against fast_tpu.

* The plain versions against ``pallas_synth.ar_flow_fused`` and
  ``ar_flow_streamed`` in the Pallas interpreter (``precision="highest"``),
  as ``tests/test_pallas.py`` runs them: pure frozen flow, and boiling with
  the interpreter's zero random bits for 'uniform' and 'gauss'. Couplings
  to 2e-4 of the largest |sum| (float32 products in another order; the JAX
  tests use rtol = atol = 5e-3), the final state to 2e-6 absolute on states
  of order 0.05 (the interpreter contracts the update differently; the JAX
  tests use 2e-4).
* The plain version with its own Philox bits against a float64 numpy
  evaluation of the definition (1e-3 of the largest |sum|: float32
  recurrence over 8 steps and float32 products).
* A series cut into calls is the same series, bit for bit (the counter
  holds the absolute step; one Philox call serves a pair of steps, and
  ``ar_bits`` at an even and an odd step are its four words).
* On the card, the kernels against the plain version from identical bits:
  state bit for bit, couplings within KERNEL_REL of the largest |sum|, at
  pupils of up to 128 px and at 144 and 402 px, K6 at 16 series from an
  odd step, K5's layer blocks against each other, the laid W table
  against the per-call one; their two DFT products alone (``ar_dft`` and
  ``ar_detect``, the second pass of ``csrc/detect.cuh``) against their
  plain versions, G' element by element within N 2^-24 max |G'|.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_ar_flow.py -m cuda
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch import synthesis as ts
from fast_tpu_torch.ops import ar_flow as af

torch.set_num_threads(1)

KERNEL_REL = 4e-6
SEED = 0xABCDEF0123


def ar_inputs(L=2, N=64, lo=20, hi=44, seed=6, boiling=False, alpha=0.9,
              scale=0.02, ns_scale=None):
    """Numpy inputs of one series: state of about ``scale`` per mode (a
    screen of a few radians at 64^2), random unit phasors times ``alpha``
    if boiling, a noise scale of up to ``ns_scale`` (default ``scale /
    2``), the pruned DFT matrix and a pupil * mode."""
    npup = hi - lo
    rng = np.random.default_rng(seed)
    a0 = (scale * (rng.normal(size=(L, N, N))
                   + 1j * rng.normal(size=(L, N, N)))).astype(np.complex64)
    ph = np.exp(1j * rng.uniform(-3, 3, (L, N, N)))
    ph = ((alpha if boiling else 1.0) * ph).astype(np.complex64)
    ns_scale = scale / 2 if ns_scale is None else ns_scale
    ns = ((ns_scale * rng.random((L, N, N))).astype(np.float32)
          if boiling else None)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    pm = rng.random((npup, npup)).astype(np.float32)
    return a0, ph, ns, W, pm


def tensors(inputs, device="cpu"):
    return tuple(None if x is None else torch.from_numpy(x).to(device)
                 for x in inputs)


def definition_numpy(a0, ph, ns, W, pm, nsteps, z=None):
    """The series from its definition in float64 numpy; ``z`` (nsteps, L,
    N, N) complex noise."""
    a = a0.astype(np.complex128)
    W = W.astype(np.complex128)
    out = np.zeros((nsteps, 2))
    for t in range(nsteps):
        a = ph.astype(np.complex128) * a
        if ns is not None:
            a = a + z[t] * ns
        phi = (W @ a.sum(0) @ W.T).real
        out[t] = (pm * np.cos(phi)).sum(), (pm * np.sin(phi)).sum()
    return out, a


# --------------------------------------------------------------------------
# (a) the plain versions against the TPU kernels in the Pallas interpreter
# --------------------------------------------------------------------------


JAX_ENTRIES = {"fused": "ar_flow_fused", "streamed": "ar_flow_streamed"}
CASES = [(None, 2), ("uniform", 2), ("gauss", 2), (None, 3)]


@pytest.mark.parametrize("noise,L", CASES,
                         ids=lambda v: str(v) if v is None else None)
@pytest.mark.parametrize("entry", ["fused", "streamed"])
def test_plain_matches_pallas_interpret(entry, noise, L):
    import jax.numpy as jnp
    from fast_tpu.ops import pallas_synth

    nsteps = 8
    a0, ph, ns, W, pm = inp = ar_inputs(L=L, seed=7 + L,
                                        boiling=noise is not None)
    c_ref, a_ref = getattr(pallas_synth, JAX_ENTRIES[entry])(
        1, jnp.asarray(a0), jnp.asarray(ph),
        None if ns is None else jnp.asarray(ns), W, pm, nsteps,
        interpret=True, precision="highest", noise=noise or "uniform")
    c_ref, a_ref = np.asarray(c_ref), np.asarray(a_ref)
    fn = af.ar_flow_fused if entry == "fused" else af.ar_flow_streamed
    # the wrappers run the plain version on CPU tensors; zero bits need it
    # called directly
    if noise is None:
        c, a = fn(1, *tensors(inp), nsteps)
    else:
        c, a = af.ar_flow_reference(1, *tensors(inp), nsteps, noise=noise,
                                    bits="zero")
    assert c.shape == (nsteps, 2) and c.dtype == torch.float32
    assert a.shape == a0.shape and a.dtype == torch.complex64
    assert np.abs(c.numpy() - c_ref).max() <= 2e-4 * np.abs(c_ref).max()
    assert np.abs(a.numpy() - a_ref).max() <= 2e-6


@pytest.mark.parametrize("noise", [None, "uniform", "gauss"])
def test_plain_matches_definition_with_philox_bits(noise):
    nsteps, L, N = 8, 3, 64
    a0, ph, ns, W, pm = inp = ar_inputs(L=L, seed=3, boiling=noise is not None)
    z = None
    if noise is not None:
        b1, b2 = (b.numpy() >> 8 for b in af.ar_bits(SEED, 5, nsteps, L, N))
        if noise == "uniform":
            s3 = np.sqrt(3.0)
            z = ((b1 * (s3 * 2.0 ** -23) - s3)
                 + 1j * (b2 * (s3 * 2.0 ** -23) - s3))
        else:
            r = np.sqrt(-2 * np.log(b1 * 2.0 ** -24 + 2.0 ** -25))
            z = r * np.exp(2j * np.pi * (b2 * 2.0 ** -24))
        assert abs(z.real.var() - 1) < 0.02 and abs(z.imag.var() - 1) < 0.02
    ref, a_ref = definition_numpy(a0, ph, ns, W, pm, nsteps, z)
    c, a = af.ar_flow_reference(SEED, *tensors(inp), nsteps,
                                noise=noise or "uniform", step0=5)
    assert np.abs(c.numpy() - ref).max() <= 1e-3 * np.abs(ref).max()
    assert np.abs(a.numpy() - a_ref).max() <= 1e-6


@pytest.mark.parametrize("noise", [None, "uniform", "gauss"])
@pytest.mark.parametrize("entry", ["fused", "streamed"])
def test_series_cut_into_calls_is_the_same_series(entry, noise):
    """5 + 3 steps with the state carried and step0 = 5 equal 8 steps, and
    so do two launches of the wrapper's own cut (max_steps)."""
    fn = af.ar_flow_fused if entry == "fused" else af.ar_flow_streamed
    a0, ph, ns, W, pm = t = tensors(ar_inputs(L=3, seed=4,
                                              boiling=noise is not None))
    kw = {"noise": noise or "uniform"}
    c8, a8 = fn(SEED, *t, 8, **kw)
    c5, a5 = fn(SEED, *t, 5, **kw)
    c3, a3 = fn(SEED, a5, ph, ns, W, pm, 3, step0=5, **kw)
    assert torch.equal(torch.cat([c5, c3]), c8) and torch.equal(a3, a8)
    cm, am = fn(SEED, *t, 8, max_steps=3, **kw)
    assert torch.equal(cm, c8) and torch.equal(am, a8)
    assert torch.equal(a0, t[0])  # the caller's state is not advanced


def test_fused_and_streamed_agree_and_count_nothing_on_cpu():
    t = tensors(ar_inputs(L=3, seed=8, boiling=True))
    before = af.ar_flow_fused.LAUNCHES, af.ar_flow_streamed.LAUNCHES
    cf, af_ = af.ar_flow_fused(SEED, *t, 6, noise="gauss")
    for lb in (1, 2, 4):
        cs, as_ = af.ar_flow_streamed(SEED, *t, 6, noise="gauss",
                                      lb_layers=lb)
        assert torch.equal(cs, cf) and torch.equal(as_, af_)
    assert (af.ar_flow_fused.LAUNCHES,
            af.ar_flow_streamed.LAUNCHES) == before


@pytest.mark.parametrize("step", [6, 7])
def test_one_philox_call_serves_a_pair_of_steps(step):
    """ar_bits at an even step is words 0 and 1 of the call on counter
    (mode, row, step // 2, 2), at the odd step after it words 2 and 3 of
    the same call; a call from the odd step draws that call's second
    half."""
    from fast_tpu_torch.ops.synth_detect import _key, philox4x32_10
    L, N = 2, 8
    k0, k1 = _key(SEED)
    e = torch.arange(N * N, dtype=torch.int64)[None, :]
    row = torch.arange(L, dtype=torch.int64)[:, None]
    words = philox4x32_10(e, row, torch.full((), step // 2),
                          torch.full((), 2), k0, k1)
    b1, b2 = af.ar_bits(SEED, step, 1, L, N)
    lo = 2 * (step % 2)
    assert torch.equal(b1[0].reshape(L, -1), words[lo].expand(L, -1))
    assert torch.equal(b2[0].reshape(L, -1), words[lo + 1].expand(L, -1))
    both = af.ar_bits(SEED, 6, 2, L, N)
    assert torch.equal(both[0][step - 6], b1[0])
    assert torch.equal(both[1][step - 6], b2[0])


def test_noise_stream_is_the_kernels_noise():
    L, N = 2, 16
    z1, z2 = af.ar_noise(SEED, 3, 6, L, N, "gauss")
    stream = af.NoiseStream(SEED, L, N, end=9, noise="gauss",
                            dtype=torch.complex128)
    for i, step in enumerate(range(3, 9)):
        z = stream(step)
        assert z.dtype == torch.complex128 and z.shape == (L, N, N)
        assert torch.equal(z.real.float(), z1[i])
        assert torch.equal(z.imag.float(), z2[i])
    # zero bits: the constants the Pallas interpreter's PRNG gives
    u1, u2 = af.ar_noise(0, 0, 1, 1, 4, "uniform", bits="zero")
    assert torch.all(u1 == -np.float32(np.sqrt(3.0))) and torch.equal(u1, u2)
    g1, g2 = af.ar_noise(0, 0, 1, 1, 4, "gauss", bits="zero")
    np.testing.assert_allclose(g1.numpy(), np.sqrt(50 * np.log(2)), rtol=1e-6)
    assert torch.all(g2 == 0)


def test_the_rule_and_what_the_wrappers_refuse():
    assert af.select(4) is af.ar_flow_fused
    assert af.select(af.FUSED_MAX_LAYERS) is af.ar_flow_fused
    assert af.select(16) is af.ar_flow_streamed
    # any pupil the detect pass's tiles cover (a 402 px pupil since K6's
    # slice; 128 px was the limit before)
    assert af.supports(256, 82) and af.supports(1024, 402)
    assert not af.supports(1024, 40000) and not af.supports(40000, 82)
    assert af.tile_steps(256) == 1024 and af.tile_steps(512) == 256
    assert af.tile_steps(256, 96, nseries=16) == 64
    assert af.tile_steps(1024, 416) == 64 and af.tile_steps(2048, 416) == 16
    t = tensors(ar_inputs(L=9, N=16, lo=4, hi=12))
    with pytest.raises(ValueError, match="ar_flow_streamed"):
        af.ar_flow_fused(1, *t, 2)
    c, a = af.ar_flow_streamed(1, *t, 2)
    assert c.shape == (2, 2) and a.shape == (9, 16, 16)
    with pytest.raises(ValueError, match="noise"):
        af.ar_flow_streamed(1, *t, 2, noise="banana")
    with pytest.raises(ValueError, match="lb_layers"):
        af.ar_flow_streamed(1, *t, 2, lb_layers=9)
    with pytest.raises(ValueError, match="complex"):
        af.ar_flow_streamed(1, t[0].real, *t[1:], 2)


def test_first_product_alone_on_cpu_is_the_plain_version():
    """ar_dft on CPU tensors: the plain G' = A^T W^T with the pupil axis
    padded to 16 (zero columns), no launch counted; shapes checked."""
    rng = np.random.default_rng(13)
    a = torch.from_numpy(rng.normal(size=(2, 3, 32, 32)).astype(np.float32))
    W = ts.pruned_ift2_matrix(32, 4, 26, dtype=np.complex64)
    wr, wi = torch.from_numpy(W.real.copy()), torch.from_numpy(W.imag.copy())
    before = af.ar_dft.LAUNCHES
    gr, gi = af.ar_dft(a[0], a[1], wr, wi)
    assert af.ar_dft.LAUNCHES == before
    assert gr.shape == gi.shape == (3, 32, 32)
    rr, ri = af.ar_dft_reference(a[0], a[1], wr, wi)
    assert torch.equal(gr[..., :22], rr) and torch.equal(gi[..., :22], ri)
    assert not gr[..., 22:].any() and not gi[..., 22:].any()
    with pytest.raises(ValueError, match="nj, N, N"):
        af.ar_dft(a[0, 0], a[1, 0], wr, wi)
    with pytest.raises(ValueError, match="npup"):
        af.ar_dft(a[0], a[1], wr[:, :16], wi[:, :16])


def test_detect_alone_on_cpu_is_the_plain_version():
    """ar_detect on CPU tensors: the plain detect of each pair's G' with
    the pupil * mode of series j % B, no launch counted; it takes the laid
    W table and refuses one of another W."""
    from fast_tpu_torch.ops.synth_detect import laid_w, pad_pupil
    rng = np.random.default_rng(15)
    N, lo, hi, B, nt = 32, 4, 26, 3, 2
    a = torch.from_numpy(rng.normal(size=(2, nt * B, N, N)).astype(
        np.float32))
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    wr, wi = torch.from_numpy(W.real.copy()), torch.from_numpy(W.imag.copy())
    pm = torch.from_numpy(rng.random((B, hi - lo, hi - lo)).astype(
        np.float32))
    wrp, wip, pm_t = pad_pupil(wr, wi, pm.transpose(-2, -1).contiguous())
    gr, gi = af.ar_dft(a[0], a[1], wr, wi)
    before = af.ar_detect.LAUNCHES
    got = af.ar_detect(gr, gi, wr, wi, pm_t, laid=laid_w(wr, wi))
    assert af.ar_detect.LAUNCHES == before and got.shape == (nt * B, 2)
    ref = af.detect_real_reference(a[0].view(nt, B, N, N),
                                   a[1].view(nt, B, N, N), wrp, wip, pm_t)
    assert torch.equal(got, ref.reshape(nt * B, 2))
    with pytest.raises(ValueError, match="dividing"):
        af.ar_detect(gr[:5], gi[:5], wr, wi, pm_t)
    with pytest.raises(ValueError, match="table of"):
        af.ar_detect(gr, gi, wr, wi, pm_t, laid=laid_w(wr[:8], wi[:8]))


# --------------------------------------------------------------------------
# (f) on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


# (entry, L, N, lo, hi, steps, max_steps): two launches with the state
# carried; a grid side that is no multiple of 32 with its pupil as wide as
# the grid; more layers than the fused kernel holds (streamed only); a
# 144 px pupil (one W slice) and the 4 m link's 402 px pupil (two slices
# of 208 px)
KERNEL_CASES = [(d, *c) for d in ("fused", "streamed")
                for c in [(3, 64, 20, 44, 300, 256), (2, 102, 0, 102, 40, 4096),
                          (3, 192, 24, 168, 40, 4096),
                          (2, 1024, 311, 713, 6, 4096)]
                ] + [("streamed", 10, 64, 20, 44, 40, 4096),
                     ("streamed", 10, 192, 24, 168, 20, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: f"{c[0]}-L{c[1]}N{c[2]}x{c[5]}")
@pytest.mark.parametrize("noise", [None, "uniform", "gauss"])
def test_kernel_matches_plain_on_card(cuda_device, noise, case):
    entry, L, N, lo, hi, nsteps, max_steps = case
    fn = af.ar_flow_fused if entry == "fused" else af.ar_flow_streamed
    # white-spectrum states and noise sized to screens of about a radian
    # past 128^2 (the sums' round-off grows with the phase times sqrt(N),
    # and the limit is set for the screens the engine makes)
    scale, ns_scale = (0.02, 0.01) if N <= 128 else (0.5 / N, 0.07 / N)
    t = tensors(ar_inputs(L=L, N=N, lo=lo, hi=hi, seed=9,
                          boiling=noise is not None, alpha=0.99,
                          scale=scale, ns_scale=ns_scale), cuda_device)
    kw = {"noise": noise or "uniform", "step0": 7}
    before = fn.LAUNCHES
    c, a = fn(SEED, *t, nsteps, max_steps=max_steps, **kw)
    c_ref, a_ref = af.ar_flow_reference(SEED, *t, nsteps, **kw)
    torch.cuda.synchronize()
    assert fn.LAUNCHES == before + -(-nsteps // max_steps)
    assert bool(torch.isfinite(c).all())
    assert torch.equal(a, a_ref)
    err = float((c - c_ref).abs().max())
    assert err <= KERNEL_REL * float(c_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [None, "uniform", "gauss"])
def test_streamed_equals_fused_on_card(cuda_device, noise):
    t = tensors(ar_inputs(L=4, seed=10, boiling=noise is not None),
                cuda_device)
    kw = {"noise": noise or "uniform"}
    cf, af_ = af.ar_flow_fused(SEED, *t, 70, **kw)
    for lb in (1, 3):
        cs, as_ = af.ar_flow_streamed(SEED, *t, 70, lb_layers=lb, **kw)
        assert torch.equal(cs, cf) and torch.equal(as_, af_)


GPRIME_REL = 1.0  # G' element by element, times N 2^-24 max |G'|


# (N, lo, hi, pairs): the flagships' 82 px pupil (padded to 96, one column
# group) at 256^2 over one tile; a 144 px pupil at 192^2 (two groups of 80
# px, the second ragged); a grid side that is no multiple of 4 or of 128
@pytest.mark.cuda
@pytest.mark.parametrize("case", [(256, 87, 169, 256), (192, 24, 168, 40),
                                  (102, 0, 102, 9)],
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_first_product_matches_plain_on_card(cuda_device, case):
    """ar_dft alone (fast_ar_dft: W split, then 3xTF32 on the tensor
    cores) against the plain G' = A^T W^T element by element, within
    GPRIME_REL N 2^-24 max |G'|."""
    N, lo, hi, nj = case
    rng = np.random.default_rng(14)
    a = torch.from_numpy((rng.normal(size=(2, nj, N, N)) * 0.5 / N)
                         .astype(np.float32)).to(cuda_device)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    wr = torch.from_numpy(W.real.copy()).to(cuda_device)
    wi = torch.from_numpy(W.imag.copy()).to(cuda_device)
    before = af.ar_dft.LAUNCHES
    gr, gi = af.ar_dft(a[0], a[1], wr, wi)
    from fast_tpu_torch.ops.synth_detect import pad_pupil
    wrp, wip, _ = pad_pupil(wr, wi, None)
    rr, ri = af.ar_dft_reference(a[0], a[1], wrp, wip)
    torch.cuda.synchronize()
    assert af.ar_dft.LAUNCHES == before + 1
    assert gr.shape == gi.shape == rr.shape == (nj, N, wrp.shape[0])
    assert bool(torch.isfinite(gr).all() and torch.isfinite(gi).all())
    top = max(float(rr.abs().max()), float(ri.abs().max()))
    err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
    assert err <= GPRIME_REL * N * 2.0 ** -24 * top


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(256, 87, 169, 37), (192, 24, 168, 7),
                                  (1024, 311, 713, 5)],
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_detect_alone_matches_plain_on_card(cuda_device, case):
    """ar_detect alone (the second pass, real part only, two row groups a
    block of work) against its plain version on the same G', within
    KERNEL_REL of the largest |sum|; two launches give the same bits and
    the laid table the per-call one's. Pair counts leave the last block
    of work part empty."""
    from fast_tpu_torch.ops.synth_detect import laid_w, pad_pupil
    N, lo, hi, nj = case
    B = nj if nj < 16 else 1
    rng = np.random.default_rng(16)
    a = torch.from_numpy((rng.normal(size=(2, nj, N, N)) * 0.5 / N)
                         .astype(np.float32)).to(cuda_device)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    wr = torch.from_numpy(W.real.copy()).to(cuda_device)
    wi = torch.from_numpy(W.imag.copy()).to(cuda_device)
    pm = torch.from_numpy(rng.random((B, hi - lo, hi - lo)).astype(
        np.float32)).to(cuda_device)
    wrp, wip, pm_t = pad_pupil(wr, wi, pm.transpose(-2, -1).contiguous())
    gr, gi = af.ar_dft_reference(a[0], a[1], wrp, wip)
    laid = laid_w(wr, wi)
    before = af.ar_detect.LAUNCHES
    got = af.ar_detect(gr, gi, wr, wi, pm_t, laid=laid)
    again = af.ar_detect(gr, gi, wr, wi, pm_t, laid=laid)
    fresh = af.ar_detect(gr, gi, wr, wi, pm_t)
    ref = af.ar_detect_reference(gr.view(-1, B, N, wrp.shape[0]),
                                 gi.view(-1, B, N, wrp.shape[0]), wrp, wip,
                                 pm_t).reshape(nj, 2)
    torch.cuda.synchronize()
    assert af.ar_detect.LAUNCHES == before + 3
    assert got.shape == (nj, 2) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again) and torch.equal(got, fresh)
    assert float((got - ref).abs().max()) <= KERNEL_REL * float(
        ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", ["uniform", "gauss"])
def test_k6_at_16_series_from_an_odd_step_on_card(cuda_device, noise):
    """K6 at the temporal orbit pass's 16 series, from the odd step 3, in
    launches of 11 steps (each from another parity), against its plain
    version: states bit for bit, sums within KERNEL_REL."""
    rng = np.random.default_rng(17)
    B, L, N, lo, hi = 16, 4, 64, 20, 44
    one = [ar_inputs(L=L, N=N, lo=lo, hi=hi, seed=20 + s, boiling=True,
                     alpha=0.99) for s in range(B)]
    a0, ph, ns = (np.stack([x[i] for x in one]) for i in range(3))
    W = one[0][3]
    pm = rng.random((B, hi - lo, hi - lo)).astype(np.float32)
    t = tensors((a0, ph, ns, W, pm), cuda_device)
    kw = {"noise": noise, "step0": 3}
    before = af.ar_flow_fused_batch.LAUNCHES
    c, a = af.ar_flow_fused_batch(SEED, *t, 37, max_steps=11, **kw)
    c_ref, a_ref = af.ar_flow_batch_reference(SEED, *t, 37, **kw)
    torch.cuda.synchronize()
    assert af.ar_flow_fused_batch.LAUNCHES == before + 4
    assert c.shape == (37, B, 2) and bool(torch.isfinite(c).all())
    assert torch.equal(a, a_ref)
    assert float((c - c_ref).abs().max()) <= KERNEL_REL * float(
        c_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [None, "uniform", "gauss"])
def test_streamed_layer_blocks_agree_on_card(cuda_device, noise):
    """K5 at 16 layers in its default layer block against blocks of 1, 4
    and 8 (the widest): the same layer sums (every layer added singly, in
    layer order), so states and sums bit for bit."""
    t = tensors(ar_inputs(L=16, N=64, seed=18, boiling=noise is not None,
                          alpha=0.99), cuda_device)
    kw = {"noise": noise or "uniform", "step0": 5}
    cd_, ad = af.ar_flow_streamed(SEED, *t, 41, **kw)
    for lb in (1, 4, 8):
        cb, ab = af.ar_flow_streamed(SEED, *t, 41, lb_layers=lb, **kw)
        assert torch.equal(cd_, cb) and torch.equal(ad, ab)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(192, 24, 168), (1024, 311, 713)],
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_k4_laid_table_is_the_per_call_table_on_card(cuda_device, case):
    """K4 at a 144 px and a 402 px pupil (one and two W slices) from an
    even step over an odd count of steps, on the engine's laid W table and
    on the table laid out for the call: the same bits, and within
    KERNEL_REL of the plain version."""
    from fast_tpu_torch.ops.synth_detect import laid_w, pad_pupil
    N, lo, hi = case
    t = tensors(ar_inputs(L=3, N=N, lo=lo, hi=hi, seed=19, boiling=True,
                          alpha=0.99, scale=0.5 / N, ns_scale=0.07 / N),
                cuda_device)
    W = t[3]
    wr, wi, _ = pad_pupil(W.real.contiguous(), W.imag.contiguous(), None)
    kw = {"noise": "uniform", "step0": 4}
    c, a = af.ar_flow_fused(SEED, *t, 9, laid=laid_w(wr, wi), **kw)
    cf, af_ = af.ar_flow_fused(SEED, *t, 9, **kw)
    c_ref, a_ref = af.ar_flow_reference(SEED, *t, 9, **kw)
    torch.cuda.synchronize()
    assert torch.equal(c, cf) and torch.equal(a, af_)
    assert torch.equal(a, a_ref)
    assert float((c - c_ref).abs().max()) <= KERNEL_REL * float(
        c_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(256, 87, 169, 1024), (1024, 311, 713, 64)],
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_products_at_default_match_plain_on_card(cuda_device, case):
    """ar_dft and ar_detect at PRECISION='default' (one TF32 pass, from the
    hi planes of the laid W table) on the same inputs as their plain
    versions at 'default': within the 3xTF32 limits, both taking the same
    float32 operands."""
    from fast_tpu_torch.ops.synth_detect import laid_w, pad_pupil
    N, lo, hi, nj = case
    rng = np.random.default_rng(15)
    a = torch.from_numpy((rng.normal(size=(2, nj, N, N)) * 0.5 / N)
                         .astype(np.float32)).to(cuda_device)
    W = ts.pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
    wr = torch.from_numpy(W.real.copy()).to(cuda_device)
    wi = torch.from_numpy(W.imag.copy()).to(cuda_device)
    wrp, wip, _ = pad_pupil(wr, wi, None)
    laid = laid_w(wr, wi, precision="default")
    gr, gi = af.ar_dft(a[0], a[1], wr, wi, laid=laid, precision="default")
    rr, ri = af.ar_dft_reference(a[0], a[1], wrp, wip, precision="default")
    top = max(float(rr.abs().max()), float(ri.abs().max()))
    err = max(float((gr - rr).abs().max()), float((gi - ri).abs().max()))
    assert err <= GPRIME_REL * N * 2.0 ** -24 * top
    pm_t = torch.rand((1, wrp.shape[0], wrp.shape[0]), device=cuda_device)
    got = af.ar_detect(gr, gi, wr, wi, pm_t, laid=laid, precision="default")
    ref = af.ar_detect_reference(gr, gi, wrp, wip, pm_t, precision="default")
    assert float((got - ref).abs().max()) <= KERNEL_REL * float(
        ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("noise", [None, "uniform"])
def test_k4_at_default_matches_plain_on_card(cuda_device, noise):
    """K4 at PRECISION='default' over two launches: the final state bit for
    bit the plain version's (the update is the same at every precision),
    the couplings within ONE_PASS_MAX and ONE_PASS_RMS of the TF32
    distance of the plain version at 'default'."""
    from test_torch_tf32x3 import ONE_PASS_MAX, ONE_PASS_RMS, tf32_readings
    t = tensors(ar_inputs(L=4, N=64, seed=21, boiling=noise is not None),
                cuda_device)
    kw = dict(noise=noise or "uniform", max_steps=300)
    before = af.ar_flow_fused.LAUNCHES_BY_PASSES[1]
    c, a = af.ar_flow_fused(SEED, *t, 520, precision="default", **kw)
    kw.pop("max_steps")
    (c1, a1), (c3, _) = (af.ar_flow_reference(SEED, *t, 520, precision=p,
                                              **kw)
                         for p in ("default", "highest"))
    torch.cuda.synchronize()
    assert af.ar_flow_fused.LAUNCHES_BY_PASSES[1] == before + 2
    assert torch.equal(a, a1)
    mx, rms = tf32_readings((c,), (c1,), (c3,))
    assert mx <= ONE_PASS_MAX and rms <= ONE_PASS_RMS
