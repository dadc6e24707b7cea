"""The arithmetic of the AR kernels' two products (``ar_dft`` and
``ar_detect`` of ``csrc/ar_flow.cu``, both the second pass of
``csrc/detect.cuh`` on ``wgmma``) emulated on the CPU.

``G'[m][p] = sum_k A[k][m] W[p][k]`` (complex) and ``Re H^T = Re(G'^T
W^T)`` as the pass computes them: every operand element split once into
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, rounded as ``cvt.rna.tf32.f32``
rounds (to nearest, ties away from zero, on the 13 low mantissa bits);
per fold group of two 8-deep steps a fresh accumulator, rounded toward
zero after every 8-deep product as the tensor cores round (the small
terms ``a_lo b_hi``, ``a_hi b_lo`` of each complex term step by step
first, then the ``a_hi b_hi``), added to an fp32 sum (the emulator of
``tests/test_torch_detect_wgmma.py``, ``h_t``); the detect's terms summed
per 16 rows and W slice, those partial sums then in order, as
``sum_tiles`` adds them (``kernel_sums``), with the pupil * mode of the
pair's series. Everything else is the plain version's float32
(``ops/ar_flow.ar_dft_reference`` and ``ar_detect_reference`` replaced by
the emulation).

This settles, without a card, that the products keep the limits the card
tests hold the AR kernels to: the couplings of a small AR run within
KERNEL_REL = 4e-6 of the largest |sum| of the plain ``ar_flow_reference``,
G' within the card test's ``GPRIME_REL N 2^-24 max |G'|``; and that those
limits still reject products at one TF32 pass.
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch.ops import ar_flow as af
from test_torch_ar_flow import (GPRIME_REL, KERNEL_REL, SEED, ar_inputs,
                                tensors)
from test_torch_detect_wgmma import h_t, kernel_sums
from test_torch_tf32x3 import rz32

torch.set_num_threads(1)


def ar_dft_emulated(ar, ai, wr, wi, passes=3):
    """G' = A^T W^T of layer sums (..., N, N) with the pass's products
    (``passes=3``), or with one TF32 pass (``passes=1``: hi hi only): the
    second pass with A's rows [k][m], ``h_t`` of the layer sums."""
    return h_t(ar, ai, wr, wi, passes)


def ar_detect_emulated(gr, gi, wr, wi, pm_t, passes=3):
    """The detect pass of pairs' G' (..., B, N, P) with the pass's products
    and order of sums: (..., B, 2), pair (t, s) weighted by ``pm_t[s]``
    (B, P, P)."""
    lead, (N, P) = gr.shape[:-2], gr.shape[-2:]
    hr = h_t(gr.reshape(-1, N, P), gi.reshape(-1, N, P), wr, wi, passes)[0]
    pm = pm_t.expand(lead + pm_t.shape[-2:]).reshape(-1, P, P)
    return kernel_sums(hr, hr, pm)[:, :2].reshape(lead + (2,))


# (N, pupil rows lo..hi, layers, steps): 64^2 with a 24 px pupil (padded
# to 32) and 128^2 with an 82 px one (padded to 96, the flagships' P)
CASES = [(64, 20, 44, 2, 64), (128, 23, 105, 2, 16)]
_CACHE = {}


def readings(case, noise, monkeypatch):
    """The plain run's couplings and the couplings with both products
    emulated at three TF32 passes and at one."""
    key = (case, noise)
    if key not in _CACHE:
        N, lo, hi, L, nsteps = case
        t = tensors(ar_inputs(L=L, N=N, lo=lo, hi=hi, seed=11,
                              boiling=True, alpha=0.99,
                              scale=0.02 * 64 / N))
        ref = af.ar_flow_reference(SEED, *t, nsteps, noise=noise)[0]
        out = {"ref": ref}
        for passes in (3, 1):
            with monkeypatch.context() as m:
                # the plain version's precision argument ('highest' here)
                # is replaced by the emulated pass count
                m.setattr(af, "ar_dft_reference",
                          lambda ar, ai, wr, wi, precision=None, p=passes:
                          ar_dft_emulated(ar, ai, wr, wi, p))
                m.setattr(af, "ar_detect_reference",
                          lambda gr, gi, wr, wi, pm_t, precision=None,
                          p=passes:
                          ar_detect_emulated(gr, gi, wr, wi, pm_t, p))
                out[passes] = af.ar_flow_reference(SEED, *t, nsteps,
                                                   noise=noise)[0]
        _CACHE[key] = out
    return _CACHE[key]


def error(r, passes):
    """max |emulated - plain| of the couplings, in units of the limit."""
    return (float((r[passes] - r["ref"]).abs().max())
            / (KERNEL_REL * float(r["ref"].abs().max())))


@pytest.mark.parametrize("noise", ["uniform", "gauss"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_couplings_at_three_tf32_passes_within_the_limit(case, noise,
                                                         monkeypatch):
    """3xTF32 keeps the couplings within KERNEL_REL of the plain fp32 ones,
    with room (under a quarter of the limit) for the card's own sum
    order."""
    assert error(readings(case, noise, monkeypatch), 3) < 0.25


@pytest.mark.parametrize("noise", ["uniform", "gauss"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_couplings_at_one_tf32_pass_miss_the_limit(case, noise, monkeypatch):
    """The control: one TF32 pass reads over the limit, so the card tests
    would catch a kernel that dropped the split."""
    assert error(readings(case, noise, monkeypatch), 1) > 1.0


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_gprime_within_the_card_limit(case):
    """G' itself, what the card test of ar_dft compares element by
    element: 3xTF32 under a quarter of GPRIME_REL N 2^-24 max |G'|, one
    TF32 pass over it."""
    N, lo, hi = case[:3]
    a0, _, _, W, _ = tensors(ar_inputs(L=3, N=N, lo=lo, hi=hi, seed=12,
                                       scale=0.02 * 64 / N))
    ar, ai = a0.real.contiguous(), a0.imag.contiguous()
    wr, wi = W.real.contiguous(), W.imag.contiguous()
    ref = af.ar_dft_reference(ar, ai, wr, wi)
    top = max(float(g.abs().max()) for g in ref)
    limit = GPRIME_REL * N * 2.0 ** -24 * top
    for passes, bound in ((3, 0.25 * limit), (1, None)):
        got = ar_dft_emulated(ar, ai, wr, wi, passes)
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        if bound is None:
            assert err > limit
        else:
            assert err < bound


def test_round_toward_zero():
    """rz32 keeps float32 values and moves the others toward zero."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30),
                      1.0 - 2.0 ** -30, 3.0], dtype=torch.float64)
    got = rz32(x).tolist()
    assert got == [1.0, 1.0, -1.0, 1.0 - 2.0 ** -24, 3.0]
    assert np.all(np.abs(rz32(x).double().numpy()) <= np.abs(x.numpy()))
