"""The arithmetic of the AR kernels' first DFT product (``ar_dft`` of
``csrc/ar_flow.cu``, on the tensor cores) emulated on the CPU.

``G'[m][p] = sum_k A[k][m] W[p][k]`` (complex) as the kernel computes it:
W split once into ``hi = tf32(w)`` and ``lo = tf32(w - hi)``, each element
of the layer sum A split the same way, both rounded as ``cvt.rna.tf32.f32``
rounds (to nearest, ties away from zero, on the 13 low mantissa bits).
Each 8-deep step of each output is a chain of six TF32 products in fresh
accumulators, the small terms first (``a_lo b_hi``, ``a_hi b_lo`` of the
two complex terms), then the two ``a_hi b_hi``; every product of the
chain adds 8 exact products to the chain's sum and rounds the result
toward zero, as the tensor cores do; the step's sum is then added to the
output in fp32, rounded to nearest. Everything else is the plain
version's float32 (``ops/ar_flow.ar_dft_reference`` replaced by the
emulation).

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
from test_torch_tf32x3 import tf32

torch.set_num_threads(1)


def rz32(x):
    """float64 ``x`` to float32, rounded toward zero."""
    y = x.to(torch.float32)
    over = y.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def ar_dft_emulated(ar, ai, wr, wi, passes=3):
    """G' = A^T W^T of layer sums (..., N, N) with the kernel's products
    (``passes=3``), or with one TF32 pass (``passes=1``: hi hi only)."""
    lead, N = ar.shape[:-2], ar.shape[-1]
    f64 = torch.float64
    # the A operand of the products is A^T: (m, k)
    a = [x.reshape(-1, N, N).transpose(-2, -1) for x in (ar, ai)]
    (arh, arl), (aih, ail) = split(a[0]), split(a[1])
    (wrh, wrl), (wih, wil) = split(wr.T), split(wi.T)  # (k, p)
    out = []
    for terms in (  # Re G' = Ar Wr - Ai Wi, Im G' = Ar Wi + Ai Wr
            [(arl, wrh, 1), (arh, wrl, 1), (ail, wih, -1), (aih, wil, -1),
             (arh, wrh, 1), (aih, wih, -1)],
            [(arl, wih, 1), (arh, wil, 1), (ail, wrh, 1), (aih, wrl, 1),
             (arh, wih, 1), (aih, wrh, 1)]):
        if passes == 1:
            terms = terms[4:]
        acc = torch.zeros(a[0].shape[:-1] + (wr.shape[0],),
                          dtype=torch.float32)
        for k0 in range(0, N, 8):
            d = torch.zeros_like(acc)
            for x, w, sign in terms:
                d = rz32(d.to(f64) + sign * (x[..., k0:k0 + 8].to(f64)
                                             @ w[k0:k0 + 8].to(f64)))
            acc = acc + d
        out.append(acc.reshape(lead + acc.shape[-2:]))
    return tuple(out)


# (N, pupil rows lo..hi, layers, steps): 64^2 with a 24 px pupil (padded
# to 32) and 128^2 with an 82 px one (padded to 96, the flagships' P)
CASES = [(64, 20, 44, 2, 64), (128, 23, 105, 2, 16)]
_CACHE = {}


def readings(case, noise, monkeypatch):
    """The plain run's couplings and the couplings with the first product
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
                m.setattr(af, "ar_dft_reference",
                          lambda ar, ai, wr, wi, p=passes:
                          ar_dft_emulated(ar, ai, wr, wi, p))
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
