"""The arithmetic of K2's and K7's pass 1 on the tensor cores, emulated on
the CPU: both products of pass 1 (the mixing product ``u @ M`` and
``G' = X' W^T``) and the second pass's ``H = W G'`` as three TF32
products, ``a_lo b_hi + a_hi b_lo + a_hi b_hi`` (small terms first), with
each operand split once into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``,
rounded as the card's ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
from zero, on the 13 low mantissa bits). Everything else is the plain
version's float32. K7's screens pass is the same product as the detect
pass's (``tests/test_torch_detect_wgmma.py`` models both passes' order
of sums).

This settles, without a card, that the kernel's 3xTF32 products keep the
limits the card tests hold it to: K2's sums within KERNEL_REL = 4e-6 of
the largest |sum| of the plain ``synth_detect_reference``, K7's screens
within 2N 2^-24 max |phi|; and that those limits still reject products
at one TF32 pass. The first tests sum each of the three terms over the
whole depth in fp32 (round to nearest): the operand rounding alone.

The tests of ``pass1_sums`` model the tensor cores' own sums as pass 1
(csrc/synth_detect.cu) takes them. Each wgmma adds an 8-deep step's
products, exact, to its accumulator and rounds the sum toward zero (the
``rz32`` of tests/test_torch_ar_tf32x3.py); a fold group of FOLD = 16
deep (two steps) is a fresh accumulator that takes the small terms of
both steps first, then their a_hi b_hi, and is then added to an fp32 sum,
rounded to nearest. They hold K2's sums within KERNEL_REL and G' within
GPRIME_REL in that order of sums, at N <= 128; and show that keeping the
a_hi b_hi in the accumulator over the whole depth reads over the limit
where the fold groups read under it.

It also fixes the limit of the card test of pass 1 alone
(``test_torch_synth_detect.test_pass1_matches_plain_on_card``): G'
element by element within ``GPRIME_REL * N * 2^-24 * max |G'|``.
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch.ops import synth_detect as sd
from test_torch_synth_detect import GPRIME_REL, KERNEL_REL, k2_inputs

torch.set_num_threads(1)

SEED = 0xABCDEF0123


def tf32(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32``: add half of the
    dropped 13 bits to the magnitude, then clear them."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a, b, passes):
    """``a @ b`` as the card's TF32 products: three (3xTF32) or one."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def detect(gr, gi, wr, wi, pm_t, passes):
    """The detect pass with ``H = W G'`` as the card's TF32 products (three
    or one), the rest as the plain version's: (nb, 4) sums."""
    h1 = product(wr, gr, passes) - product(wi, gi, passes)
    h2 = product(wr, gi, passes) + product(wi, gr, passes)
    s1, c1 = sd.sincos(h1)
    s2, c2 = sd.sincos(h2)
    return torch.stack([(pm_t * c1).sum((-2, -1)), (pm_t * s1).sum((-2, -1)),
                        (pm_t * c2).sum((-2, -1)), (pm_t * s2).sum((-2, -1))],
                       dim=-1)


def pass1(t, nbatch, mixed, passes):
    """G' of ``nbatch`` draws from SEED, stream 0, with pass 1's products
    emulated: (gr, gi) (nbatch, N, P)."""
    N = t["s_t"].shape[0]
    b1, b2 = sd.philox_bits(SEED, nbatch, N)
    if mixed:
        z1 = product(sd.uniforms(b1), t["mix"], passes)
        z2 = product(sd.uniforms(b2), t["mix"], passes)
    else:
        z1, z2 = sd.box_muller(b1, b2)
    xr, xi = z1 * t["s_t"], z2 * t["s_t"]
    wrt, wit = t["wr"].T, t["wi"].T
    return (product(xr, wrt, passes) - product(xi, wit, passes),
            product(xr, wit, passes) + product(xi, wrt, passes))


# (N, lo, hi, draws): the 256^2 flagship's 82 px pupil and the 1024^2
# link's 402 px pupil; screens of ~1.5 rad rms, as a link's and as the
# card tests' (the round-off of fp32 itself grows with the phase)
CASES = [(256, 87, 169, 4), (1024, 311, 713, 1)]
_CACHE = {}


def readings(case, mixed):
    """Of one case: the plain version's sums and G', and pass 1 at three
    TF32 passes and at one, each as (G', K2's sums)."""
    key = (case, mixed)
    if key not in _CACHE:
        N, lo, hi, nb = case
        _, t = k2_inputs(N, lo, hi, phase_rms=1.5)
        mix = t["mix"] if mixed else None
        ref = sd.synth_detect_reference(SEED, t["s_t"], t["wr"], t["wi"],
                                        t["pm_t"], nb, mix=mix)
        g32 = sd.synth_pass1_reference(SEED, t["s_t"], t["wr"], t["wi"], nb,
                                       mix=mix)
        out = {"t": t, "ref": ref, "g32": g32}
        for passes in (3, 1):
            g = pass1(t, nb, mixed, passes)
            sums = sd._pack(detect(*g, t["wr"], t["wi"], t["pm_t"], passes))
            out[passes] = (g, sums)
        _CACHE[key] = out
    return _CACHE[key]


def k2_error(r, passes):
    """max |emulated - plain| of K2's sums, in units of the card's limit."""
    return (float((r[passes][1] - r["ref"]).abs().max())
            / (KERNEL_REL * float(r["ref"].abs().max())))


def gprime_error(r, passes):
    """max |emulated - plain| of G', in units of N 2^-24 max |G'|."""
    N = r["t"]["s_t"].shape[0]
    err = max(float((a - b).abs().max())
              for a, b in zip(r[passes][0], r["g32"]))
    top = max(float(g.abs().max()) for g in r["g32"])
    return err / (N * 2.0 ** -24 * top)


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "gauss"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_k2_sums_at_three_tf32_passes_within_the_limit(case, mixed):
    """3xTF32 keeps K2 within KERNEL_REL of the plain fp32 sums, with room
    (under a quarter of the limit) for the card's own sum order."""
    assert k2_error(readings(case, mixed), 3) < 0.25


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_k2_sums_at_one_tf32_pass_miss_the_limit(case):
    """The control: one TF32 pass (10 bits of mantissa) reads over the
    limit, so the card tests would catch a kernel that dropped the split.
    'mixed' noise, whose 4N^3 mixing product takes most of the error."""
    assert k2_error(readings(case, True), 1) > 1.0


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "gauss"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_gprime_at_three_tf32_passes_within_the_card_limit(case, mixed):
    """G' itself, the quantity the card test of pass 1 compares element by
    element: 3xTF32 under a quarter of GPRIME_REL N 2^-24 max |G'|, one
    TF32 pass over it."""
    r = readings(case, mixed)
    assert gprime_error(r, 3) < GPRIME_REL / 4
    assert gprime_error(r, 1) > GPRIME_REL


@pytest.mark.parametrize("order", ["operands", "fold groups"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_k7_screens_at_three_tf32_passes_within_the_limit(case, order):
    """K7's screens (pass 1 with Box-Muller noise, then the screens pass's
    H^T = G'^T W^T, both at three TF32 passes) within 2N 2^-24 max |phi|
    of the plain ``synth_screens_reference``, the limit of the card's K7
    checks; a tenth of it or less. The screens pass's products summed over
    the whole depth in fp32 ('operands': the operand rounding alone), or
    as the pass sums them on wgmma ('fold groups': both terms of a part in
    fold groups of two 8-deep steps, ``test_torch_colfac_tf32x3.
    fold_sums``)."""
    from test_torch_colfac_tf32x3 import fold_sums
    N, lo, hi, nb = case
    r = readings(case, False)
    t = r["t"]
    gr, gi = r[3][0]
    if order == "operands":
        re = (product(t["wr"], gr, 3)
              - product(t["wi"], gi, 3)).transpose(-2, -1)
        im = (product(t["wr"], gi, 3)
              + product(t["wi"], gr, 3)).transpose(-2, -1)
    else:
        ar, ai = gr.transpose(-2, -1), gi.transpose(-2, -1)
        br, bi = t["wr"].T.contiguous(), t["wi"].T.contiguous()
        re = fold_sums([(ar, br, 1), (ai, bi, -1)], FOLD)
        im = fold_sums([(ar, bi, 1), (ai, br, 1)], FOLD)
    got = torch.cat([re, im])
    ref = sd.synth_screens_reference(SEED, t["s_t"], t["wr"], t["wi"], nb)
    assert got.shape == ref.shape == (2 * nb, hi - lo, hi - lo)
    limit = 2 * N * 2.0 ** -24 * float(ref.abs().max())
    assert float((got - ref).abs().max()) < 0.1 * limit


def test_tf32_rounding_matches_cvt_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero, and
    a carry into the exponent: cases whose TF32 values are known."""
    one = 1.0
    ulp = 2.0 ** -10        # TF32's unit in the last place at 1
    x = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2.0 ** -23,
                      -(one + ulp / 2), 2.0 - ulp / 4, 3.0e-3],
                     dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[:5] == [one, one + ulp, one, -(one + ulp), 2.0]
    assert abs(got[5] - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    hi = tf32(x)
    lo = tf32(x - hi)
    np.testing.assert_array_equal(((hi.view(torch.int32) & 0x1FFF) == 0)
                                  .numpy(), True)
    # hi + lo carries 22 of float32's 24 bits
    assert float(((hi + lo) - x).abs().max()) <= 2.0 ** -21


# ---- the tensor cores' sums, in pass 1's order ------------------------------

FOLD = 16  # depth of a fold group of pass 1 (two 8-deep steps)


def rz32(x):
    """float64 ``x`` to float32, rounded toward zero."""
    y = x.to(torch.float32)
    over = y.to(torch.float64).abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def product_rz(a, b, fold=FOLD):
    """``a @ b`` as pass 1 sums it: fold groups of ``fold`` deep, each a
    fresh accumulator rounded toward zero after every 8-deep product (the
    group's a_lo b_hi and a_hi b_lo first, then its a_hi b_hi), added to
    an fp32 sum; ``fold=None``: one accumulator over the whole depth."""
    f64 = torch.float64
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    K = a.shape[-1]
    fold = K if fold is None else fold
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for g0 in range(0, K, fold):
        steps = range(g0, min(K, g0 + fold), 8)
        d = torch.zeros_like(acc)
        for x, y in [(al, bh), (ah, bl)]:
            for k in steps:
                d = rz32(d.to(f64) + x[..., k:k + 8].to(f64)
                         @ y[k:k + 8].to(f64))
        for k in steps:
            d = rz32(d.to(f64) + ah[..., k:k + 8].to(f64)
                     @ bh[k:k + 8].to(f64))
        acc = acc + d
    return acc


def pass1_sums(case, mixed, fold=FOLD, phase_rms=1.5):
    """(K2's sums error, G' error), each in units of its card limit, with
    both products of pass 1 summed as :func:`product_rz` sums them (the
    detect pass as the first tests emulate it)."""
    N, lo, hi, nb = case
    _, t = k2_inputs(N, lo, hi, phase_rms=phase_rms)
    mix = t["mix"] if mixed else None
    b1, b2 = sd.philox_bits(SEED, nb, N)
    if mixed:
        z1 = product_rz(sd.uniforms(b1), mix, fold)
        z2 = product_rz(sd.uniforms(b2), mix, fold)
    else:
        z1, z2 = sd.box_muller(b1, b2)
    xr, xi = z1 * t["s_t"], z2 * t["s_t"]
    wrt, wit = t["wr"].T.contiguous(), t["wi"].T.contiguous()
    g = (product_rz(xr, wrt, fold) - product_rz(xi, wit, fold),
         product_rz(xr, wit, fold) + product_rz(xi, wrt, fold))
    ref = sd.synth_detect_reference(SEED, t["s_t"], t["wr"], t["wi"],
                                    t["pm_t"], nb, mix=mix)
    g32 = sd.synth_pass1_reference(SEED, t["s_t"], t["wr"], t["wi"], nb,
                                   mix=mix)
    sums = sd._pack(detect(*g, t["wr"], t["wi"], t["pm_t"], 3))
    k2 = (float((sums - ref).abs().max())
          / (KERNEL_REL * float(ref.abs().max())))
    top = max(float(x.abs().max()) for x in g32)
    gp = (max(float((x - y).abs().max()) for x, y in zip(g, g32))
          / (N * 2.0 ** -24 * top))
    return k2, gp


# (N, lo, hi, draws): 64^2 with a 24 px pupil and 128^2 with the
# flagships' 82 px one
RZ_CASES = [(64, 20, 44, 8), (128, 23, 105, 4)]


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "gauss"])
@pytest.mark.parametrize("case", RZ_CASES,
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_pass1_sums_in_fold_groups_within_the_limits(case, mixed):
    """Pass 1's order of sums keeps K2 within a quarter of KERNEL_REL and
    G' within a quarter of GPRIME_REL."""
    k2, gp = pass1_sums(case, mixed)
    assert k2 < 0.25
    assert gp < GPRIME_REL / 4


def test_hi_products_kept_over_the_whole_depth_miss_the_limit():
    """The control: with the a_hi b_hi kept in the tensor cores' sum over
    the whole depth (no fp32 fold), K2's sums read over KERNEL_REL where
    pass 1's fold groups read under half of it. 'mixed' noise at 128^2
    with a 128 px pupil and screens of 2.5 rad rms, whose sums see the
    sums' drift toward zero most."""
    case = (128, 0, 128, 8)
    folded, _ = pass1_sums(case, True, FOLD, phase_rms=2.5)
    whole, _ = pass1_sums(case, True, None, phase_rms=2.5)
    assert folded < 0.5
    assert whole > 1.0
