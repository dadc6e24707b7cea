"""The arithmetic of K1's and K3's products on the tensor cores, emulated
on the CPU: the factor product of pass 1 (K1: ``[u_r | u_i] S_m``, real;
K3: ``z_m B_m``, complex, as four real products) and the detect pass's
``H = W G'`` as three TF32 products, ``a_lo b_hi + a_hi b_lo + a_hi b_hi``,
with each operand split once into ``hi = tf32(x)`` and ``lo = tf32(x -
hi)``, rounded as the card's ``cvt.rna.tf32.f32`` rounds
(``test_torch_tf32x3.tf32``). Everything else is the plain version's
float32, from the same Philox bits.

This settles, without a card, that the kernels' 3xTF32 products keep the
limit the card tests hold them to: K1's sums within
``test_torch_colfac.KERNEL_REL`` of the largest |sum| of the plain
``colfac_detect_reference``, K3's within ``test_torch_wide_pupil.
KERNEL_REL`` of ``colfac_split_reference``'s; and that the limit rejects
each product at one TF32 pass. The first tests, as in
``test_torch_tf32x3.py``, sum each term over the whole depth in fp32: the
operand rounding alone.

The tests of ``fold_sums`` model pass 1's own order of sums on ``wgmma``
(``csrc/colfac_detect.cu``, ``csrc/colfac_split.cu``): each wgmma adds an
8-deep step's products, exact, to the tensor cores' accumulator, rounded
toward zero (``rz32``); a fold group of two steps (16 deep: 16 of K1's
rows, 16 of K3's lanes) is a fresh accumulator that takes, step by step,
each term's a_lo b_hi and a_hi b_lo, then each step's a_hi b_hi, and is
added to an fp32 sum (round to nearest); K3's -z_i B_i is a term whose A
is negated exactly. They hold G' within ``GPRIME_REL N 2^-24 max |G'|``
of the plain pass 1 (the card test of pass 1 alone) and the sums within
KERNEL_REL, 'mixed' and 'gauss', at N <= 128; and show that the a_hi b_hi
kept in the accumulator over the whole depth reads over the limit.
"""

import pytest
import torch

from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops import synth_detect as sd
from test_torch_colfac import GPRIME_REL
from test_torch_colfac import KERNEL_REL as K1_REL
from test_torch_colfac import k1_inputs
from test_torch_tf32x3 import detect, product, rz32, tf32
from test_torch_wide_pupil import KERNEL_REL as K3_REL
from test_torch_wide_pupil import k3_inputs

torch.set_num_threads(1)

SEED = 0xABCDEF0123


def k1_gprime(S, nbatch, mixed, passes):
    """K1's G' with its factor product as ``passes`` TF32 products."""
    N, K, P, _ = S.shape
    b = cd.colfac_bits(SEED, nbatch, N, K // 2)
    z = (torch.stack([sd.uniforms(b[0]), sd.uniforms(b[1])], dim=-1)
         if mixed else torch.stack(sd.box_muller(*b), dim=-1))
    z = z.reshape(nbatch, N, K).transpose(0, 1)
    g = product(z, S.reshape(N, K, 2 * P), passes).transpose(0, 1)
    g = g.reshape(nbatch, N, P, 2)
    return g[..., 0], g[..., 1]


def k3_gprime(T, nbatch, mixed, passes):
    """K3's G' with its complex factor product as four real products of
    ``passes`` TF32 products each."""
    N, Kq, P, _ = T.shape
    b = cd.colfac_bits(SEED, nbatch, N, Kq, lane_stride=cd.lane_width(Kq),
                       word=3)
    zr, zi = ((sd.uniforms(b[0]), sd.uniforms(b[1])) if mixed
              else sd.box_muller(*b))
    zr, zi = zr.transpose(0, 1), zi.transpose(0, 1)
    tr, ti = T[..., 0], T[..., 1]
    gr = product(zr, tr, passes) - product(zi, ti, passes)
    gi = product(zr, ti, passes) + product(zi, tr, passes)
    return gr.transpose(0, 1), gi.transpose(0, 1)


# (kernel, N, lo, hi, draws): K1 and K3 at a 24 px pupil on a 64^2 grid
# (one tile), K3 at 144 px on 160^2 (two tiles an axis on the card, the
# second ragged); screens of ~1.5 rad rms, as the card tests'
CASES = [("K1", 64, 20, 44, 32), ("K3", 64, 20, 44, 16),
         ("K3", 160, 8, 152, 2)]
_CACHE = {}


def readings(case, mixed):
    """Of one case: the plain version's sums, and the sums with (pass 1,
    detect pass) at (3, 3), (1, 3) and (3, 1) TF32 passes, in units of the
    card test's limit."""
    key = (case, mixed)
    if key not in _CACHE:
        kernel, N, lo, hi, nb = case
        if kernel == "K1":
            t = k1_inputs(N, lo, hi, phase_rms=1.5, mixed=mixed)[1]
            ref = cd.colfac_detect_reference(SEED, t["S"], t["wr"], t["wi"],
                                             t["pm_t"], nb, mixed=mixed)
            gprime, tab, rel = k1_gprime, t["S"], K1_REL
        else:
            t = k3_inputs(N, lo, hi, phase_rms=1.5, mixed=mixed)[1]
            ref = cd.colfac_split_reference(SEED, t["T"], t["wr"], t["wi"],
                                            t["pm_t"], nb, mixed=mixed)
            gprime, tab, rel = k3_gprime, t["T"], K3_REL
        limit = rel * float(ref.abs().max())
        out = {}
        for p1, p2 in ((3, 3), (1, 3), (3, 1)):
            g = gprime(tab, nb, mixed, p1)
            sums = sd._pack(detect(*g, t["wr"], t["wi"], t["pm_t"], p2))
            out[p1, p2] = float((sums - ref).abs().max()) / limit
        _CACHE[key] = out
    return _CACHE[key]


def case_id(c):
    return f"{c[0]}-N{c[1]}P{c[3] - c[2]}"


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "gauss"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_sums_at_three_tf32_passes_within_the_limit(case, mixed):
    """Both products in 3xTF32 keep the sums within the card test's limit,
    with room (under a quarter of it) for the card's own sum order."""
    assert readings(case, mixed)[3, 3] < 0.25


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_factor_product_at_one_tf32_pass_misses_the_limit(case):
    """The control of pass 1: its factor product at one TF32 pass (the
    detect pass at three) reads over the limit, so the card tests would
    catch a pass 1 that dropped the split."""
    assert readings(case, True)[1, 3] > 1.0


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_detect_product_at_one_tf32_pass_misses_the_limit(case):
    """The control of the detect pass: H = W G' at one TF32 pass (pass 1 at
    three) reads over the limit."""
    assert readings(case, True)[3, 1] > 1.0


# ---- the tensor cores' sums, in pass 1's order ------------------------------

FOLD = 16  # depth of a fold group of pass 1 (two 8-deep steps)


def fold_sums(terms, fold=FOLD):
    """sum of ``sign * a @ b`` over ``terms`` [(a (..., K), b (..., K, n),
    sign)] as pass 1 sums it on ``wgmma``: per fold group of ``fold`` deep
    a fresh accumulator rounded toward zero after every 8-deep product,
    step by step each term's a_lo b_hi and a_hi b_lo, then each step's
    a_hi b_hi, added to an fp32 sum; ``fold=None``: one accumulator over
    the whole depth."""
    f64 = torch.float64
    split = []
    for a, b, sign in terms:
        ah, bh = tf32(a), tf32(b)
        split.append((ah, tf32(a - ah), bh, tf32(b - bh), sign))
    a0, b0 = terms[0][0], terms[0][1]
    K = a0.shape[-1]
    fold = K if fold is None else fold
    acc = torch.zeros(a0.shape[:-1] + b0.shape[-1:], dtype=torch.float32)

    def add(d, x, y, k, sign):
        return rz32(d.to(f64) + sign * (x[..., k:k + 8].to(f64)
                                        @ y[..., k:k + 8, :].to(f64)))
    for g0 in range(0, K, fold):
        steps = range(g0, min(K, g0 + fold), 8)
        d = torch.zeros_like(acc)
        for k in steps:
            for ah, al, bh, bl, sign in split:
                d = add(d, al, bh, k, sign)
                d = add(d, ah, bl, k, sign)
        for k in steps:
            for ah, _, bh, _, sign in split:
                d = add(d, ah, bh, k, sign)
        acc = acc + d
    return acc


def k1_gprime_folded(S, nbatch, mixed, fold=FOLD):
    """K1's G' with pass 1's order of sums (:func:`fold_sums`)."""
    N, K, P, _ = S.shape
    b = cd.colfac_bits(SEED, nbatch, N, K // 2)
    z = (torch.stack([sd.uniforms(b[0]), sd.uniforms(b[1])], dim=-1)
         if mixed else torch.stack(sd.box_muller(*b), dim=-1))
    z = z.reshape(nbatch, N, K).transpose(0, 1)
    g = fold_sums([(z, S.reshape(N, K, 2 * P), 1)], fold).transpose(0, 1)
    g = g.reshape(nbatch, N, P, 2)
    return g[..., 0], g[..., 1]


def k3_gprime_folded(T, nbatch, mixed, fold=FOLD):
    """K3's G' with pass 1's order of sums: Re G' from z_r B_r and -z_i
    B_i, Im G' from z_r B_i and z_i B_r, each a fold group's two terms."""
    N, Kq, P, _ = T.shape
    b = cd.colfac_bits(SEED, nbatch, N, Kq, lane_stride=cd.lane_width(Kq),
                       word=3)
    zr, zi = ((sd.uniforms(b[0]), sd.uniforms(b[1])) if mixed
              else sd.box_muller(*b))
    zr, zi = zr.transpose(0, 1), zi.transpose(0, 1)
    tr, ti = T[..., 0], T[..., 1]
    gr = fold_sums([(zr, tr, 1), (zi, ti, -1)], fold)
    gi = fold_sums([(zr, ti, 1), (zi, tr, 1)], fold)
    return gr.transpose(0, 1), gi.transpose(0, 1)


# (kernel, N, lo, hi, draws): K1 and K3 at a 24 px pupil on a 64^2 grid,
# and at the flagships' 82 px pupil on 128^2
FOLD_CASES = [("K1", 64, 20, 44, 16), ("K3", 64, 20, 44, 8),
              ("K1", 128, 23, 105, 4), ("K3", 128, 23, 105, 2)]


def folded_readings(case, mixed, fold=FOLD, phase_rms=1.5):
    """(sums error, G' error) of pass 1 summed as :func:`fold_sums` sums
    it, each in units of its card limit: KERNEL_REL of the largest |sum|
    of the plain version, GPRIME_REL N 2^-24 max |G'| of the plain pass
    1."""
    kernel, N, lo, hi, nb = case
    if kernel == "K1":
        t = k1_inputs(N, lo, hi, phase_rms=phase_rms, mixed=mixed)[1]
        tab, rel = t["S"], K1_REL
        ref = cd.colfac_detect_reference(SEED, tab, t["wr"], t["wi"],
                                         t["pm_t"], nb, mixed=mixed)
        g32 = cd.colfac_pass1_reference(SEED, tab, nb, mixed=mixed)
        g = k1_gprime_folded(tab, nb, mixed, fold)
    else:
        t = k3_inputs(N, lo, hi, phase_rms=phase_rms, mixed=mixed)[1]
        tab, rel = t["T"], K3_REL
        ref = cd.colfac_split_reference(SEED, tab, t["wr"], t["wi"],
                                        t["pm_t"], nb, mixed=mixed)
        g32 = cd.split_pass1_reference(SEED, tab, nb, mixed=mixed)
        g = k3_gprime_folded(tab, nb, mixed, fold)
    sums = sd._pack(detect(*g, t["wr"], t["wi"], t["pm_t"], 3))
    se = float((sums - ref).abs().max()) / (rel * float(ref.abs().max()))
    top = max(float(x.abs().max()) for x in g32)
    ge = (max(float((x - y).abs().max()) for x, y in zip(g, g32))
          / (N * 2.0 ** -24 * top))
    return se, ge


def fold_id(c):
    return f"{c[0]}-N{c[1]}P{c[3] - c[2]}"


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "gauss"])
@pytest.mark.parametrize("case", FOLD_CASES, ids=fold_id)
def test_pass1_sums_in_fold_groups_within_the_limits(case, mixed):
    """Pass 1's order of sums on wgmma keeps G' within a quarter of
    GPRIME_REL and the sums within a quarter of KERNEL_REL."""
    se, ge = folded_readings(case, mixed)
    assert ge < GPRIME_REL / 4
    assert se < 0.25


def test_hi_products_kept_over_the_whole_depth_miss_the_limit():
    """The control: with K1's a_hi b_hi kept in the tensor cores' sum over
    the whole depth (no fp32 fold), the sums read over KERNEL_REL where
    pass 1's fold groups read under half of it. 'mixed' noise (256 rows)
    at 128^2 with a 128 px pupil and screens of 3 rad rms, whose sums see
    the drift of G' toward zero most (G' itself stays within GPRIME_REL:
    that limit grows with N, pass 1's depth is K)."""
    case = ("K1", 128, 0, 128, 4)
    folded, _ = folded_readings(case, True, phase_rms=3.0)
    whole, _ = folded_readings(case, True, fold=None, phase_rms=3.0)
    assert folded < 0.5
    assert whole > 1.0
