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
each product at one TF32 pass. As in ``test_torch_tf32x3.py`` the emulation
sums each term over the whole depth in fp32; the kernels add each 8-deep
step's products to their sums in fp32, and the card tests hold them to the
same limits.
"""

import pytest
import torch

from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops import synth_detect as sd
from test_torch_colfac import KERNEL_REL as K1_REL
from test_torch_colfac import k1_inputs
from test_torch_tf32x3 import detect, product
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
