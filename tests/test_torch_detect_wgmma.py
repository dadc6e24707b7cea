"""The second pass of the iid kernels on ``wgmma`` (``csrc/detect.cuh``):
the detect pass that K1, K2 and K3 end with and K7's screens pass, both
``H^T = G'^T W^T`` with the draws stacked along the 64-row axis, against
the laid W table (``synth_detect.laid_w``).

On the CPU, the kernel's arithmetic emulated: the products in 3xTF32
(operands split once into ``hi = tf32(x)`` and ``lo = tf32(x - hi)``)
summed as the pass sums them, in fold groups of two 8-deep steps, each a
fresh accumulator rounded toward zero after every 8-deep product (the
small terms first, then the a_hi b_hi; ``test_torch_colfac_tf32x3.
fold_sums``) and added to an fp32 sum; the detect pass's terms summed per
16 rows and W slice, those partial sums then in order, as ``sum_tiles``
adds them. Stacking the draws along the rows changes no element's sum.
The detect pass is held within KERNEL_REL of the largest |sum| of the
plain ``detect_reference`` on K2's, K1's and K3's G', the screens pass
within 2N 2^-24 max |phi| of ``screens_pass_reference``; at one TF32 pass
each reads over its limit. The laid W table is pass 1's ``wpack``.

On the card (marked ``cuda``, skipped here), each pass alone against its
plain version on the same G' at the shapes the main paths give it, two
launches bit for bit, with a draw count that leaves the last block of
rows part empty:

    python -m pytest --noconftest tests/test_torch_detect_wgmma.py -m cuda
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops import synth_detect as sd
from test_torch_colfac import k1_inputs
from test_torch_colfac_tf32x3 import FOLD, fold_sums
from test_torch_synth_detect import KERNEL_REL, k2_inputs
from test_torch_tf32x3 import product
from test_torch_wide_pupil import k3_inputs

torch.set_num_threads(1)

SEED = 0xABCDEF0123


def h_t(gr, gi, wr, wi, passes=3):
    """(Re H^T, Im H^T), (nb, P, P) rows p2 and columns p1, from G' (nb, N,
    P) as the second pass forms them: 3xTF32 in fold groups
    (``fold_sums``), or the control at one TF32 pass."""
    ar, ai = gr.transpose(-2, -1), gi.transpose(-2, -1)
    br, bi = wr.T.contiguous(), wi.T.contiguous()
    if passes == 1:
        return (product(ar, br, 1) - product(ai, bi, 1),
                product(ar, bi, 1) + product(ai, br, 1))
    return (fold_sums([(ar, br, 1), (ai, bi, -1)], FOLD),
            fold_sums([(ar, bi, 1), (ai, br, 1)], FOLD))


def kernel_sums(hr_t, hi_t, pm_t, sh_t=None):
    """The detect pass's (nb, 4) sums of H^T in its order: the terms of 16
    rows p2 and one W slice of p1 a partial sum, the partial sums of a
    draw added in order (16 rows, then slice), as sum_tiles adds them."""
    nb, P, _ = hr_t.shape
    PB, nz = sd._pass1_geom(P)
    out = []
    for k, ht in enumerate((hr_t, hi_t)):
        h = ht.transpose(-2, -1)
        if sh_t is not None:
            h = h + sh_t[:, k]
        s, c = sd.sincos(h)
        for v in (c, s):
            t = torch.nn.functional.pad(pm_t * v, (0, 0, 0, nz * PB - P))
            parts = t.reshape(nb, nz, PB, P // 16, 16).sum((2, 4))
            parts = parts.transpose(1, 2).reshape(nb, -1)
            acc = torch.zeros(nb, dtype=torch.float32)
            for i in range(parts.shape[1]):
                acc = acc + parts[:, i]
            out.append(acc)
    return torch.stack(out, dim=-1)


def padded(t):
    wr, wi, pm_t = sd.pad_pupil(t["wr"], t["wi"], t["pm_t"])
    return wr, wi, pm_t


def gprime(kernel, N, lo, hi, nb):
    """The plain pass 1's G' of a kernel at a shape, with the padded W and
    pm_t it is detected with; screens of ~1.5 rad rms."""
    if kernel == "K1":
        t = k1_inputs(N, lo, hi, phase_rms=1.5)[1]
        g = cd.colfac_pass1_reference(SEED, t["S"], nb)
    elif kernel == "K3":
        t = k3_inputs(N, lo, hi, phase_rms=1.5)[1]
        g = cd.split_pass1_reference(SEED, t["T"], nb)
    else:
        t = k2_inputs(N, lo, hi, phase_rms=1.5)[1]
        wr, wi, _ = padded(t)
        g = sd.synth_pass1_reference(
            SEED, t["s_t"], wr, wi, nb,
            mix=t["mix"] if kernel == "K2" else None)
    return g, padded(t)


# (kernel, N, lo, hi, draws): K2 on 64^2 at 24 px and the default
# config's 102^2 grid and pupil (112 px padded, four draws a group of 7
# blocks), K1 at the flagships' 82 px on 128^2, K3 at a 144 px pupil on
# 192^2 (the ragged case of chip_smoke.py)
SUM_CASES = [("K2", 64, 20, 44, 8), ("K2", 102, 0, 102, 4),
             ("K1", 128, 23, 105, 4), ("K3", 192, 24, 168, 2)]
_CACHE = {}


def sum_readings(case):
    """The detect pass's sums error in units of KERNEL_REL of the largest
    |sum|, at three TF32 passes in fold groups (with subharmonic screens
    of ~1 rad rms) and at one pass."""
    if case not in _CACHE:
        kernel, N, lo, hi, nb = case
        (gr, gi), (wr, wi, pm_t) = gprime(kernel, N, lo, hi, nb)
        P = wr.shape[0]
        rng = np.random.default_rng(4)
        sh = torch.from_numpy((rng.standard_normal((nb, hi - lo, hi - lo))
                               + 1j * rng.standard_normal(
                                   (nb, hi - lo, hi - lo))).astype(
                                       np.complex64))
        sh_t = sd.pack_subharm(sh, P)
        out = {}
        for passes, shk in ((3, None), (3, sh_t), (1, None)):
            ref = sd.detect_reference(gr, gi, wr, wi, pm_t, shk)
            got = kernel_sums(*h_t(gr, gi, wr, wi, passes), pm_t, shk)
            out[passes, shk is not None] = (
                float((got - ref).abs().max())
                / (KERNEL_REL * float(ref.abs().max())))
        _CACHE[case] = out
    return _CACHE[case]


def case_id(c):
    return f"{c[0]}-N{c[1]}P{c[3] - c[2]}"


@pytest.mark.parametrize("subharm", [False, True], ids=["plain", "sh"])
@pytest.mark.parametrize("case", SUM_CASES, ids=case_id)
def test_detect_pass_sums_in_fold_groups_within_the_limit(case, subharm):
    """The detect pass's order of sums keeps K1's, K2's and K3's sums
    within a quarter of KERNEL_REL of the plain detect pass on the same
    G', with and without subharmonic screens."""
    assert sum_readings(case)[3, subharm] < 0.25


@pytest.mark.parametrize("case", SUM_CASES, ids=case_id)
def test_detect_pass_at_one_tf32_pass_misses_the_limit(case):
    """The control: H^T at one TF32 pass reads over KERNEL_REL, so the card
    tests would catch a detect pass that dropped the split."""
    assert sum_readings(case)[1, False] > 1.0


# (N, lo, hi, draws) of K7's screens pass on its Box-Muller G': 64^2 at
# 24 px, 192^2 at the ragged 144 px pupil, the 256^2 flagship's 82 px
SCREEN_CASES = [(64, 20, 44, 8), (192, 24, 168, 2), (256, 87, 169, 2)]


@pytest.mark.parametrize("case", SCREEN_CASES,
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}")
def test_screens_pass_in_fold_groups_within_the_limit(case):
    """K7's screens pass in its order of sums within a tenth of 2N 2^-24
    max |phi| of screens_pass_reference on the same G'; at one TF32 pass
    over that limit."""
    N, lo, hi, nb = case
    (gr, gi), (wr, wi, _) = gprime("K7", N, lo, hi, nb)
    npup = hi - lo
    ref = sd.screens_pass_reference(gr, gi, wr, wi, npup)
    limit = 2 * N * 2.0 ** -24 * float(ref.abs().max())
    errs = []
    for passes in (3, 1):
        hr, hi_ = h_t(gr, gi, wr, wi, passes)
        got = torch.cat([hr[:, :npup, :npup], hi_[:, :npup, :npup]])
        assert got.shape == ref.shape == (2 * nb, npup, npup)
        errs.append(float((got - ref).abs().max()) / limit)
    assert errs[0] < 0.1
    assert errs[1] > 1.0


def _word(col, depth):
    """Word of column ``col`` and depth ``depth`` in an 8-deep step of
    wgmma's B layout (csrc/wgmma.cuh): slot s holds depth 2 (s % 4) + s //
    4."""
    s = (0, 2, 4, 6, 1, 3, 5, 7).index(depth % 8)
    return (col // 8) * 64 + (s // 4) * 32 + (col % 8) * 4 + s % 4


def test_laid_w_is_the_core_layout_of_w():
    """The laid W table holds pass1_tables' wpack and mpack: W^T's slices
    of 208 columns at 416 px (from a 402 px W, padded), each element's hi
    and lo where _core_layout puts them, padding zero."""
    rng = np.random.default_rng(3)
    N, npup = 100, 402
    wr, wi = (torch.from_numpy(rng.standard_normal((npup, N))
                               .astype(np.float32)) for _ in range(2))
    mix = torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32))
    laid = sd.laid_w(wr, wi, mix)
    pr, pi, _ = sd.pad_pupil(wr, wi, None)
    wpack, mpack = sd.pass1_tables(pr, pi, mix)
    assert laid.shape == (416, N) and laid.device == wr.device
    assert laid.wpack.shape == (2, 128 // 8, 4, 8 * 208)
    assert torch.equal(laid.wpack, wpack) and torch.equal(laid.mpack, mpack)
    assert laid.nbytes == 4 * (wpack.numel() + mpack.numel())
    hi, lo = sd._hi_lo(pr)
    for p, d in [(0, 0), (5, 7), (207, 99), (208, 8), (401, 63), (300, 41)]:
        z, c = divmod(p, 208)
        w = laid.wpack[z, d // 8, :, _word(c, d)]
        assert float(w[0]) == float(hi[p, d])
        assert float(w[1]) == float(lo[p, d])
    wt = torch.nn.functional.pad(pr.T[:, :208], (0, 0, 0, 4))  # 104 deep
    layout = sd._core_layout(wt.contiguous(), 208)
    np.testing.assert_array_equal(laid.wpack[0, :13, 0].numpy(),
                                  sd._hi_lo(layout)[0][0].numpy())
    assert float(laid.wpack[1, :, :, :].reshape(16, 4, 26, 64)[
        :, :, 25, :].abs().max()) == 0.0  # columns 410..415: pupil padding
    assert float(laid.wpack[:, 13:].abs().max()) == 0.0  # depth >= 104
    # without a mixing matrix, and the tables of a launch
    bare = sd.laid_w(wr, wi)
    assert bare.mpack is None and torch.equal(bare.wpack, wpack)
    w2, m2 = sd._w_tables(pr, pi, mix, bare)
    assert w2 is bare.wpack and torch.equal(m2, mpack)
    assert sd._w_tables(pr, pi, None, laid)[1] is None
    with pytest.raises(ValueError, match="table of"):
        sd._w_tables(pr[:400], pi[:400], None, laid)
    with pytest.raises(TypeError, match="LaidW"):
        sd._w_tables(pr, pi, None, wpack)


def test_detect_parts_and_slices():
    """The detect pass's partial sums a draw: one per 16 rows and W slice
    (slices of at most 208 px)."""
    assert sd.detect_parts(96) == 6 and sd.detect_parts(112) == 7
    assert sd.detect_parts(144) == 9 and sd.detect_parts(208) == 13
    assert sd.detect_parts(416) == 52 and sd.detect_parts(1040) == 325


def test_screens_pass_runs_plain_version_on_cpu():
    """On CPU tensors screens_pass is its plain version (no launch), the
    second pass of synth_screens_reference; it takes a laid W table."""
    _, t = k2_inputs(64, 20, 44, phase_rms=1.5)
    wr, wi, _ = padded(t)
    gr, gi = sd.synth_pass1_reference(SEED, t["s_t"], wr, wi, 3)
    before = sd.screens_pass.LAUNCHES
    got = sd.screens_pass(gr, gi, wr, wi, 24, laid=sd.laid_w(wr, wi))
    ref = sd.synth_screens_reference(SEED, t["s_t"], t["wr"], t["wi"], 3)
    assert sd.screens_pass.LAUNCHES == before
    assert got.shape == ref.shape == (6, 24, 24)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="npup"):
        sd.screens_pass(gr, gi, wr, wi, 33)
    with pytest.raises(ValueError, match="table of"):
        sd.screens_pass(gr, gi, wr, wi, laid=sd.laid_w(wr[:16], wi[:16]))


def test_wrappers_take_the_laid_table_on_cpu():
    """The wrappers accept the laid W table beside the plain one and run
    the plain version on the CPU, the same sums."""
    _, t = k2_inputs(64, 20, 44, phase_rms=1.5)
    laid = sd.laid_w(t["wr"], t["wi"], t["mix"])
    args = (7, t["s_t"], t["wr"], t["wi"], t["pm_t"], 3)
    torch.testing.assert_close(
        sd.synth_detect(*args, mix=t["mix"], laid=laid),
        sd.synth_detect(*args, mix=t["mix"]), rtol=0, atol=0)
    wr, wi, pm_t = padded(t)
    gr, gi = sd.synth_pass1_reference(SEED, t["s_t"], wr, wi, 3)
    torch.testing.assert_close(
        cd.detect_pass(gr, gi, wr, wi, pm_t, laid=laid),
        sd.detect_reference(gr, gi, wr, wi, pm_t), rtol=0, atol=0)
    with pytest.raises(ValueError, match="table of"):
        sd.synth_screens(7, t["s_t"], t["wr"][:16], t["wi"][:16], 2,
                         laid=laid)


# ---- on the card --------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


# (N, lo, hi, draws): the 256^2 and 512^2 flagships' 82 px pupil (96
# padded: two draws fill three blocks), the default config (N = P = 102,
# 112 padded: four draws, seven blocks), the ragged 144 px pupil on 192^2
# (four draws, nine blocks) and the 4 m link's 402 px on 1024^2 (416 in
# two slices of 208: two draws, thirteen blocks); each draw count leaves
# the last block part empty
CARD_CASES = [(256, 87, 169, 37), (512, 215, 297, 33), (102, 0, 102, 6),
              (192, 24, 168, 7), (1024, 311, 713, 5)]


def card_gprime(cuda_device, case, mixed):
    N, lo, hi, nb = case
    _, t = k2_inputs(N, lo, hi, phase_rms=1.5)
    t = {k: v.to(cuda_device) for k, v in t.items()}
    wr, wi, pm_t = padded(t)
    g = sd.synth_pass1_reference(SEED, t["s_t"], wr, wi, nb,
                                 mix=t["mix"] if mixed else None)
    return g, wr, wi, pm_t


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}x{c[3]}")
def test_detect_pass_alone_on_card(cuda_device, case):
    """The detect pass alone on the plain pass 1's G' (K2's 'mixed'), with
    and without subharmonic screens, within KERNEL_REL of its plain
    version; two launches give the same bits, and the per-call layout of
    W the laid table's."""
    N, lo, hi, nb = case
    (gr, gi), wr, wi, pm_t = card_gprime(cuda_device, case, True)
    laid = sd.laid_w(wr, wi)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    sh = torch.complex(*torch.randn((2, nb, hi - lo, hi - lo),
                                    device=cuda_device, generator=g))
    sh_t = sd.pack_subharm(sh, wr.shape[0])
    for shk in (None, sh_t):
        before = cd.detect_pass.LAUNCHES
        got = cd.detect_pass(gr, gi, wr, wi, pm_t, shk, laid=laid)
        again = cd.detect_pass(gr, gi, wr, wi, pm_t, shk, laid=laid)
        fresh = cd.detect_pass(gr, gi, wr, wi, pm_t, shk)
        ref = sd.detect_reference(gr, gi, wr, wi, pm_t, shk)
        torch.cuda.synchronize()
        assert cd.detect_pass.LAUNCHES == before + 3
        assert got.shape == ref.shape == (nb, 4)
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, again) and torch.equal(got, fresh)
        err = float((got - ref).abs().max())
        assert err <= KERNEL_REL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: f"N{c[0]}P{c[2] - c[1]}x{c[3]}")
def test_screens_pass_alone_on_card(cuda_device, case):
    """K7's screens pass alone on the plain pass 1's Box-Muller G', element
    by element within 2N 2^-24 max |phi| of its plain version; two
    launches give the same bits."""
    N, lo, hi, nb = case
    npup = hi - lo
    (gr, gi), wr, wi, _ = card_gprime(cuda_device, case, False)
    laid = sd.laid_w(wr, wi)
    before = sd.screens_pass.LAUNCHES
    got = sd.screens_pass(gr, gi, wr, wi, npup, laid=laid)
    again = sd.screens_pass(gr, gi, wr, wi, npup, laid=laid)
    ref = sd.screens_pass_reference(gr, gi, wr, wi, npup)
    torch.cuda.synchronize()
    assert sd.screens_pass.LAUNCHES == before + 2
    assert got.shape == ref.shape == (2 * nb, npup, npup)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    err = float((got - ref).abs().max())
    assert err <= 2 * N * 2.0 ** -24 * float(ref.abs().max())
