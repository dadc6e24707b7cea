"""The AO-band terms of the PSD stage on the box of the mask's support.

``Jol_alias_openloop`` and ``G_AO_PAOLA`` evaluate on the rows and columns
that hold the non-zero points of their mask (``models.ao._band_box``) and
fill the rest of the grid with what the mask leaves there. Each must give
the same bits (``torch.equal``) as the whole grid's evaluation. The test
makes that with an all-ones mask, whose box is the whole grid, and then
applies the real mask as the whole-grid code did: ``nan_to_num(alias *
mask)`` and ``G * mask + (1 - mask)``.
"""

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch import psd
from fast_tpu_torch.grids import SpatialFrequencyStruct
from fast_tpu_torch.models import ao

torch.set_num_threads(1)


def link_params(**overrides):
    """The flagship link (0.8 m AO uplink at 1550 nm, 4-layer HV57/Bufton)
    on its 256^2 grid."""
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 256, "DX": 0.01, "NITER": 4, "NCHUNKS": 1,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "DTHETA": [4, 0], "H_TURB": h,
        "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 1,
        "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def small(**overrides):
    """The link on a 64^2 grid."""
    return dict(NPXLS=64, DX=0.02, **overrides)


def whole(mask):
    return slice(0, mask.shape[-2]), slice(0, mask.shape[-1])


def sim_case(grid="main", mask=None, **overrides):
    """A case from a ``Fast``: its grid, its mask (or ``mask(freq)``)
    and its PSD arguments."""
    sim = fast_tpu_torch.Fast(link_params(**overrides), device="cpu")
    freq = getattr(sim.freq, grid)
    lf = sim.lf_mask if grid == "main" else sim.lf_mask_subharm
    if mask is not None:
        lf = mask(freq)
    return dict(freq=freq, mask=torch.as_tensor(lf, dtype=torch.float64),
                mode=sim.ao_mode, Dsubap=sim.Dsubap, cn2=sim.cn2, h=sim.h,
                v=sim.wind_vector, dtheta=sim.dtheta, Tx=sim.D_ground,
                tl=sim.tloop, Delta_t=sim.texp, L0=sim.L0, l0=sim.l0)


def grid_case(mask, N=32, seed=5):
    """A grid of N^2 at 0.02 m (at N = 32 that of the parity tests against
    the JAX package), its mask ``mask(N)`` and three layers' winds drawn
    from ``seed``."""
    ax = np.arange(-N / 2, N / 2) * (2 * np.pi / (N * 0.02))
    freq = SpatialFrequencyStruct(ax)
    rng = np.random.default_rng(seed)
    return dict(freq=freq, mask=torch.as_tensor(mask(N), dtype=torch.float64),
                mode="AO", Dsubap=0.1, cn2=np.array([3e-14, 1e-14, 4e-15]),
                h=np.array([0.0, 5000.0, 10000.0]),
                v=rng.normal(size=(3, 2)) * 10, dtheta=(4, 1), Tx=0.8,
                tl=0.001, Delta_t=0.001, L0=20.0, l0=1e-6)


def rectangle(rows, cols):
    def mask(N):
        m = np.zeros((N, N))
        m[rows, cols] = 1.0
        return m
    return mask


def scattered(N):
    return (np.random.default_rng(6).random((N, N)) > 0.3).astype(float)


CASES = {
    "flagship-zenith0": lambda: sim_case(ZENITH_ANGLE=0),
    "flagship-zenith60": lambda: sim_case(ZENITH_ANGLE=60),
    "modal-radial": lambda: sim_case(
        **small(MODAL=True, MODAL_MULT=0.8)),
    "modal-zmax": lambda: sim_case(**small(MODAL=True, ZMAX=10)),
    "modal-gtilt": lambda: sim_case(mask=lambda f: ao.mask_lf(
        f, 0.1, modal=True, Zmax=10, D=0.8, Gtilt=True), **small()),
    "tt": lambda: sim_case(**small(AO_MODE="TT")),
    "lgsao": lambda: sim_case(**small(AO_MODE="LGSAO")),
    "subharmonic-levels": lambda: sim_case(grid="subharm",
                                           **small(SUBHARM=True)),
    # holds neither the zero row, the zero column nor DC
    "off-centre": lambda: grid_case(rectangle(slice(3, 10), slice(20, 27))),
    # 18 columns: three points differ in their last bit unless the box is
    # widened to whole vector steps
    "odd-width": lambda: grid_case(rectangle(slice(27, 39), slice(23, 41)),
                                   N=64, seed=0),
    "all-zero": lambda: grid_case(lambda N: np.zeros((N, N))),
    "scattered": lambda: grid_case(scattered),
}


def alias(c, mask):
    return ao.Jol_alias_openloop(c["freq"], c["Dsubap"], c["cn2"], mask,
                                 c["v"], c["Delta_t"], lmax=5, kmax=5,
                                 L0=c["L0"], l0=c["l0"])


def paola(c, mask):
    return ao.G_AO_PAOLA(c["freq"], mask, c["mode"], c["h"], c["v"],
                         c["dtheta"], c["Tx"], tl=c["tl"],
                         Delta_t=c["Delta_t"])


@pytest.mark.parametrize("case", list(CASES))
def test_band_terms_equal_whole_grid(case):
    c = CASES[case]()
    mask = c["mask"]
    ones = torch.ones_like(mask)
    assert ao._band_box(ones) == whole(mask)
    got = alias(c, mask)
    ref = torch.nan_to_num(alias(c, ones) * mask, nan=0.0, posinf=0.0,
                           neginf=0.0)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)
    got = paola(c, mask)
    ref = paola(c, ones) * mask + (1 - mask)
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


def test_band_box_of_an_empty_mask():
    assert ao._band_box(torch.zeros((8, 32))) == (slice(0, 0), slice(0, 0))


def test_band_box_bounds_the_support():
    m = torch.zeros((2, 40, 48))
    m[0, 5, 7] = 0.5
    m[1, 12, 30] = 1.0
    rows, cols = ao._band_box(m)
    assert rows == slice(5, 13)
    # columns 7..30 widened to 32, shifted left at the grid's edge
    assert cols == slice(7, 39) and (cols.stop - cols.start) % ao._LANES == 0
    m[1, 0, 47] = 1.0
    assert ao._band_box(m) == (slice(0, 13), slice(0, 48))


def test_assemble_main_equals_whole_grid(monkeypatch):
    sim = fast_tpu_torch.Fast(link_params(), device="cpu")
    g = sim.freq.main
    grid, rest, flags = sim._psd_args(g)
    args = (*grid, g.f, sim.lf_mask, sim.hf_mask, sim.pupil_filter, *rest)
    got = psd.assemble_main(*args, **flags)
    monkeypatch.setattr(ao, "_band_box", whole)
    ref = psd.assemble_main(*args, **flags)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("overrides,share", [
    # rows and columns 116-140 of 256, the columns widened to 32
    (dict(), 25 * 32 / 256 ** 2),
    # a WFS band past the grid's edge: the whole grid
    (dict(NPXLS=64, DX=0.02, DSUBAP=0.02), 1.0),
    (dict(NPXLS=64, DX=0.02, AO_MODE="NOAO"), 0.0),
], ids=["flagship", "whole-grid", "noao"])
def test_psd_band_share(overrides, share):
    sim = fast_tpu_torch.Fast(link_params(**overrides), device="cpu")
    assert sim.psd_band_share == share
    if share == 1.0:
        assert (sim.lf_mask == 1).all()
