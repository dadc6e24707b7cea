"""``PRECISION`` in fast_tpu_torch, on the CPU.

* The values and what they mean: the keys of the JAX package's table
  (``fast_tpu.ops.pallas_synth._PRECISIONS``, read as data), one TF32
  pass at 'default' where the JAX package has its single-pass DEFAULT,
  three (3xTF32) at 'high' and 'highest' where it has HIGHEST; an unknown
  value raises in the config, in ``Fast`` and in the wrappers, as
  ``_PRECISIONS[name]`` does.
* The plain versions at 'default' against the JAX package's functions on
  the same seeded numpy inputs and zero bits (the Pallas interpreter's
  PRNG yields zero bits, as ``tests/test_pallas.py`` runs it, at
  ``precision="highest"``): K2, K1, K3 and the AR kernels' two products.
  The tolerance is derived from TF32's rounding: an operand rounded to
  nearest on 10 stored mantissa bits is off by at most U = 2^-11 of
  itself, a relative error taken as uniform on [-U, U] and independent
  from element to element (variance U^2 / 3). Each product's error
  variance is that of its terms' roundings plus its operands' own error
  variances carried through it (:func:`var_mm`, first order), and a sum
  of pm cos or pm sin has at most the variance of its phases' errors
  weighted by pm^2; the plain version at 'default' must agree with the
  JAX package's output within 6 such standard deviations plus twice what
  the plain version at 'highest' reads against it (the fp32 orders), and
  differ from the 'highest' one (the products were rounded).
* A CPU ``Fast.run()`` is the same bit for bit at every value: the JAX
  package's CPU dots are native fp32 whatever the key says, and the
  port's CPU runs compute fp32 alike (``engine.run_precision``).
"""

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch import conf
from fast_tpu_torch.engine import run_precision
from fast_tpu_torch.ops import ar_flow as af
from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops import synth_detect as sd
from test_torch_ar_flow import ar_inputs, tensors
from test_torch_colfac import k1_inputs, small_params
from test_torch_synth_detect import k2_inputs

torch.set_num_threads(1)

U = 2.0 ** -11   # TF32's unit roundoff (10 stored mantissa bits, nearest)
S2 = U * U / 3   # variance of a relative rounding error uniform on [-U, U]
SIGMAS = 6.0


def var_mm(a, b, va=None, vb=None):
    """The error variance of ``a @ b`` with both operands rounded to TF32
    (each element's relative error of variance S2, independent), plus the
    operands' own error variances ``va``, ``vb`` carried through it."""
    v = 2 * S2 * ((a * a) @ (b * b))
    if va is not None:
        v = v + va @ (b * b)
    if vb is not None:
        v = v + (a * a) @ vb
    return v


def var_detect(gr, gi, vgr, vgi, wr, wi, pm_t):
    """The error variance of the detect pass's four sums of one G' (N, P),
    its products H = W G' rounded, from G''s own error variances: the sums
    of pm cos and pm sin of Re H, then of Im H."""
    vh1 = var_mm(wr, gr, None, vgr) + var_mm(wi, gi, None, vgi)
    vh2 = var_mm(wr, gi, None, vgi) + var_mm(wi, gr, None, vgr)
    return [float((pm_t * pm_t * v).sum()) for v in (vh1, vh1, vh2, vh2)]


def check(got, fp32, ref, var):
    """``got`` (the plain version at 'default') within SIGMAS standard
    deviations (``var``: each column's variance, or one per sum) plus
    twice ``fp32``'s reading (the plain version at 'highest') of ``ref``,
    the JAX package's output; and not ``fp32`` itself."""
    sigma = torch.as_tensor(var, dtype=torch.float64).sqrt()
    tol = SIGMAS * sigma + 2 * float((fp32 - ref).abs().max())
    assert bool(((got - ref).abs() <= tol).all())
    assert float((got - fp32).abs().max()) > 0.0


def test_values_are_the_jax_packages():
    import jax
    from fast_tpu.ops import pallas_synth
    table = pallas_synth._PRECISIONS
    assert set(conf.PASSES) == set(table) == set(sd.PASSES)
    for name, prec in table.items():
        one = prec == jax.lax.Precision.DEFAULT
        assert sd.passes(name) == (1 if one else 3)
    assert conf.TPU_DEFAULTS["PRECISION"] == "default"
    assert sd.passes("high") == sd.passes("highest") == 3


@pytest.mark.parametrize("bad", ["bf16", "HIGHEST", None, 3])
def test_unknown_value_raises(bad):
    from fast_tpu.ops import pallas_synth
    with pytest.raises(KeyError):
        pallas_synth._PRECISIONS[bad]
    with pytest.raises(ValueError, match="precision"):
        sd.passes(bad)
    with pytest.raises(ValueError, match="PRECISION"):
        conf.ConfigParser({**conf.DEFAULTS, "PRECISION": bad})
    _, t = k2_inputs()
    with pytest.raises(ValueError, match="precision"):
        sd.synth_detect(1, t["s_t"], t["wr"], t["wi"], t["pm_t"], 2,
                        precision=bad)


def test_run_precision_is_fp32_on_the_cpu():
    for name in conf.PASSES:
        assert run_precision(name, torch.device("cpu")) == "highest"
        assert run_precision(name, torch.device("cuda")) == name
    with pytest.raises(ValueError):
        run_precision("bf16", torch.device("cpu"))


def test_operand_rounding_is_tf32_at_default():
    """'default' rounds both operands of a product to TF32 (the kernels'
    cvt.rna), the other values pass them as they are."""
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn((5, 7), generator=g), torch.randn((7, 3), generator=g)
    assert torch.equal(sd.mm(a, b, "highest"), a @ b)
    assert torch.equal(sd.mm(a, b, "high"), a @ b)
    assert torch.equal(sd.mm(a, b, "default"), sd._tf32(a) @ sd._tf32(b))
    assert float((sd._tf32(a) - a).abs().max()) <= U * float(a.abs().max())
    assert not torch.equal(sd.mm(a, b, "default"), a @ b)


def sum_vars(v, nbatch):
    """:func:`var_detect`'s four variances of one draw in the layout of
    the kernels' (2 nbatch, 2) output, every draw alike (zero bits)."""
    return torch.tensor([v[:2]] * nbatch + [v[2:]] * nbatch)


@pytest.mark.parametrize("noise", ["mixed", "gauss"])
def test_k2_plain_at_default_against_jax(noise):
    from fast_tpu.ops import pallas_synth
    (sqrt_ps, df, W, pm), t = k2_inputs(phase_rms=1.5)
    nbatch, N = 4, 64
    ref = torch.from_numpy(np.array(pallas_synth.fused_synthesis_detect(
        1, sqrt_ps, df, nbatch, W, pm, interpret=True, precision="highest",
        noise=noise)))
    zero = torch.zeros((nbatch, N, N), dtype=torch.int64)
    mix = t["mix"] if noise == "mixed" else None
    args = (0, t["s_t"], t["wr"], t["wi"], t["pm_t"], nbatch)
    got, fp32 = (sd.synth_detect_reference(*args, mix=mix, bits=(zero, zero),
                                           precision=p)
                 for p in ("default", "highest"))
    # one draw's chain: z = u M ('mixed'), X' = z s_t, G' = X' W^T, W G'
    s_t, wr, wi = t["s_t"], t["wr"], t["wi"]
    if mix is None:
        z = sd.box_muller(zero[0], zero[0])
        vz = (torch.zeros_like(z[0]),) * 2
    else:
        u = sd.uniforms(zero[0])
        z, vz = (u @ mix,) * 2, (var_mm(u, mix),) * 2
    xr, xi = z[0] * s_t, z[1] * s_t
    vxr, vxi = vz[0] * s_t ** 2, vz[1] * s_t ** 2
    gr, gi = xr @ wr.T - xi @ wi.T, xr @ wi.T + xi @ wr.T
    vgr = var_mm(xr, wr.T, vxr) + var_mm(xi, wi.T, vxi)
    vgi = var_mm(xr, wi.T, vxr) + var_mm(xi, wr.T, vxi)
    var = var_detect(gr, gi, vgr, vgi, wr, wi, t["pm_t"])
    assert got.shape == ref.shape == (2 * nbatch, 2)
    check(got, fp32, ref, sum_vars(var, nbatch))


@pytest.mark.parametrize("noise", ["mixed", "gauss"])
def test_k1_plain_at_default_against_jax(noise):
    from fast_tpu.ops import pallas_synth
    mixed = noise == "mixed"
    (L, W, pm), t = k1_inputs(mixed=mixed, phase_rms=1.5)
    nbatch, N = 4, 64
    ref = torch.from_numpy(np.array(pallas_synth.fused_colfac_detect(
        1, L, W, pm, nbatch, interpret=True, precision="highest",
        noise=noise)))
    S = t["S"]
    K, P = S.shape[1], S.shape[2]
    zero = torch.zeros((nbatch, N, K // 2), dtype=torch.int64)
    args = (0, S, t["wr"], t["wi"], t["pm_t"], nbatch)
    got, fp32 = (cd.colfac_detect_reference(*args, mixed=mixed,
                                            bits=(zero, zero), precision=p)
                 for p in ("default", "highest"))
    # one draw's chain: G'[m] = z_m S_m (the real-block product), W G'
    z = torch.stack([sd.uniforms(zero[0])] * 2 if mixed
                    else sd.box_muller(zero[0], zero[0]), -1)
    z, st = z.reshape(N, 1, K), S.reshape(N, K, 2 * P)
    g, vg = (z @ st).reshape(N, P, 2), var_mm(z, st).reshape(N, P, 2)
    var = var_detect(g[..., 0], g[..., 1], vg[..., 0], vg[..., 1],
                     t["wr"], t["wi"], t["pm_t"])
    check(got, fp32, ref, sum_vars(var, nbatch))


def test_k3_plain_at_default_against_jax():
    """K3's split layout (a 40 px pupil: the layout, not the width, is what
    differs from K1), Box-Muller noise on zero bits."""
    from fast_tpu.ops import pallas_synth
    from test_torch_wide_pupil import k3_inputs
    (L, W, pm), t = k3_inputs(N=64, lo=0, hi=40, mixed=False, phase_rms=1.5)
    nbatch, N = 3, 64
    ref = torch.from_numpy(np.array(pallas_synth.fused_colfac_detect(
        1, L, W, pm, nbatch, interpret=True, precision="highest",
        noise="gauss", layout="split")))
    T = t["T"]
    zero = torch.zeros((nbatch, N, T.shape[1]), dtype=torch.int64)
    args = (0, T, t["wr"], t["wi"], t["pm_t"], nbatch)
    got, fp32 = (cd.colfac_split_reference(*args, mixed=False,
                                           bits=(zero, zero), precision=p)
                 for p in ("default", "highest"))
    # one draw's chain: G'[m] = z_m B_m (complex), W G'
    zr, zi = (z[:, None, :] for z in sd.box_muller(zero[0], zero[0]))
    tr, ti = T[..., 0], T[..., 1]
    gr, gi = (zr @ tr - zi @ ti)[:, 0], (zr @ ti + zi @ tr)[:, 0]
    vgr = (var_mm(zr, tr) + var_mm(zi, ti))[:, 0]
    vgi = (var_mm(zr, ti) + var_mm(zi, tr))[:, 0]
    var = var_detect(gr, gi, vgr, vgi, t["wr"], t["wi"], t["pm_t"])
    check(got, fp32, ref, sum_vars(var, nbatch))


@pytest.mark.parametrize("noise", [None, "uniform"])
def test_ar_products_at_default_against_jax(noise):
    """K4's plain version (its two products, ``ar_dft`` and ``ar_detect``,
    at 'default') against ``ar_flow_fused`` in the interpreter: the update
    is the same at every precision, so the final state is the same bit for
    bit and agrees with the JAX package's as at 'highest'."""
    import jax.numpy as jnp
    from fast_tpu.ops import pallas_synth
    nsteps, L = 6, 2
    a0, ph, ns, W, pm = inp = ar_inputs(L=L, seed=9,
                                        boiling=noise is not None)
    c_ref, a_ref = pallas_synth.ar_flow_fused(
        1, jnp.asarray(a0), jnp.asarray(ph),
        None if ns is None else jnp.asarray(ns), W, pm, nsteps,
        interpret=True, precision="highest", noise=noise or "uniform")
    bits = None if noise is None else "zero"
    (c, a), (c32, a32) = (af.ar_flow_reference(
        1, *tensors(inp), nsteps, noise=noise or "uniform", bits=bits,
        precision=p) for p in ("default", "highest"))
    assert torch.equal(a, a32)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=1e-4,
                               atol=1e-6)
    # each step's chain: G' = A^T W^T of the layer sum A, Re(W G')
    _, _, _, wr, wi, pm_t = af._pack(*tensors(inp))
    st = torch.from_numpy(a0).to(torch.complex128)
    z = float(sd.uniforms(torch.zeros(())))  # zero bits' noise, both parts
    var = []
    for _ in range(nsteps):
        st = torch.from_numpy(ph) * st
        if noise is not None:
            st = st + torch.from_numpy(ns) * complex(z, z)
        A = st.sum(0).T.to(torch.complex64)
        ar, ai = A.real.contiguous(), A.imag.contiguous()
        gr, gi = ar @ wr.T - ai @ wi.T, ar @ wi.T + ai @ wr.T
        vgr = var_mm(ar, wr.T) + var_mm(ai, wi.T)
        vgi = var_mm(ar, wi.T) + var_mm(ai, wr.T)
        vphi = var_mm(wr, gr, None, vgr) + var_mm(wi, gi, None, vgi)
        var.append([float((pm_t[0] ** 2 * vphi).sum())] * 2)
    check(c, c32, torch.from_numpy(np.asarray(c_ref)), var)


@pytest.mark.parametrize("synth,extra", [
    ("pallas_fused", {}), ("pallas_colfac", {}),
    ("matmul", {}), ("pallas", {}),
    ("auto", {"TEMPORAL": True, "TEMPORAL_SYNTH": "ar"})])
def test_cpu_run_is_the_same_at_every_value(synth, extra):
    """``Fast.run()`` on the CPU at 'default', 'high' and 'highest': the
    same series bit for bit, on the kernels' plain versions, the stock
    paths and the AR route."""
    runs = []
    for prec in ("default", "high", "highest"):
        p = small_params(SYNTH=synth, PRECISION=prec, NITER=64, NCHUNKS=2,
                         **extra)
        sim = fast_tpu_torch.Fast(p, device="cpu")
        assert sim._precision == "highest"
        runs.append(np.asarray(sim.run()._r))
    assert all(np.array_equal(runs[0], r) for r in runs[1:])
    assert np.isfinite(runs[0]).all()
