"""fast_tpu_torch.utils.stats against fast_tpu.utils.stats, on the CPU.

The port keeps its own copy of the calibrated KS for correlated series
(``integrated_autocorr_time``, ``ks_2samp_correlated``) with the same
numpy/scipy arithmetic, so on the same samples it gives the same values:
checked here to 1e-12 relative on seeded numpy series (1-D, 2-D with row
seams, constant, fewer than 10 samples, AR(1) at phi = 0, 0.9, 0.98), and
for tensor inputs, which the port takes too. The calibration of the JAX
package's statistic (``tests/test_stats_calibration.py``: the null rejects
at most at the nominal rate, the test has power) carries over through that
equality; its tau-theory and batched-null cases run once more against the
port here, its 120-repetition null test does not.
"""

import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from fast_tpu.utils import stats as jstats
from fast_tpu_torch.utils import stats as tstats

torch.set_num_threads(1)

REL = 1e-12


def ar1_lognormal(rng, n, phi, scale=1.0, burn=512):
    """exp(z_t) with z an AR(1) of unit marginal variance."""
    eps = rng.standard_normal(n + burn) * np.sqrt(1.0 - phi ** 2)
    z = lfilter([1.0], [1.0, -phi], eps)
    return scale * np.exp(z[burn:])


def _series(kind, draw=0):
    rng = np.random.default_rng([KINDS.index(kind), draw])
    if kind == "1-D":
        return rng.standard_normal(4096)
    if kind == "2-D rows":
        return np.stack([ar1_lognormal(rng, 2048, 0.9) for _ in range(4)])
    if kind == "constant":
        return np.full(512, 3.25)
    if kind == "short":
        return rng.standard_normal(7)
    phi = float(kind.split("=")[1])
    return ar1_lognormal(rng, 8192, phi)


KINDS = ["1-D", "2-D rows", "constant", "short", "phi=0.0", "phi=0.9",
         "phi=0.98"]


def _close(got, ref):
    assert abs(got - ref) <= REL * max(abs(ref), 1e-300), (got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_integrated_autocorr_time_is_fast_tpus(kind):
    x = _series(kind)
    _close(tstats.integrated_autocorr_time(x),
           jstats.integrated_autocorr_time(x))
    _close(tstats.integrated_autocorr_time(x, c=3.0),
           jstats.integrated_autocorr_time(x, c=3.0))


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "constant"])
def test_ks_2samp_correlated_is_fast_tpus(kind):
    x = _series(kind)
    y = 1.05 * _series(kind, draw=1)
    got = tstats.ks_2samp_correlated(x, y)
    ref = jstats.ks_2samp_correlated(x, y)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
    got = tstats.ks_2samp_correlated(x, y, qs=(0.2, 0.8), c=4.0)
    ref = jstats.ks_2samp_correlated(x, y, qs=(0.2, 0.8), c=4.0)
    for k in ref:
        _close(got[k], ref[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tensor_inputs_give_the_numpy_result(dtype):
    rng = np.random.default_rng(11)
    x = ar1_lognormal(rng, 4096, 0.9)
    y = ar1_lognormal(rng, 4096, 0.9)
    xt, yt = torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype)
    # the tensor is read as float64 on the host: its own values
    xn = xt.double().numpy()
    yn = yt.double().numpy()
    assert (tstats.integrated_autocorr_time(xt)
            == tstats.integrated_autocorr_time(xn))
    assert tstats.ks_2samp_correlated(xt, yt) == \
        tstats.ks_2samp_correlated(xn, yn)
    assert tstats.ks_2samp_correlated(xt, yn) == \
        tstats.ks_2samp_correlated(xn, yn)


def test_integrated_autocorr_time_matches_theory():
    # AR(1) value process: tau_int = (1 + phi) / (1 - phi)
    rng = np.random.default_rng(0)
    for phi, n in ((0.0, 16384), (0.9, 65536)):
        eps = rng.standard_normal(n + 512) * np.sqrt(1 - phi ** 2)
        z = lfilter([1.0], [1.0, -phi], eps)[512:]
        tau = tstats.integrated_autocorr_time(z)
        expect = (1 + phi) / (1 - phi)
        assert expect / 1.4 < tau < expect * 1.4


def test_tau_respects_row_seams():
    rng = np.random.default_rng(1)
    x2d = np.stack([ar1_lognormal(rng, 8192, 0.9) for _ in range(4)])
    tau2d = tstats.integrated_autocorr_time(np.log(x2d))
    expect = (1 + 0.9) / (1 - 0.9)
    assert expect / 1.5 < tau2d < expect * 1.5


def test_batched_null():
    # the dossier's batched-against-single row compares an (8, T) stack
    # with a stack of singles: the null passes there too
    rng = np.random.default_rng(9)
    xb = np.stack([ar1_lognormal(rng, 4096, 0.9) for _ in range(8)])
    yb = np.stack([ar1_lognormal(rng, 4096, 0.9) for _ in range(8)])
    out = tstats.ks_2samp_correlated(xb, yb)
    assert out["pvalue"] > 1e-3
    assert out["n_eff"] > 100
