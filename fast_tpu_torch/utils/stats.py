"""Calibrated two-sample tests for stationary correlated series.

The port of ``fast_tpu.utils.stats``, with the same numpy/scipy
arithmetic, so that both packages give the same p-value on the same
samples. The temporal gates of the H100 dossier
(``scripts/torch_validate_hw.py`` §4) compare Monte Carlo *series* whose
samples are correlated in time (the AR(1)-in-Fourier frozen flow
decorrelates the power over ~D/(v dt) steps). A plain two-sample KS test
assumes iid samples and overcounts the effective sample size by the
integrated autocorrelation time: it rejects two identical processes, and
thinning the series by a fixed factor does not cure it.

* :func:`integrated_autocorr_time`: Sokal's self-consistent windowed
  estimator of tau_int = 1 + 2 sum_k rho(k).
* :func:`ks_2samp_correlated`: the two-sample KS statistic on the full
  samples, with a p-value at the effective sample sizes n / tau_int, tau
  estimated from the indicator processes 1{x_t <= q} at several pooled
  quantiles (the ECDF's variance follows the indicators' memory, which a
  heavy-tailed series can keep in its tail longer than its values).

Both take numpy arrays or torch tensors on any device; a tensor is copied
to the host as float64 first. Their calibration (null rejection at most
the nominal rate up to phi = 0.98, power against a scale shift) is that
of the JAX package's, whose values these equal
(``tests/test_torch_stats.py``). The formulas are standard (Sokal 1997
lecture notes; the asymptotic two-sample Kolmogorov distribution with
Stephens' small-sample correction).
"""

import numpy as np
import torch

__all__ = ["integrated_autocorr_time", "ks_2samp_correlated"]


def _host(x):
    """``x`` as a float64 numpy array (a tensor copied to the host)."""
    if torch.is_tensor(x):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _acf(x):
    """Biased-normalisation autocorrelation function via FFT; None for a
    constant series."""
    x = _host(x)
    n = x.size
    x = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conj(f), m)[:n]
    if acov[0] <= 0:
        return None
    return acov / acov[0]


def integrated_autocorr_time(x, c=5.0):
    """Sokal windowed estimate of the integrated autocorrelation time.

    tau_int(W) = 1 + 2 sum_{k<=W} rho(k), with the window W the smallest
    W >= c tau_int(W). Returns 1.0 for an uncorrelated or constant series;
    clipped to >= 1.

    Args:
        x: 1-D stationary series, or 2-D (nseries, nsteps): rows are
            independent realizations of one process (the autocorrelation
            never crosses a row seam) and tau comes from their averaged
            ACF. A numpy array or a tensor on any device.
        c: window constant (5 is standard).
    """
    x = _host(x)
    if x.ndim == 1:
        x = x[None]
    rhos = [r for r in (_acf(row) for row in x) if r is not None]
    if not rhos:
        return 1.0
    nmin = min(r.size for r in rhos)
    rho = np.mean([r[:nmin] for r in rhos], axis=0)
    taus = 1.0 + 2.0 * np.cumsum(rho[1:])
    ws = np.arange(1, taus.size + 1)
    hit = np.nonzero(ws >= c * taus)[0]
    tau = taus[hit[0]] if hit.size else taus[-1]
    return float(max(1.0, tau))


def ks_2samp_correlated(x, y, qs=(0.1, 0.25, 0.5, 0.75, 0.9), c=5.0):
    """Two-sample KS test for stationary correlated series.

    The exact two-sample statistic D on the full samples (no thinning),
    then the asymptotic p-value at the effective sample sizes n / tau_int,
    tau_int the largest integrated autocorrelation time of the indicator
    processes 1{x_t <= q} over the pooled quantiles ``qs`` (the largest,
    so that the gate does not reject identical processes).

    Args:
        x, y: 1-D series, or 2-D (nseries, nsteps) stacks of independent
            series of one process (a batched kernel's output): tau per the
            rows, D on the flattened values. Numpy arrays or tensors.
        qs: pooled-sample quantiles at which the indicator tau is taken.
        c: Sokal window constant.

    Returns:
        dict with ``D``, ``pvalue``, ``tau_x``, ``tau_y``, ``n_eff``.
    """
    from scipy.stats import kstwobign, ks_2samp

    x, y = _host(x), _host(y)
    xf, yf = x.ravel(), y.ravel()
    quants = np.quantile(np.concatenate([xf, yf]), qs)
    tau_x = max(integrated_autocorr_time(
        (x <= q).astype(np.float64), c=c) for q in quants)
    tau_y = max(integrated_autocorr_time(
        (y <= q).astype(np.float64), c=c) for q in quants)
    nx_eff = xf.size / tau_x
    ny_eff = yf.size / tau_y
    D = float(ks_2samp(xf, yf).statistic)
    en = np.sqrt(nx_eff * ny_eff / (nx_eff + ny_eff))
    # Stephens' small-sample correction to the asymptotic Kolmogorov
    # distribution (Numerical Recipes §14.3.3)
    p = float(kstwobign.sf((en + 0.12 + 0.11 / en) * D))
    return {"D": D, "pvalue": min(1.0, p), "tau_x": float(tau_x),
            "tau_y": float(tau_y), "n_eff": float(en ** 2)}
