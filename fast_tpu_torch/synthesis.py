"""Monte Carlo synthesis in stock torch ops: phase screens and detector.

The plain paths of the iid run (``SYNTH='matmul'``, ``'colfac'`` and
``'fft'``), the tables every path shares (the pruned inverse-DFT matrix,
the per-column Cholesky factors of the colfac basis, the subharmonic
modes), the subharmonic screens, the log-amplitude draws, and the temporal
mode's stock-op pieces (per-layer frozen-flow screens and their sampling,
the AR(1)-in-Fourier recursion). The iid chain:

    complex normals -> colour by sqrt(PSD) df -> pruned (or full) centred
    inverse DFT -> real and imaginary parts as two screens -> pupil-overlap
    coupling

The Hermitian doubling trick of the reference (``fast/funcs.py:220-222``)
is kept: one complex draw gives two independent screens.
"""

import contextlib

import numpy as np
import torch

from .ops.fourier import ft, ift2
from .ops.interp import bilinear_periodic
from .ops.rng import complex_normal


def pruned_ift2_matrix(N, lo, hi, dtype=np.complex64):
    """Rows ``[lo, hi)`` of the centred inverse-DFT matrix (host numpy).

    ``W[u, v] = exp(2j pi (u - N/2)(v - N/2) / N)``. Applied from both
    sides it computes exactly the pupil-cropped part of ``ift2(X, 1)``.
    """
    u = np.arange(lo, hi) - N / 2
    v = np.arange(N) - N / 2
    W = np.exp(2j * np.pi * np.outer(u, v) / N)
    return W.astype(np.dtype(dtype))


def synthesize_screens_complex(generator, sqrt_powerspec, df, nbatch,
                               crop=None):
    """``nbatch`` complex screens by batched centred ifft2, cropped to
    ``crop = (lo, hi)`` on both axes if given."""
    cdtype = (torch.complex64 if sqrt_powerspec.dtype == torch.float32
              else torch.complex128)
    rand = complex_normal((nbatch,) + tuple(sqrt_powerspec.shape), generator,
                          dtype=cdtype)
    scr = ift2(rand * (sqrt_powerspec * df), 1.0)
    if crop is not None:
        lo, hi = crop
        scr = scr[..., lo:hi, lo:hi]
    return scr


def synthesize_screens_pruned(generator, sqrt_powerspec, df, nbatch, W):
    """Pupil-cropped complex screens ``W @ X @ W^T`` by matrix products."""
    rand = complex_normal((nbatch,) + tuple(sqrt_powerspec.shape), generator,
                          dtype=W.dtype)
    rand = rand * (sqrt_powerspec * df)
    return W @ rand @ W.T


def _factor(C, jitter, floor):
    """Cholesky factors of the batched Hermitian ``C`` with a diagonal
    jitter of ``jitter`` times each matrix's mean diagonal, floored at
    ``1e-3`` of the batch mean plus ``floor`` so that fully masked columns
    factor; failed factors come back as NaN."""
    tr = torch.diagonal(C, dim1=-2, dim2=-1).real.sum(-1) / C.shape[-1]
    tr = torch.maximum(tr, tr.mean() * 1e-3 + floor)
    eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
    L, info = torch.linalg.cholesky_ex(C + (jitter * tr)[:, None, None] * eye)
    L[info != 0] = float("nan")
    return L


def column_factors(sqrt_powerspec, df, W, jitter=1e-10):
    """Per-column Cholesky factors of the pupil-row covariance, float64 on
    the CPU.

    The columns of ``G = W X`` are independent with covariance
    ``C_m = A_m A_m^H``, ``A_m = W diag(S[:, m] df)``; drawing
    ``G[:, m] = L_m z_m`` is the same process with Npup instead of N
    random numbers per column (``fast_tpu.synthesis.column_factors``).
    Returns an (N, Npup, Npup) complex128 tensor.
    """
    W = torch.as_tensor(np.asarray(W, np.complex128))
    S = torch.as_tensor(np.asarray(sqrt_powerspec, np.float64) * float(df))
    A = W[None, :, :] * S.T[:, None, :]          # (cols, Npup, N)
    return _factor(A @ A.conj().transpose(1, 2), jitter, 1e-300)


@contextlib.contextmanager
def _full_fp32():
    """Matrix products in full float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def column_factors_device(sqrt_powerspec, df, W, device, jitter=3e-6):
    """The column factors in float32 on ``device``: batched products, 128
    columns at a time, and one batched Cholesky
    (``fast_tpu.synthesis.column_factors_device``).

    The f32 factors reproduce the column covariances to ~1e-6 relative. A
    column whose f32 Cholesky fails comes back as NaN, and the caller falls
    back to :func:`column_factors`. Returns (N, Npup, Npup) complex64 on
    ``device``. The blocks bound the (128, Npup, N) intermediate: 0.4 GB at
    N=1024 with a 402 px pupil, where all columns at once take 3.4 GB.
    """
    W = torch.as_tensor(np.asarray(W).astype(np.complex64), device=device)
    S = torch.as_tensor((np.asarray(sqrt_powerspec) * float(df))
                        .astype(np.float32), device=device)
    npup, N = W.shape
    C = torch.empty((N, npup, npup), dtype=torch.complex64, device=device)
    with _full_fp32():
        for m0 in range(0, N, 128):
            A = W[None, :, :] * S.T[m0:m0 + 128, None, :]
            C[m0:m0 + 128] = A @ A.conj().transpose(1, 2)
    return _factor(C, jitter, 1e-30)


def synthesize_screens_colfac(generator, L, W, nbatch):
    """Pupil-cropped complex screens from the column factors ``L``: the
    noise is drawn in the (Npup x N) basis of ``G = W X``, then ``G W^T``.
    The same process as :func:`synthesize_screens_pruned`."""
    ncols, npup, _ = L.shape
    z = complex_normal((nbatch, ncols, npup), generator, dtype=L.dtype)
    G = torch.einsum("mpq,bmq->bpm", L, z)
    return torch.einsum("bpm,cm->bpc", G, W.to(L.dtype))


def make_subharm_modes(subharm_fx, subharm_fy, N, dx):
    """Complex exponential modes ``exp(i(x fx + y fy))`` of the subharmonic
    grids on the real-space grid of the main screen: (levels, 3, 3, N, N)
    complex128 host numpy (``fast_tpu.synthesis.make_subharm_modes``)."""
    D = dx * N
    coords = np.arange(-D / 2, D / 2, dx)
    if len(coords) == N + 1:
        coords = coords[:-1]
    x, y = np.meshgrid(coords, coords)
    fx = np.asarray(subharm_fx, dtype=np.float64)
    fy = np.asarray(subharm_fy, dtype=np.float64)
    phase = (x[None, None, None] * fx[..., None, None]
             + y[None, None, None] * fy[..., None, None])
    return np.exp(1j * phase)


def subharm_mode_table(modes, crop):
    """Each mode less its mean over the full grid, then cropped to
    ``crop = (lo, hi)`` on both axes: (levels, 3, 3, P, P).

    A subharmonic screen is mean-subtracted over the full grid before the
    pupil crop (``fast/funcs.py:253``); subtracting each mode's mean once
    here gives the same screens without ever forming a full-grid one.
    """
    lo, hi = crop
    return (modes[..., lo:hi, lo:hi]
            - modes.mean(axis=(-2, -1), keepdims=True))


def synthesize_subharm_complex(generator, sqrt_powerspec_sh, df_sh,
                               mode_table, nbatch):
    """Low-order subharmonic screens: ``nbatch`` complex (P, P) screens as
    sums of the 27 modes of :func:`subharm_mode_table` with complex normal
    weights of variance ``PSD df^2`` per level."""
    cdtype = (torch.complex64 if sqrt_powerspec_sh.dtype == torch.float32
              else torch.complex128)
    rand = complex_normal((nbatch,) + tuple(sqrt_powerspec_sh.shape),
                          generator, dtype=cdtype)
    weights = rand * (sqrt_powerspec_sh * df_sh[:, None, None])
    return torch.einsum("bimn,imnxy->bxy", weights, mode_table.to(cdtype))


def double_screens(scr):
    """Split complex screens into twice as many real ones."""
    return torch.cat([scr.real, scr.imag], dim=0)


def detector_coupling(phs, pupil_mode, dx, normalisation):
    """``sum(pupil * mode * exp(i phs)) * dx^2 / norm`` per screen
    (``fast/fast.py:647-657``)."""
    pm = pupil_mode.to(phs.dtype)
    c = torch.complex((torch.cos(phs) * pm).sum((-2, -1)),
                      (torch.sin(phs) * pm).sum((-2, -1)))
    return c * (dx ** 2 / normalisation)


def synthesize_layer_screens(generator, sqrt_powerspec_per_layer, df):
    """One real frozen-flow screen per layer (``fast/fast.py:611-614``):
    (nlayers, N, N) from the per-layer ``sqrt(PSD)``."""
    sqrt_ps = sqrt_powerspec_per_layer
    cdtype = (torch.complex64 if sqrt_ps.dtype == torch.float32
              else torch.complex128)
    rand = complex_normal(tuple(sqrt_ps.shape), generator, dtype=cdtype)
    return ift2(rand * (sqrt_ps * df), 1.0).real


def sample_frozen_flow(screens, row_coords, col_coords):
    """The summed phase along the frozen-flow trajectory.

    ``screens`` (nlayers, N, N) periodic; ``row_coords`` and
    ``col_coords`` (nlayers, T, Npup) fractional pixel coordinates of the
    pupil's rows and columns at each step. Returns (T, Npup, Npup): per
    layer the periodic bilinear samples on the outer product of its row
    and column coordinates, summed over the layers
    (``fast/fast.py:619-633`` without the spline and the wrap
    bookkeeping).
    """
    phs = 0
    for scr, rows, cols in zip(screens, row_coords, col_coords):
        phs = phs + bilinear_periodic(scr, rows[:, :, None], cols[:, None, :])
    return phs


def ar_step_phase(fx, fy, wind_vector, dt):
    """The per-step translation phase ``kappa . v dt`` of every layer and
    mode, wrapped into (-pi, pi] in float64 (host numpy): the raw phase
    grows with ``|kappa|`` and a float32 cast would lose the fractional
    cycle that is all that matters. ``fx``, ``fy`` (N, N) meshes,
    ``wind_vector`` (nlayers, 2); returns (nlayers, N, N)."""
    v = np.asarray(wind_vector, np.float64)
    fx = np.asarray(fx, np.float64)
    fy = np.asarray(fy, np.float64)
    phase = (fx[None] * v[:, 0, None, None]
             + fy[None] * v[:, 1, None, None]) * float(dt)
    return np.angle(np.exp(1j * phase))


def _ar_noise(noise, step, a):
    """Complex unit noise of one step: from a ``torch.Generator``, or from
    a callable of the absolute step (the AR kernels' Philox stream,
    :class:`fast_tpu_torch.ops.ar_flow.NoiseStream`)."""
    if isinstance(noise, torch.Generator):
        return complex_normal(tuple(a.shape), noise, dtype=a.dtype)
    return noise(step)


def ar_flow_series(a, noise, step_phasor, sqrt_psd_df, alpha, sqrt1ma, nsteps,
                   boiling, step0=0):
    """Evolve the AR(1)-in-Fourier frozen-flow state by ``nsteps`` steps.

    Per Fourier mode kappa and layer l (Srinath et al. 2015,
    arXiv:1512.05424):

        a[t+1] = alpha_l * e^{i kappa . v_l dt} * a[t]
                 + sqrt(1 - alpha_l^2) * sqrt(PSD_l) df * zeta[t]

    The unit phasor is exact periodic translation on the fixed grid;
    ``alpha < 1`` adds per-mode boiling that also keeps the series from
    wrapping periodically. The stationary distribution equals the standard
    FFT screen draw for any ``alpha``.

    Args:
        a: (nlayers, N, N) complex state at the block start.
        noise: a ``torch.Generator`` or a callable ``noise(step)`` giving
            the complex (nlayers, N, N) unit noise of an absolute step;
            read only when ``boiling``.
        step_phasor: (nlayers, N, N) complex ``e^{i kappa . v dt}``.
        sqrt_psd_df: (nlayers, N, N) real ``sqrt(PSD) * df``.
        alpha, sqrt1ma: (nlayers, 1, 1) AR factors.
        nsteps: block length.
        boiling: False skips the noise (pure frozen flow, ``alpha == 1``).
        step0: absolute step of the block's first step.

    Returns:
        ``(a_final, A)`` with ``A`` (nsteps, N, N) the layer-summed
        coefficients after each step.
    """
    A = torch.empty((nsteps,) + tuple(a.shape[1:]), dtype=a.dtype,
                    device=a.device)
    for t in range(nsteps):
        a = step_phasor * a
        if boiling:
            z = _ar_noise(noise, step0 + t, a)
            a = alpha * a + sqrt1ma * (z * sqrt_psd_df)
        A[t] = a.sum(0)
    return a, A


def ar_flow_couplings(a, noise, step_phasor, sqrt_psd_df, alpha, sqrt1ma,
                      chi, W, pm, dx, norm, boiling, step0=0):
    """The AR(1) step, the pruned DFT and the detector, step by step: the
    process of :func:`ar_flow_series` followed by the centred ``ift2``,
    the pupil crop and :func:`detector_coupling`, with each step's screen
    made by the pruned inverse-DFT products ``Re(W A W^T)`` and reduced at
    once. ``chi`` (nsteps,) is the block's log-amplitude series. Returns
    ``(a_final, out)`` with ``out`` (nsteps,) complex couplings scaled by
    ``exp(chi) dx^2 / norm``."""
    out = []
    for t in range(chi.shape[0]):
        a = step_phasor * a
        if boiling:
            z = _ar_noise(noise, step0 + t, a)
            a = alpha * a + sqrt1ma * (z * sqrt_psd_df)
        phs = (W @ a.sum(0) @ W.T).real
        pc = detector_coupling(phs, pm, dx, norm)
        out.append(torch.exp(chi[t]).to(pc.real.dtype) * pc)
    return a, torch.stack(out)


def draw_logamp(generator, niter, logamp_var, temporal_powerspec=None,
                dtype=torch.float32, r_fourier=None):
    """Log-amplitude draws for all iterations: iid ``N(0, logamp_var)``,
    or, in temporal mode, a series coloured by the 1-D temporal
    log-amplitude PSD ``temporal_powerspec`` (niter,) through a centred FT
    and scaled to the same total variance (``fast/funcs.py:358-375``).
    ``r_fourier`` (niter,) complex replaces the coloured branch's own
    complex normal draw."""
    if temporal_powerspec is None:
        r = torch.randn((niter,), generator=generator, dtype=dtype,
                        device=generator.device)
        return r * float(np.sqrt(logamp_var))
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    ps = torch.as_tensor(temporal_powerspec)
    if r_fourier is None:
        r_fourier = complex_normal((niter,), generator, dtype=cdtype)
    r_fourier = r_fourier.to(cdtype) * torch.sqrt(ps / ps.sum()).to(cdtype)
    r = ft(r_fourier, 1.0)
    return (r.real * float(np.sqrt(logamp_var))).to(dtype)
