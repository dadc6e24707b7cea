"""Monte Carlo synthesis in stock torch ops: phase screens and detector.

The plain paths of the iid run (``SYNTH='matmul'`` and ``'fft'``), the
pruned inverse-DFT matrix that every path shares, and the log-amplitude
draws:

    complex normals -> colour by sqrt(PSD) df -> pruned (or full) centred
    inverse DFT -> real and imaginary parts as two screens -> pupil-overlap
    coupling

The Hermitian doubling trick of the reference (``fast/funcs.py:220-222``)
is kept: one complex draw gives two independent screens.
"""

import numpy as np
import torch

from .ops.fourier import ift2
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


def draw_logamp(generator, niter, logamp_var, dtype=torch.float32):
    """iid ``N(0, logamp_var)`` log-amplitude draws for all iterations."""
    r = torch.randn((niter,), generator=generator, dtype=dtype,
                    device=generator.device)
    return r * float(np.sqrt(logamp_var))
