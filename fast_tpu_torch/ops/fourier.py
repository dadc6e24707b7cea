"""Centered FFT conventions over ``torch.fft``.

* ``ft2(g, dx)  = fftshift(fft2(fftshift(g))) * dx**2``
* ``ift2(G, df) = ifftshift(ifft2(ifftshift(G))) * (N * df)**2``

With angular spatial frequencies and ``dx * df = 2*pi / N``, a PSD
normalised so that ``var = integral Phi d^2kappa`` transforms directly
into its autocovariance (the same convention as ``fast_tpu.ops.fourier``).
"""

import torch

_AX = (-2, -1)


def ft2(g, delta):
    """2-D centered forward DFT over the last two axes."""
    return torch.fft.fftshift(
        torch.fft.fft2(torch.fft.fftshift(g, dim=_AX), dim=_AX),
        dim=_AX) * delta ** 2


def ift2(G, delta_f):
    """2-D centered inverse DFT over the last two (square) axes."""
    n = G.shape[-1]
    return torch.fft.ifftshift(
        torch.fft.ifft2(torch.fft.ifftshift(G, dim=_AX), dim=_AX),
        dim=_AX) * (n * delta_f) ** 2
