"""Periodic bilinear interpolation by gathers.

FFT-synthesised screens are exactly periodic, so the frozen-flow mode
samples them with periodic (mod N) bilinear interpolation: no seam
handling, one vectorised gather (``fast_tpu.ops.interp``; the reference
walked a ``RectBivariateSpline`` per layer and step,
``fast/fast.py:607-637``).
"""

import torch


def _split(coords, n, dtype):
    """Integer cell (mod n), its neighbour and the fraction of fractional
    indices ``coords``."""
    c0f = torch.floor(coords)
    frac = (coords - c0f).to(dtype)
    c0 = torch.remainder(c0f, n).to(torch.int64)
    return c0, torch.remainder(c0 + 1, n), frac


def bilinear_periodic(img, rows, cols):
    """Sample the periodic ``img`` (..., N, N) at fractional ``(rows,
    cols)``, float tensors of one shape holding any real index (wrapped
    mod N). Leading axes of ``img`` broadcast against the coordinates."""
    n = img.shape[-1]
    r0, r1, fr = _split(rows, n, img.dtype)
    c0, c1, fc = _split(cols, n, img.dtype)
    return (img[..., r0, c0] * (1 - fr) * (1 - fc)
            + img[..., r0, c1] * (1 - fr) * fc
            + img[..., r1, c0] * fr * (1 - fc)
            + img[..., r1, c1] * fr * fc)


def sample_grid_periodic(img, row_coords, col_coords):
    """Sample ``img`` (N, N) on the outer product of 1-D fractional
    coordinates: ``row_coords`` (R,) x ``col_coords`` (C,) -> (R, C).

    The reference's ``RectBivariateSpline(kx=1, ky=1)`` on a coordinate
    grid (``fast/fast.py:631``), periodic at the seam. Bilinear
    interpolation on an outer-product grid is separable: whole rows are
    gathered and blended, then columns.
    """
    n = img.shape[-1]
    r0, r1, fr = _split(row_coords, n, img.dtype)
    tmp = img[r0] * (1 - fr[:, None]) + img[r1] * fr[:, None]
    c0, c1, fc = _split(col_coords, n, img.dtype)
    return tmp[:, c0] * (1 - fc[None, :]) + tmp[:, c1] * fc[None, :]
