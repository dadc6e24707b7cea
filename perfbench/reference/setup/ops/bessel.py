"""Integer-order Bessel functions of the first kind, in torch float64.

The same method as ``fast_tpu.ops.bessel``: the integral representation

    J_n(x) = (1/pi) * integral_0^pi cos(n*theta - x*sin(theta)) d(theta)

by the composite trapezoid rule, which converges geometrically for this
integrand. Expanding the cosine makes the quadrature two matrix products
shared by all requested orders:

    J_n(x) = (1/M) * sum_k w_k [cos(n theta_k) cos(x sin theta_k)
                                + sin(n theta_k) sin(x sin theta_k)]
"""

import math

import numpy as np
import torch

_BLOCK = 4096  # points per quadrature block; bounds peak memory


def quadrature_order(x_max, n_max):
    """Trapezoid intervals for machine-precision J_n up to order n_max.

    Error terms are ``J_{2M-n}(x)``; require ``2M - n_max >= x_max + 60``,
    rounded up to a multiple of 8 (the JAX package's rule, kept so that
    both evaluate the same sum).
    """
    m = int(np.ceil((float(x_max) + float(n_max) + 60.0) / 2.0))
    return max(64, -(-m // 8) * 8)


def besselj(orders, x, x_max=None, M=None):
    """``J_n(x)`` for one or more integer orders.

    Args:
        orders: int or 1-D sequence of non-negative integer orders.
        x: float64 tensor of evaluation points (any shape).
        x_max: bound on ``max |x|`` that sets the quadrature order if
            ``M`` is omitted; read from ``x`` if both are omitted.
        M: number of trapezoid intervals (overrides ``x_max``).

    Returns:
        Tensor of shape ``x.shape + (len(orders),)``, or ``x.shape`` if
        ``orders`` was a scalar.
    """
    scalar = np.ndim(orders) == 0
    orders_l = [int(o) for o in np.atleast_1d(orders)]
    x = torch.as_tensor(x, dtype=torch.float64)
    if M is None:
        if x_max is None:
            x_max = float(x.abs().max())
        M = quadrature_order(x_max, max(orders_l))
    dev = x.device
    theta = (math.pi / M) * torch.arange(M + 1, dtype=torch.float64,
                                         device=dev)
    w = torch.ones(M + 1, dtype=torch.float64, device=dev)
    w[0] = w[-1] = 0.5
    ords = torch.tensor(orders_l, dtype=torch.float64, device=dev)
    ntheta = ords[:, None] * theta
    cos_n = (torch.cos(ntheta) * w).T  # (M+1, P)
    sin_n = (torch.sin(ntheta) * w).T
    sin_t = torch.sin(theta)

    x_flat = x.abs().reshape(-1)
    out = torch.empty((x_flat.shape[0], len(orders_l)), dtype=torch.float64,
                      device=dev)
    for lo in range(0, x_flat.shape[0], _BLOCK):
        xs = x_flat[lo:lo + _BLOCK, None] * sin_t
        out[lo:lo + _BLOCK] = (torch.cos(xs) @ cos_n
                               + torch.sin(xs) @ sin_n) / M
    out = out.reshape(x.shape + (len(orders_l),))
    # J_n(-x) = (-1)^n J_n(x); sign(0) = 0 is harmless since J_odd(0) = 0
    odd = torch.tensor([o % 2 == 1 for o in orders_l], device=dev)
    sign = torch.where(odd, torch.sign(x)[..., None],
                       torch.ones((), dtype=torch.float64, device=dev))
    out = out * sign
    return out[..., 0] if scalar else out
