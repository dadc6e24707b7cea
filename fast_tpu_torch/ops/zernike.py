"""Zernike mode indexing (Noll convention).

Replaces the ``aotools.functions.zernike.zernIndex`` dependency of the
reference (used at ``fast/ao_power_spectra.py:11``).
"""

import numpy as np


def noll_to_nm(j):
    """Noll index ``j`` (1-based) -> radial degree ``n``, signed azimuthal ``m``.

    Follows Noll (1976): even ``j`` carries the cosine (positive ``m``)
    term, odd ``j`` the sine (negative ``m``) term.
    """
    if j < 1:
        raise ValueError("Noll index starts at 1")
    n = int((-1.0 + np.sqrt(8 * (j - 1) + 1)) / 2.0)
    p = j - (n * (n + 1)) / 2.0
    k = n % 2
    m = int((p + k) / 2.0) * 2 - k
    if m != 0:
        m *= 1 if j % 2 == 0 else -1
    return n, m
