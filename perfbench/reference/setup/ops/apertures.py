"""Apertures, launch modes and the pupil spatial filter.

Host-side (numpy, float64) construction of the static pupil/mode fields the
engine precomputes once per configuration (reference ``fast/funcs.py:261-350``
plus the ``aotools`` ``circle``/``gaussian2d`` surface it imports, SURVEY.md
§2.8). These feed the device-side Monte Carlo path as constants.

Grid conventions match the reference's aotools dependency, including its
known half-pixel quirk: ``circle`` samples pixel centres at ``i + 0.5 - N/2``
while ``gaussian2d`` centres the peak at index ``N/2`` — the two are offset
by half a pixel. We reproduce this deliberately so pupil-overlap integrals,
fibre-coupling optima and the link budget cross-validate against the
reference bit-for-bit (given identical inputs).
"""

import logging

import numpy as np
from scipy.optimize import minimize_scalar

logger = logging.getLogger(__name__)


def circle(radius, size, circle_centre=(0, 0)):
    """Binary circular aperture of ``radius`` pixels on a ``size``^2 grid.

    Pixel-centre coordinates are ``arange(0.5, size) - size/2`` (aotools
    convention; reference call sites ``fast/funcs.py:263``).
    """
    coords = np.arange(0.5, size, 1.0)
    x, y = np.meshgrid(coords, coords)
    x = x - size / 2.0 - circle_centre[0]
    y = y - size / 2.0 - circle_centre[1]
    mask = x * x + y * y <= radius * radius
    out = np.zeros((size, size))
    out[mask] = 1
    return out


def gaussian2d(size, width, amplitude=1.0, cent=None):
    """2-D Gaussian, ``width`` = standard deviation in pixels.

    Peak at index ``size/2`` unless ``cent`` given (aotools convention;
    reference call sites ``fast/funcs.py:290,340,348``, ``fast/comms.py:411``).
    """
    if not np.isscalar(size):
        xsize, ysize = size
    else:
        xsize = ysize = size
    if not np.isscalar(width):
        xwidth, ywidth = width
    else:
        xwidth = ywidth = width
    if cent is None:
        xcent = xsize / 2.0
        ycent = ysize / 2.0
    else:
        xcent, ycent = cent
    i = np.arange(xsize)[:, None]
    j = np.arange(ysize)[None, :]
    return amplitude * np.exp(
        -(((xcent - i) / xwidth) ** 2 + ((ycent - j) / ywidth) ** 2) / 2
    )


def _fit_columns(arr, Ny):
    """Symmetrically pad or crop the column axis of ``arr`` to ``Ny``."""
    Nx = arr.shape[1]
    if (Ny - Nx) % 2:
        raise ValueError("(Ny - Nx) must be even for a symmetric refit")
    half = abs(Ny - Nx) // 2
    if Ny > Nx:
        return np.pad(arr, [(0, 0), (half, half)])
    if Ny < Nx:
        return arr[:, half:Nx - half]
    return arr


def compute_pupil(N, dx, D, obsc=0, Ny=None):
    """Annular aperture normalised to unit energy (``sum * dx^2 == 1``).

    Optional symmetric padding/cropping of the second axis to ``Ny``
    columns (used by the temporal-mode pupil filter). Reference semantics:
    ``fast/funcs.py:261-277``.
    """
    annulus = circle(D / dx / 2, N) - circle(obsc / dx / 2, N)
    if Ny is not None:
        annulus = _fit_columns(annulus, Ny)
    return annulus / np.sqrt(annulus.sum() * dx ** 2)


def gaussian_mode_field(shape, W0, dx):
    """Unit-power Gaussian amplitude field: peak intensity ``2/(pi W0^2)``.

    The one normalisation used everywhere a Gaussian fibre/launch mode
    appears (mode construction, coupling loss, waist optimisation).
    """
    return gaussian2d(shape, W0 / dx / np.sqrt(2)) * np.sqrt(
        2.0 / (np.pi * W0 ** 2))


def _axicon_ring_field(shape, W0, dx, D, obsc):
    """Unit-power annular ('axicon') ring mode centred between the radii."""
    Nx, Ny = shape
    x = np.arange(-Nx / 2, Nx / 2) * dx
    y = np.arange(-Ny / 2, Ny / 2) * dx
    r = np.hypot(x[:, None], y[None, :])
    midpt = (obsc / 2 + D / 2) / 2
    ring = np.exp(-((r - midpt) ** 2) / W0 ** 2)
    return ring / np.sqrt((ring ** 2).sum() * dx ** 2)


def compute_gaussian_mode(pupil, dx, W0=None, D=None, obsc=None, ptype="gauss"):
    """Gaussian (or axicon ring) launch/receive mode.

    ``W0 == 'opt'`` optimises the waist for maximum fibre coupling against
    ``pupil``. Returns ``(mode, W0)``. Amplitude semantics as the reference
    (``fast/funcs.py:280-305``): unit-power field divided by
    ``pupil.max()`` so that ``pupil * mode`` carries the mode amplitude
    unweighted by the pupil's own energy normalisation.
    """
    want_opt = isinstance(W0, str) and W0 == "opt"
    if ptype == "gauss":
        if want_opt:
            field, W0 = optimize_fibre(pupil, dx, return_size=True)
            logger.debug("Optimised gaussian size: %s", W0)
        else:
            field = gaussian_mode_field(pupil.shape, W0, dx)
    elif ptype == "axicon":
        if want_opt:
            raise TypeError(
                "Using 'axicon' and W0='opt' not supported, please set W0")
        field = _axicon_ring_field(pupil.shape, W0, dx, D, obsc)
    else:
        raise Exception('ptype must be one of "gauss" or "axicon"')
    return field / pupil.max(), W0


def _np_ft2(g, delta):
    """Centered 2-D DFT (numpy, host side) — same convention as ops.fourier."""
    return np.fft.fftshift(np.fft.fft2(np.fft.fftshift(g))) * delta ** 2


def pupil_filter(pupil):
    """Pupil spatial filter ``|FT(pupil)|^2 / pupil.sum()^2``.

    Reference ``fast/funcs.py:308-315`` (ndarray branch; the temporal mode
    resamples its table with ``models.scintillation.PupilFilterSampler``).
    """
    P = np.abs(_np_ft2(pupil, 1)) ** 2
    return P / pupil.sum() ** 2


def coupling_loss(W, N, pupil, dx):
    """1 - coupling efficiency of a Gaussian mode of waist ``W`` into ``pupil``."""
    overlap = (gaussian_mode_field(N, W, dx) * pupil).sum() * dx ** 2
    return 1 - np.abs(overlap) ** 2


def optimize_fibre(pupil, dx, size_min=None, size_max=None, return_size=False):
    """Optimal Gaussian mode waist for coupling into ``pupil``.

    Host-side bracketed scalar minimisation over progressively wider
    brackets (the narrow bracket occasionally collapses to ~0 for some
    parameter combinations — reference semantics ``fast/funcs.py:317-345``).
    Runs once per configuration, so it stays off-device.
    """
    shape = pupil.shape
    if size_max is None:
        size_max = max(shape) * dx
    if size_min is None:
        size_min = dx

    opt = None
    for hi, last in ((size_max, False), (2 * size_max, True)):
        opt = minimize_scalar(
            lambda W: coupling_loss(W, shape, pupil, dx),
            bracket=[size_min, hi]).x
        if abs(opt) >= dx:
            break
        if last:
            raise Exception("Cannot optimise gaussian mode, try changing DX?")
        logger.info(
            "Gaussian mode optimisation failed, trying different parameters")

    g = gaussian_mode_field(shape, opt, dx)
    return (g, np.abs(opt)) if return_size else g
