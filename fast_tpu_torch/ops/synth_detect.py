"""K2: fused synthesis and pupil-overlap detection (the iid hot loop).

The port of ``fast_tpu.ops.pallas_synth.fused_synthesis_detect``. For
``nbatch`` complex draws it makes the full-grid noise, colours it by the
transposed ``sqrt(PSD) * df``, applies the pruned inverse DFT from both
sides and returns the pupil-overlap sums of both screens of each draw.

* :func:`synth_detect` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/synth_detect.cu`` (built at first use) or
  raises; on a CPU tensor it runs :func:`synth_detect_reference`.
* :func:`synth_detect_reference` is the same function in stock torch ops,
  with a Philox4x32-10 written in torch integer ops that yields the
  kernel's bits from the same seed and counter layout, so the two agree
  numerically on the card and not only in distribution.

Output layout, as the TPU kernel's: ``(2 * nbatch, 2)`` float32, rows
``0..nbatch-1`` the screens from the real parts and rows
``nbatch..2*nbatch-1`` those from the imaginary parts; columns
``(sum pm cos phi, sum pm sin phi)``, not yet scaled by ``dx^2 / norm``.
"""

import ctypes
import functools

import numpy as np
import torch

from . import _build

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# most draws per launch: bounds the G' scratch (2 x draws x N x P floats,
# 0.8 GB at N=256, P=96)
_MAX_DRAWS = 4096
# most grid points the plain version draws at once: bounds its int64
# Philox temporaries to about 3 GB (512 draws at N=256)
_REF_POINTS = 1 << 25
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block can use
_P_ALIGN = 16         # the kernel pads the pupil axis to this multiple
_P_MAX = 128          # widest padded pupil the kernel takes


# ---------------------------------------------------------------------------
# shared pieces: mixing matrix, sincos, Philox
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def mixing_matrix(n):
    """The fixed orthogonal mixing matrix of ``MC_NOISE='mixed'``.

    Host float64 QR of ``default_rng(0x5EED)`` normals, cast to float32:
    the same matrix as ``fast_tpu.ops.pallas_synth._mixing_matrix``.
    Returned read-only, since every caller shares it.
    """
    rng = np.random.default_rng(0x5EED)
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    m = (q * np.sign(np.diag(r))).astype(np.float32)
    m.setflags(write=False)
    return m


# pi/2 in three float32 pieces (Cody-Waite) and the cephes sinf/cosf
# coefficients, as the TPU kernel's _sincos; all exact float32 values
_F32 = [float(np.float32(v)) for v in (
    0.6366197723675814, 1.5703125, 4.837512969970703e-4, 7.549789948768648e-8,
    -1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4,
    4.166664568298827e-2, -1.388731625493765e-3, 2.443315711809948e-5)]
(_TWO_OVER_PI, _PIO2_HI, _PIO2_MID, _PIO2_LO,
 _S1, _S2, _S3, _C2, _C3, _C4) = _F32


def sincos(phi):
    """``(sin(phi), cos(phi))`` of a float32 tensor with one shared
    Cody-Waite reduction; max error 2e-7 against float64 for
    ``|phi| <= 4096``."""
    q = torch.round(phi * _TWO_OVER_PI)
    r = phi - q * _PIO2_HI
    r = r - q * _PIO2_MID
    r = r - q * _PIO2_LO
    r2 = r * r
    s = r + r * r2 * (_S1 + r2 * (_S2 + r2 * _S3))
    c = 1.0 + r2 * (-0.5 + r2 * (_C2 + r2 * (_C3 + r2 * _C4)))
    qi = q.to(torch.int32)
    swap = (qi & 1) == 1
    sin_v = torch.where(swap, c, s)
    cos_v = torch.where(swap, s, c)
    return (torch.where((qi & 2) == 2, -sin_v, sin_v),
            torch.where(((qi + 1) & 2) == 2, -cos_v, cos_v))


def _mulhilo(m, x):
    """High and low 32-bit words of ``m * x`` for a 32-bit constant ``m``
    and an int64 tensor ``x`` of 32-bit values, without int64 overflow."""
    # in-place on fresh temporaries: this is the plain version's hot loop
    p_lo = (x & 0xFFFF).mul_(m)
    p_hi = (x >> 16).mul_(m)
    s = (p_hi & 0xFFFF).bitwise_left_shift_(16).add_(p_lo)
    hi = p_hi.bitwise_right_shift_(16).add_(s >> 32)
    return hi, s.bitwise_and_(_MASK32)


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words
    (broadcast together) and a 64-bit key ``(k0, k1)``; returns the four
    output words as int64 tensors."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0 = hi1.bitwise_xor_(c1).bitwise_xor_(k0)
        c2 = hi0.bitwise_xor_(c3).bitwise_xor_(k1)
        c1, c3 = lo1, lo0
    return c0, c1, c2, c3


def _key(seed):
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError("seed must be an integer in [0, 2^64)")
    return seed & _MASK32, (seed >> 32) & _MASK32


def philox_bits(seed, nbatch, N, stream=0, device="cpu", draw0=0):
    """The kernel's two random words per grid point: ``(b1, b2)``, each an
    int64 tensor of 32-bit values, shape (nbatch, N, N), for draws
    ``draw0 .. draw0 + nbatch - 1``.

    Counter of element ``e = row * N + col`` of draw ``d``:
    ``(e, d, stream, 0)``; key: the 64-bit ``seed``.
    """
    k0, k1 = _key(seed)
    e = torch.arange(N * N, dtype=torch.int64, device=device)[None, :]
    d = torch.arange(draw0, draw0 + nbatch, dtype=torch.int64,
                     device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    x0, x1, _, _ = philox4x32_10(e, d, zero + int(stream), zero, k0, k1)
    return x0.reshape(nbatch, N, N), x1.reshape(nbatch, N, N)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _pack(out):
    """(nbatch, 4) per-draw sums -> (2 * nbatch, 2), real-part screens
    first."""
    return torch.stack([torch.cat([out[:, 0], out[:, 2]]),
                        torch.cat([out[:, 1], out[:, 3]])], dim=-1)


def synth_detect_reference(seed, s_t, wr, wi, pm_t, nbatch, mix=None,
                           stream=0, draw0=0, bits=None):
    """K2 in stock torch ops (see the module docstring).

    Args:
        seed: 64-bit integer key of the Philox generator.
        s_t: (N, N) float32 transposed ``sqrt(PSD) * df``.
        wr, wi: (P, N) float32 real and imaginary parts of the pruned
            inverse-DFT matrix (rows past the pupil may be zero padding).
        pm_t: (P, P) float32 transposed pupil * mode (zero padded alike).
        nbatch: number of complex draws (2 * nbatch screens).
        mix: (N, N) float32 mixing matrix for 'mixed' noise; None selects
            Box-Muller ('gauss').
        stream: counter word that separates the streams of one seed.
        draw0: counter index of the first draw.
        bits: optional ``(b1, b2)`` integer tensors (nbatch, N, N) of
            32-bit values in place of the Philox bits.

    Returns:
        (2 * nbatch, 2) float32 tensor.
    """
    N = s_t.shape[-1]
    per = max(1, _REF_POINTS // (N * N))
    parts = []
    for d0 in range(0, int(nbatch), per):
        nb = min(per, int(nbatch) - d0)
        if bits is None:
            b = philox_bits(seed, nb, N, stream, device=s_t.device,
                            draw0=draw0 + d0)
        else:
            b = (bits[0][d0:d0 + nb], bits[1][d0:d0 + nb])
        parts.append(_reference_sums(b, s_t, wr, wi, pm_t, mix))
    return _pack(torch.cat(parts))


def _reference_sums(bits, s_t, wr, wi, pm_t, mix):
    """(nb, 4) per-draw sums of the plain version from the draws' bits."""
    i1 = (bits[0].to(torch.int64) >> 8).to(torch.float32)
    i2 = (bits[1].to(torch.int64) >> 8).to(torch.float32)
    if mix is not None:
        s3 = float(np.float32(np.sqrt(3.0)))
        scale = float(np.float32(s3) * np.float32(2.0 ** -23))
        z1 = (i1 * scale - s3) @ mix
        z2 = (i2 * scale - s3) @ mix
    else:
        u1 = i1 * 2.0 ** -24 + 2.0 ** -25
        u2 = i2 * 2.0 ** -24
        r = torch.sqrt(-2.0 * torch.log(u1))
        st, ct = sincos(float(np.float32(2 * np.pi)) * u2)
        z1 = r * ct
        z2 = r * st
    xr = z1 * s_t
    xi = z2 * s_t
    gr = xr @ wr.T - xi @ wi.T
    gi = xr @ wi.T + xi @ wr.T
    h1 = wr @ gr - wi @ gi
    h2 = wr @ gi + wi @ gr
    s1, c1 = sincos(h1)
    s2, c2 = sincos(h2)
    return torch.stack([(pm_t * c1).sum((-2, -1)), (pm_t * s1).sum((-2, -1)),
                        (pm_t * c2).sum((-2, -1)), (pm_t * s2).sum((-2, -1))],
                       dim=-1)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def padded_pupil(P):
    """Width of the pupil axis as the kernel takes it: ``P`` rounded up
    to a multiple of 16."""
    return -(-int(P) // _P_ALIGN) * _P_ALIGN


def pad_pupil(wr, wi, pm_t):
    """Zero-pad the pupil axis of the kernel's W and pupil-mode tables to
    :func:`padded_pupil`; padded pixels add nothing to the sums."""
    pad = padded_pupil(wr.shape[0]) - wr.shape[0]
    if pad:
        wr = torch.nn.functional.pad(wr, (0, 0, 0, pad))
        wi = torch.nn.functional.pad(wi, (0, 0, 0, pad))
        pm_t = torch.nn.functional.pad(pm_t, (0, pad, 0, pad))
    return wr, wi, pm_t


def _smem_bytes(N, P, mixed, rows):
    """Dynamic shared memory of pass 1 (``pass1_smem`` of the CUDA source):
    x tile, two W tiles and, with 'mixed' noise, a mixing-matrix tile and
    one component's uniforms of ``16 * rows`` grid rows; the grid side is
    padded to a multiple of 64 and strides by one word against bank
    conflicts."""
    NC = -(-N // 64) * 64
    R = 16 * rows
    mixed_part = 32 * 64 + R * (NC + 1) if mixed else 0
    return 4 * (R * 65 + 2 * 64 * (padded_pupil(P) + 1) + mixed_part)


def _rows_per_thread(N, P, mixed):
    """Pass 1's rows per thread (2, or 1 for grids too wide for 32 rows of
    uniforms in shared memory); 0 where the kernel does not take the
    shape. 'gauss' noise always takes 2."""
    if N <= 0 or not 0 < P <= _P_MAX:
        return 0
    for rows in ((2, 1) if mixed else (2,)):
        if _smem_bytes(N, P, mixed, rows) <= _SMEM_LIMIT:
            return rows
    return 0


def supports(N, P, mixed=True):
    """Whether the kernel takes an (N, N) grid with a P-pixel pupil: any
    N, a pupil of at most 128 px, and with 'mixed' noise 16 grid rows of
    uniforms within shared memory (N up to 2368 at P <= 128)."""
    return _rows_per_thread(N, P, mixed) > 0


def _library():
    lib, info = _build.load_library("synth_detect")
    if not getattr(lib, "_fast_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fast_synth_detect.argtypes = [u, u, u, i, i, p, p, p, p, p, p, p,
                                          p, i, i, i, p]
        lib.fast_synth_detect.restype = i
        lib.fast_sincos.argtypes = [p, p, p, i, p]
        lib.fast_sincos.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def build():
    """Build (or find) the kernel's library; returns its build info."""
    return _library()[1]


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.fast_error_string(err).decode()})")


def _check(s_t, wr, wi, pm_t, nbatch, mix):
    if s_t.ndim != 2 or s_t.shape[0] != s_t.shape[1]:
        raise ValueError(f"s_t must be (N, N), got {tuple(s_t.shape)}")
    N = s_t.shape[0]
    P = wr.shape[0]
    shapes = {"wr": (wr, (P, N)), "wi": (wi, (P, N)), "pm_t": (pm_t, (P, P))}
    if mix is not None:
        shapes["mix"] = (mix, (N, N))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in [("s_t", s_t)] + [(k, v[0]) for k, v in shapes.items()]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != s_t.device:
            raise ValueError(f"{name} is on {t.device}, s_t on {s_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if int(nbatch) <= 0:
        raise ValueError("nbatch must be positive")
    return N, P


def synth_detect(seed, s_t, wr, wi, pm_t, nbatch, mix=None, stream=0):
    """K2 on ``nbatch`` complex draws; arguments as
    :func:`synth_detect_reference`.

    On CUDA tensors this launches the kernel (two passes per launch of at
    most 4096 draws, the n-th launch from draw ``4096 * n``) on the
    current stream and counts each launch in ``synth_detect.LAUNCHES``, or
    raises for a shape it does not take (:func:`supports`); on CPU tensors
    it runs the plain version.
    """
    N, P = _check(s_t, wr, wi, pm_t, nbatch, mix)
    dev = s_t.device
    if dev.type == "cpu":
        return synth_detect_reference(seed, s_t, wr, wi, pm_t, nbatch,
                                      mix=mix, stream=stream)
    if dev.type != "cuda":
        raise ValueError(f"synth_detect runs on CPU or CUDA, not {dev}")
    rows = _rows_per_thread(N, P, mix is not None)
    if not rows:
        raise ValueError(
            f"the synth-detect kernel takes a pupil of at most {_P_MAX} px "
            f"and, with 'mixed' noise, 16 grid rows of uniforms within "
            f"{_SMEM_LIMIT} B of shared memory; got N={N}, P={P}")
    if not 0 <= int(stream) < 2 ** 32:
        raise ValueError("stream must fit in 32 bits")
    k0, k1 = _key(seed)
    wr, wi, pm_t = pad_pupil(wr, wi, pm_t)
    Pp = wr.shape[0]
    lib, _ = _library()
    nbatch = int(nbatch)
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    per = min(nbatch, _MAX_DRAWS)
    g = torch.empty((2, per, N, Pp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_synth_detect(
                k0, k1, int(stream), d0, nb, s_t.data_ptr(), wr.data_ptr(),
                wi.data_ptr(), pm_t.data_ptr(),
                None if mix is None else mix.data_ptr(), g[0].data_ptr(),
                g[1].data_ptr(), out[d0:d0 + nb].data_ptr(), N, Pp, rows,
                cs)
            _raise_on(lib, err, "synth_detect launch")
            synth_detect.LAUNCHES += 1
    return _pack(out)


synth_detect.LAUNCHES = 0


def device_sincos(phi):
    """The kernel's sincos on a CUDA float32 tensor: ``(sin, cos)``.
    For accuracy checks of the device code against float64."""
    if phi.device.type != "cuda" or phi.dtype != torch.float32:
        raise ValueError("device_sincos takes a CUDA float32 tensor")
    phi = phi.contiguous()
    s = torch.empty_like(phi)
    c = torch.empty_like(phi)
    lib, _ = _library()
    with torch.cuda.device(phi.device):
        err = lib.fast_sincos(phi.data_ptr(), s.data_ptr(), c.data_ptr(),
                              phi.numel(),
                              torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "sincos launch")
    return s, c
