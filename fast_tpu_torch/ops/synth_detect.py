"""K2: fused synthesis and pupil-overlap detection (the iid hot loop), and
K7: the same synthesis with the screens as its output.

The port of ``fast_tpu.ops.pallas_synth.fused_synthesis_detect``. For
``nbatch`` complex draws it makes the full-grid noise, colours it by the
transposed ``sqrt(PSD) * df``, applies the pruned inverse DFT from both
sides and returns the pupil-overlap sums of both screens of each draw.
:func:`synth_screens` (K7, the port of ``fused_synthesis``) returns the
screens themselves, from Box-Muller noise: with ``mix=None`` K2 detects
exactly K7's screens of the same seed.

* :func:`synth_detect` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel of ``csrc/synth_detect.cu`` (built at first use) or
  raises; on a CPU tensor it runs :func:`synth_detect_reference`.
* :func:`synth_detect_reference` is the same function in stock torch ops,
  with a Philox4x32-10 written in torch integer ops that yields the
  kernel's bits from the same seed and counter layout, so the two agree
  numerically on the card and not only in distribution.
* :func:`synth_screens` and :func:`synth_screens_reference` are that pair
  for K7.
* :func:`screens_pass` and :func:`screens_pass_reference` are K7's second
  pass alone (``W G'`` written out as screens), the twin of
  :func:`~fast_tpu_torch.ops.colfac_detect.detect_pass`.

Any grid side and any pupil width: the kernels tile the pupil axis
(``csrc/detect.cuh``). The Philox counter's last word keeps the kernels'
streams of one seed apart: 0 for K2 and K7, 1 for K1
(:mod:`~fast_tpu_torch.ops.colfac_detect`), 2 for the AR kernels
(:mod:`~fast_tpu_torch.ops.ar_flow`), 3 for K3. Both passes of K2 and K7
run their products on the tensor cores (Hopper's ``wgmma``) against the
laid W table (:class:`LaidW`, :func:`laid_w`: split and laid out once per
configuration and pass count, the engine's; a wrapper given plain ``wr``,
``wi`` lays them out for the call), which the detect pass of K1 and K3
reads too; :func:`synth_pass1` runs pass 1 alone.

Precision: every wrapper and plain version takes ``precision``, the
``PRECISION`` config value (:data:`PASSES`). 'high' and 'highest' (the
wrappers' default) run every product as three TF32 products (3xTF32,
fp32-accurate); 'default' runs each as one TF32 product, its operands
rounded to TF32 once, as the JAX package's 'default' is one bf16 pass.
The plain versions round their products' operands the same way
(:func:`mm`), so that a kernel and its plain version agree at either
precision.

Output layout, as the TPU kernel's: ``(2 * nbatch, 2)`` float32, rows
``0..nbatch-1`` the screens from the real parts and rows
``nbatch..2*nbatch-1`` those from the imaginary parts; columns
``(sum pm cos phi, sum pm sin phi)``, not yet scaled by ``dx^2 / norm``.

The pieces both detect kernels share live here too: Philox, sincos, the
noise transforms, the pupil padding and :func:`detect_reference`, the
plain version of the detect pass (``csrc/detect.cuh``) that ends K2 and
the colfac-detect kernel K1 (:mod:`fast_tpu_torch.ops.colfac_detect`).
Optional subharmonic screens (:func:`pack_subharm`) are added to the
phase before the detector, as the TPU kernels do.
"""

import ctypes
import functools

import numpy as np
import torch

from ..conf import PASSES
from . import _build

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# most draws per launch, and most bytes of the G' scratch (2 x draws x N x P
# floats: 0.8 GB for 4096 draws at N=256, P=96; 3.4 MB a draw at N=1024,
# P=416, so 630 draws a launch there)
_MAX_DRAWS = 4096
_G_BYTES = 2 << 30
# most grid points the plain version draws at once: bounds its int64
# Philox temporaries to about 3 GB (512 draws at N=256)
_REF_POINTS = 1 << 25
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block can use
# pass 1 (csrc/synth_detect.cu): the widest pupil slice of a block; the
# depth of a chunk of uniforms and of a staged slice of the mixing matrix;
# the words of a TF32 plane of such a slice (4 steps x 64 columns x 8), of
# a chunk of both components' uniforms (64 rows x 32) and of an x tile (Re
# and Im, 64 x 64)
_PB_MAX = 208
_KU = 32
_M_PLANE = 4 * 64 * 8
_U_CHUNK = 2 * 64 * _KU
_X_TILE = 2 * 64 * 64
_P_ALIGN = 16         # the kernel pads the pupil axis to this multiple
_P_MAX = 128          # px of a pupil tile (csrc/detect.cuh); K1 takes no
                      # wider pupil

def passes(precision):
    """The TF32 passes of every kernel product at ``precision``, a
    :data:`PASSES` key; any other value raises."""
    try:
        return PASSES[precision]
    except (KeyError, TypeError):
        raise ValueError(f"precision must be one of {sorted(PASSES)}, got "
                         f"{precision!r}") from None


def mm(a, b, precision):
    """``a @ b`` with both operands as the kernels' products take them at
    ``precision``: rounded to TF32 (as ``cvt.rna.tf32.f32`` rounds) at one
    pass, else as they are; summed in float32. Every product of the plain
    versions."""
    if passes(precision) == 1:
        a, b = _tf32(a), _tf32(b)
    return a @ b


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


def uniforms(bits):
    """'mixed' noise: unit-variance uniforms from the top 24 bits of
    32-bit words, ``(bits >> 8) * sqrt(3) 2^-23 - sqrt(3)`` in float32."""
    s3 = float(np.float32(np.sqrt(3.0)))
    scale = float(np.float32(s3) * np.float32(2.0 ** -23))
    return (bits.to(torch.int64) >> 8).to(torch.float32) * scale - s3


def box_muller(b1, b2):
    """'gauss' noise: ``(r cos, r sin)`` from two 32-bit words' top 24
    bits, ``u1 = i1 2^-24 + 2^-25``, ``u2 = i2 2^-24``."""
    u1 = (b1.to(torch.int64) >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = (b2.to(torch.int64) >> 8).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    st, ct = sincos(float(np.float32(2 * np.pi)) * u2)
    return r * ct, r * st


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


def detect_reference(gr, gi, wr, wi, pm_t, sh_t=None, precision="highest"):
    """The detect pass that ends both kernels, in stock torch ops: the
    transposed screens ``H = W G'`` of each draw from its ``G'`` (``gr``,
    ``gi``: (nb, N, P)), plus the transposed subharmonic screens ``sh_t``
    ((nb, 2, P, P)) if given, then ``(sum pm_t cos, sum pm_t sin)`` of
    ``Re H`` and ``Im H``: (nb, 4) float32; the products at
    ``precision`` (:func:`mm`)."""
    h1 = mm(wr, gr, precision) - mm(wi, gi, precision)
    h2 = mm(wr, gi, precision) + mm(wi, gr, precision)
    if sh_t is not None:
        h1 = h1 + sh_t[:, 0]
        h2 = h2 + sh_t[:, 1]
    s1, c1 = sincos(h1)
    s2, c2 = sincos(h2)
    return torch.stack([(pm_t * c1).sum((-2, -1)), (pm_t * s1).sum((-2, -1)),
                        (pm_t * c2).sum((-2, -1)), (pm_t * s2).sum((-2, -1))],
                       dim=-1)


def _gprime_reference(seed, s_t, wr, wi, nbatch, mix, stream, draw0, bits,
                      precision="highest"):
    """Pass 1 in stock torch ops, in pieces of bounded size: yields
    ``(d0, gr, gi)``, the ``G' = X' W^T`` (nb, N, P) of draws ``d0 ..``,
    both products at ``precision``."""
    N = s_t.shape[-1]
    per = max(1, _REF_POINTS // (N * N))
    for d0 in range(0, int(nbatch), per):
        nb = min(per, int(nbatch) - d0)
        if bits is None:
            b = philox_bits(seed, nb, N, stream, device=s_t.device,
                            draw0=draw0 + d0)
        else:
            b = (bits[0][d0:d0 + nb], bits[1][d0:d0 + nb])
        if mix is not None:
            z1 = mm(uniforms(b[0]), mix, precision)
            z2 = mm(uniforms(b[1]), mix, precision)
        else:
            z1, z2 = box_muller(*b)
        xr = z1 * s_t
        xi = z2 * s_t
        wrt, wit = wr.T, wi.T
        yield (d0, mm(xr, wrt, precision) - mm(xi, wit, precision),
               mm(xr, wit, precision) + mm(xi, wrt, precision))


def synth_detect_reference(seed, s_t, wr, wi, pm_t, nbatch, mix=None,
                           stream=0, draw0=0, bits=None, sh_t=None,
                           precision="highest"):
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
        sh_t: optional (nbatch, 2, P, P) float32 transposed subharmonic
            screens (:func:`pack_subharm`).
        precision: the ``PRECISION`` of every product (:data:`PASSES`):
            'default' rounds their operands to TF32 (:func:`mm`).

    Returns:
        (2 * nbatch, 2) float32 tensor.
    """
    parts = [detect_reference(gr, gi, wr, wi, pm_t,
                              None if sh_t is None
                              else sh_t[d0:d0 + gr.shape[0]], precision)
             for d0, gr, gi in _gprime_reference(seed, s_t, wr, wi, nbatch,
                                                 mix, stream, draw0, bits,
                                                 precision)]
    return _pack(torch.cat(parts))


def synth_screens_reference(seed, s_t, wr, wi, nbatch, npup=None, stream=0,
                            draw0=0, bits=None, precision="highest"):
    """K7 in stock torch ops: the phase screens ``Re, Im (W X W^T)`` of
    ``nbatch`` complex draws of Box-Muller noise, K2's 'gauss' draws of
    the same seed, stream and draw index.

    Args: as :func:`synth_detect_reference`; ``npup`` is the pupil width
    the screens are cropped to (default: the rows of ``wr``).

    Returns:
        (2 * nbatch, npup, npup) float32, the screens from the real parts
        first, un-transposed (``fast_tpu.ops.pallas_synth.fused_synthesis``).
    """
    npup = wr.shape[0] if npup is None else int(npup)
    scr = [screens_pass_reference(gr, gi, wr[:npup], wi[:npup],
                                  precision=precision)
           for _, gr, gi in _gprime_reference(seed, s_t, wr[:npup],
                                              wi[:npup], nbatch, None,
                                              stream, draw0, bits,
                                              precision)]
    n = [x.shape[0] // 2 for x in scr]
    return torch.cat([x[:k] for x, k in zip(scr, n)]
                     + [x[k:] for x, k in zip(scr, n)]).contiguous()


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def padded_pupil(P):
    """Width of the pupil axis as the kernel takes it: ``P`` rounded up
    to a multiple of 16."""
    return -(-int(P) // _P_ALIGN) * _P_ALIGN


def pad_pupil(wr, wi, pm_t):
    """Zero-pad the pupil axis of the kernel's W and pupil-mode tables to
    :func:`padded_pupil`; padded pixels add nothing to the sums. ``pm_t``
    may be None (K7 has no detector)."""
    pad = padded_pupil(wr.shape[0]) - wr.shape[0]
    if pad:
        wr = torch.nn.functional.pad(wr, (0, 0, 0, pad))
        wi = torch.nn.functional.pad(wi, (0, 0, 0, pad))
        if pm_t is not None:
            pm_t = torch.nn.functional.pad(pm_t, (0, pad, 0, pad))
    return wr, wi, pm_t


def pack_subharm(sh, P=None):
    """Subharmonic screens as the detect pass takes them: (nbatch, npup,
    npup) complex -> (nbatch, 2, P, P) float32, the transposed real and
    imaginary parts zero padded to ``P`` (default
    :func:`padded_pupil`); padded pixels fall where ``pm_t`` is zero. The
    port of ``fast_tpu.ops.pallas_synth.pad_subharm_screens`` in the
    transposed layout of K2's ``pm_t``."""
    npup = sh.shape[-1]
    P = padded_pupil(npup) if P is None else int(P)
    out = torch.zeros((sh.shape[0], 2, P, P), dtype=torch.float32,
                      device=sh.device)
    out[:, 0, :npup, :npup] = sh.real.transpose(-2, -1)
    out[:, 1, :npup, :npup] = sh.imag.transpose(-2, -1)
    return out


def check_subharm(sh_t, nbatch, P, device):
    """Raise unless ``sh_t`` is None or a contiguous float32 (nbatch, 2,
    P, P) tensor on ``device``."""
    if sh_t is None:
        return
    if tuple(sh_t.shape) != (int(nbatch), 2, P, P):
        raise ValueError(f"sh_t must be {(int(nbatch), 2, P, P)}, got "
                         f"{tuple(sh_t.shape)}")
    if sh_t.dtype != torch.float32 or sh_t.device != device:
        raise TypeError(f"sh_t must be float32 on {device}")
    if not sh_t.is_contiguous():
        raise ValueError("sh_t must be contiguous")


def _pass1_geom(P):
    """How pass 1 and the second pass cover a padded pupil ``P``: ``(PB,
    nz)``, nz blocks along the pupil, each a slice of PB <= 208 columns (a
    multiple of 16; ``w_slices`` of ``csrc/detect.cuh``): the slices of the
    laid W table."""
    nz = -(-P // _PB_MAX)
    return -(-(P // 16) // nz) * 16, nz


def _smem_bytes(N, P, mixed, passes=3):
    """Dynamic shared memory of pass 1 at ``passes`` TF32 passes
    (``pass1_smem`` of the CUDA source): a ring of 4 B stages (one 8-deep
    step of wr and wi, each as its TF32 planes, over the block's PB
    columns, or with 'mixed' noise a 32-deep slice of the mixing matrix,
    whichever is larger); the x tiles of 64 rows x 64 columns, Re and Im
    (one with 'mixed' noise, two with 'gauss' and for 'mixed' over two
    pupil slices, whose blocks make every other tile for both); with
    'mixed' noise the 32-column chunks of both components' uniforms of the
    block's 64 rows, all of the grid's where they fit, else two; 12
    mbarriers."""
    PB, nz = _pass1_geom(padded_pupil(P))
    xtiles = 1 if mixed and nz != 2 else 2
    nkc = -(-int(N) // _KU)
    nbuf = (nkc if 4 * _pass1_words(PB, mixed, xtiles, nkc, passes) + 96
            <= _SMEM_LIMIT else 2)
    return 4 * _pass1_words(PB, mixed, xtiles, nbuf, passes) + 96


def _pass1_words(PB, mixed, xtiles, nbuf, passes):
    """Words of pass 1's ring, ``xtiles`` x tiles and (with 'mixed' noise)
    ``nbuf`` chunks of uniforms (:func:`_smem_bytes`)."""
    slot = _planes_of(passes) * max(_M_PLANE if mixed else 0, 16 * PB)
    return 4 * slot + xtiles * _X_TILE + (nbuf * _U_CHUNK if mixed else 0)


def pass1_route(N, P, mixed, passes):
    """Which pass-1 kernel of ``csrc/synth_detect.cu`` a launch at an (N,
    N) grid and a P-pixel pupil takes (``dispatch_pass1``'s rule, which
    the library reports as ``fast_pass1_ahead``): 'ahead'
    (``synth_pass1_ahead``: the noise made a tile ahead by warps of its
    own, in a persistent block an SM) for 'mixed' noise (``mixed``) at
    one TF32 pass (``passes``) over one pupil slice of at most 96
    columns where ``synth_pass1`` keeps every chunk of its uniforms;
    'inline' (``synth_pass1``, its consumers making the noise) for every
    other case."""
    PB, nz = _pass1_geom(padded_pupil(P))
    nkc = -(-int(N) // _KU)
    if (mixed and passes == 1 and nz == 1 and PB <= 96
            and 4 * _pass1_words(PB, True, 1, nkc, 1) + 96 <= _SMEM_LIMIT):
        return "ahead"
    return "inline"


def _launch_route(lib, N, P, mixed, passes):
    """The pass-1 kernel that the library's launches at these arguments
    take, by its own rule (``fast_pass1_ahead``)."""
    return ("ahead" if lib.fast_pass1_ahead(int(N), int(P), int(mixed),
                                            int(passes)) else "inline")


def _ahead_smem_bytes(N, P):
    """Dynamic shared memory of ``synth_pass1_ahead`` (``ahead_smem`` and
    ``ahead_slots`` of the CUDA source): the ring of one-pass stages, one
    x tile, the grid's chunks of uniforms and up to two more chunk slots,
    as many as fit, and the mbarriers (the ring's 8, two a chunk
    slot)."""
    PB, _ = _pass1_geom(padded_pupil(P))
    nkc = -(-int(N) // _KU)

    def size(nslots):
        return (4 * _pass1_words(PB, True, 1, nslots, 1)
                + 8 * (8 + 2 * nslots))

    return next((size(n) for n in (nkc + 2, nkc + 1) if size(n)
                 <= _SMEM_LIMIT), size(nkc))


def supports(N, P):
    """Whether the kernel takes an (N, N) grid with a P-pixel pupil: any
    positive N and any pupil the tiles of ``csrc/detect.cuh`` cover (up to
    32640 px), with either noise; pass 1 keeps two chunks of 'mixed'
    uniforms where all of a grid's do not fit, so no grid side is too
    large for its shared memory."""
    return N > 0 and P > 0 and pupil_tiles(padded_pupil(P)) <= 255


def draws_per_launch(N, P, nbatch=_MAX_DRAWS):
    """Complex draws one launch takes at a padded pupil ``P``: at most 4096
    and at most 2 GiB of G' scratch (2 N P floats a draw)."""
    return max(1, min(int(nbatch), _MAX_DRAWS, _G_BYTES // (8 * N * P)))


def pupil_tiles(P):
    """Tiles of 128 px that cover a padded pupil ``P``: the kernels take
    pupils of up to 255 of them (``pass2_takes`` of ``csrc/detect.cuh``,
    32640 px)."""
    return -(-P // _P_MAX)


def detect_parts(P):
    """Partial sums a draw of the detect pass at a padded pupil ``P``
    (``detect_parts`` of ``csrc/detect.cuh``): one per 16 rows of ``H^T``
    and W slice (:func:`_pass1_geom`)."""
    return P // 16 * _pass1_geom(P)[1]


def _tf32(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to
    nearest, ties away from zero, on the 13 low mantissa bits)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _core_layout(b, width):
    """A (K, n) operand B of a tensor-core product, K a multiple of 8 and
    n of ``width`` (a multiple of 8), as wgmma reads it from shared memory
    (``csrc/wgmma.cuh``), in tiles of ``width`` columns: per tile and
    8-deep step, column c of the tile and depth slot s at word (c // 8) 64
    + (s // 4) 32 + (c % 8) 4 + s % 4, slot s holding depth 2 (s % 4) + s
    // 4. Returns (n / width, K / 8, 8 width)."""
    K, n = b.shape
    # depth 2a + e of a step is slot 4e + a: (step, a, e, tile, column // 8,
    # column % 8) to (tile, step, column // 8, e, column % 8, a)
    t = b.reshape(K // 8, 4, 2, n // width, width // 8, 8)
    return t.permute(3, 0, 4, 2, 5, 1).reshape(n // width, K // 8, 8 * width)


def _hi_lo(b):
    """(hi, lo) of a float32 tensor: ``hi = tf32(b)``, ``lo = tf32(b -
    hi)``; hi + lo carries 22 of its 24 bits."""
    hi = _tf32(b)
    return hi, _tf32(b - hi)


def _planes_of(passes):
    """TF32 planes of a laid B operand at ``passes`` TF32 passes:
    ``b_planes`` of ``csrc/wgmma.cuh``."""
    return 1 if passes == 1 else 2


def _planes(b, passes):
    """The TF32 planes of a B operand that products of ``passes`` passes
    read: ``(hi, lo)`` (:func:`_hi_lo`) or ``(hi,)``."""
    return _hi_lo(b) if passes != 1 else (_tf32(b),)


def pass1_tables(wr, wi, mix=None, passes=3):
    """The kernels' tables (``wpack``, ``mpack``) for products of
    ``passes`` TF32 passes, each operand split once into its TF32 planes
    (hi and lo at three passes, hi alone at one) and laid out as its B
    stages land in shared memory, one contiguous block a stage
    (:func:`laid_w` keeps them):

    * ``wpack``: for each of the nz slices of PB pupil columns
      (:func:`_pass1_geom` of the padded pupil, rows of ``wr`` past it
      zero) and each 8-deep step of the depth N (padded to a multiple of
      64), the step's ``wr^T`` planes, then ``wi^T``'s: (nz, N64 / 8, 4,
      8 PB) at three passes (hi, lo, hi, lo), (nz, N64 / 8, 2, 8 PB) at one;
    * ``mpack`` ('mixed' noise, else None): for each 64-column tile of
      ``mix`` and each 32-deep slice of its depth (N padded to a multiple
      of 32), the slice's 4 steps, each its planes: (N64 / 64, N32 / 32, 4,
      2 or 1, 512).

    ``wpack`` is ``W^T``, the B of both passes: pass 1's ``G' = X' W^T``
    and the second pass's ``H^T = G'^T W^T`` (``csrc/detect.cuh``).
    ``wr``, ``wi``: (P, N) with P a multiple of 16 (:func:`pad_pupil`);
    ``mix``: (N, N). On the tables' device, in stock torch ops.
    """
    return (_w_table(wr, wi, passes),
            None if mix is None else _mix_table(mix, passes))


def _w_table(wr, wi, passes=3):
    """:func:`pass1_tables`' ``wpack``."""
    P, N = wr.shape
    PB, nz = _pass1_geom(P)
    n64 = -(-N // 64) * 64
    w = torch.nn.functional.pad(torch.stack([wr, wi]),
                                (0, n64 - N, 0, nz * PB - P))
    pieces = [_core_layout(x.T, PB) for part in w
              for x in _planes(part, passes)]
    return torch.stack(pieces, dim=2).contiguous()


def _mix_table(mix, passes=3):
    """:func:`pass1_tables`' ``mpack``."""
    N = mix.shape[0]
    n64, n32 = -(-N // 64) * 64, -(-N // _KU) * _KU
    m = torch.nn.functional.pad(mix, (0, n64 - N, 0, n32 - N))
    tiles = [_core_layout(x, 64).reshape(n64 // 64, n32 // _KU, 4, 512)
             for x in _planes(m, passes)]
    return torch.stack(tiles, dim=3).contiguous()


class LaidW:
    """The laid W table: ``W^T`` (and the mixing matrix) as the card's
    kernels read them, :func:`pass1_tables`' ``wpack`` and ``mpack`` of
    each pass count, from the padded (P, N) ``wr``, ``wi`` (and ``mix``,
    or None) it keeps. :func:`laid_w` lays out the tables of ``passes``,
    the pass count it is built for (``wpack``, ``mpack``), at once;
    :meth:`tables` those of another at their first use, then keeps them.
    Pass 1 of K2 and K7, the detect pass of K1, K2 and K3, K7's screens
    pass and the AR kernels' products read it; the wrappers take it as
    ``laid=`` beside the plain ``wr``, ``wi``."""

    def __init__(self, wr, wi, mix=None, passes=3):
        self.wr, self.wi, self.mix, self.passes = wr, wi, mix, passes
        self.shape = wr.shape
        self._tables = {}

    @property
    def wpack(self):
        return self.tables(self.passes, mix=False)[0]

    @property
    def mpack(self):
        return self.tables(self.passes)[1]

    def tables(self, passes, mix=True):
        """``(wpack, mpack)`` of products of ``passes`` TF32 passes;
        ``mpack`` None without a mixing matrix or with ``mix=False``."""
        if passes not in self._tables:
            self._tables[passes] = [_w_table(self.wr, self.wi, passes), None]
        t = self._tables[passes]
        if mix and self.mix is not None and t[1] is None:
            t[1] = _mix_table(self.mix, passes)
        return t[0], t[1] if mix else None

    @property
    def device(self):
        return self.wr.device

    @property
    def nbytes(self):
        return sum(x.numel() * x.element_size()
                   for t in self._tables.values() for x in t
                   if x is not None)


def laid_w(wr, wi, mix=None, precision="highest"):
    """The :class:`LaidW` of ``wr``, ``wi`` (P, N; padded to
    :func:`padded_pupil` first) and, if given, the mixing matrix ``mix``
    (N, N), on their device, with the tables of ``precision``'s pass count
    laid out: built once per configuration by the engine
    (``interop.tables_from_numpy``) on the card. About 6.8 MB of ``wpack``
    at N = 1024 with a 416 px padded pupil and 8.4 MB of ``mpack`` at
    three passes, half that at one."""
    wr, wi, _ = pad_pupil(wr, wi, None)
    laid = LaidW(wr, wi, mix, passes(precision))
    laid.tables(laid.passes)
    return laid


def _w_tables(wr, wi, mix, laid, passes=3):
    """``(wpack, mpack)`` of a launch of ``passes`` TF32 passes on the
    padded ``wr``, ``wi``: ``laid``'s (with the mixing matrix ``mix``, if
    given) or laid out anew for the call."""
    if laid is None:
        return pass1_tables(wr, wi, mix, passes)
    _check_laid(laid, wr)
    wpack, mpack = laid.tables(passes, mix=mix is not None)
    if mix is not None and mpack is None:
        mpack = _mix_table(mix, passes)
    return wpack, mpack


def _check_laid(laid, wr):
    """Raise unless ``laid`` is the :class:`LaidW` of a W of ``wr``'s
    padded shape, on its device."""
    if not isinstance(laid, LaidW):
        raise TypeError(f"laid must be a LaidW (laid_w), got "
                        f"{type(laid).__name__}")
    want = (padded_pupil(wr.shape[0]), wr.shape[1])
    if tuple(laid.shape) != want:
        raise ValueError(f"laid is the table of a {tuple(laid.shape)} W, "
                         f"not of {want}")
    if laid.device != wr.device:
        raise ValueError(f"laid is on {laid.device}, wr on {wr.device}")


def _library():
    lib, info = _build.load_library("synth_detect")
    if not getattr(lib, "_fast_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fast_synth_detect.argtypes = [u, u, u, i, i, p, p, p, p, p, p, p,
                                          p, p, i, i, i, p]
        lib.fast_synth_detect.restype = i
        lib.fast_synth_screens.argtypes = [u, u, u, i, i, p, p, p, p, p, p,
                                           i, i, i, i, p]
        lib.fast_synth_screens.restype = i
        lib.fast_screens_pass.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
        lib.fast_screens_pass.restype = i
        lib.fast_synth_pass1.argtypes = [u, u, u, i, i, p, p, p, p, p, i, i,
                                         i, p]
        lib.fast_synth_pass1.restype = i
        lib.fast_sincos.argtypes = [p, p, p, i, p]
        lib.fast_sincos.restype = i
        lib.fast_pass1_ahead.argtypes = [i, i, i, i]
        lib.fast_pass1_ahead.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def build():
    """Build (or find) the kernel's library; returns its build info."""
    return _library()[1]


def raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err} "
                           f"({lib.fast_error_string(err).decode()})")


def check_tables(tables, nbatch):
    """Raise unless each ``name: (tensor, shape)`` of ``tables`` (the first
    one's shape None: it sets the device) is a contiguous float32 tensor
    of that shape on the first one's device, and ``nbatch`` > 0."""
    (name0, (t0, _)), *_ = tables.items()
    for name, (t, shape) in tables.items():
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != t0.device:
            raise ValueError(f"{name} is on {t.device}, {name0} on "
                             f"{t0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if int(nbatch) <= 0:
        raise ValueError("nbatch must be positive")


def _check(s_t, wr, wi, pm_t, nbatch, mix):
    if s_t.ndim != 2 or s_t.shape[0] != s_t.shape[1]:
        raise ValueError(f"s_t must be (N, N), got {tuple(s_t.shape)}")
    N = s_t.shape[0]
    P = wr.shape[0]
    tables = {"s_t": (s_t, None), "wr": (wr, (P, N)), "wi": (wi, (P, N))}
    if pm_t is not None:
        tables["pm_t"] = (pm_t, (P, P))
    if mix is not None:
        tables["mix"] = (mix, (N, N))
    check_tables(tables, nbatch)
    return N, P


def _launch_args(s_t, wr, wi, nbatch, mix, stream, what):
    """Checks shared by the kernels' launches; returns N."""
    N = s_t.shape[0]
    if not supports(N, wr.shape[0]):
        raise ValueError(
            f"the {what} kernel takes a pupil of at most 32640 px; got "
            f"N={N}, P={wr.shape[0]}")
    if not 0 <= int(stream) < 2 ** 32:
        raise ValueError("stream must fit in 32 bits")
    return N


def synth_detect(seed, s_t, wr, wi, pm_t, nbatch, mix=None, stream=0,
                 sh_t=None, laid=None, precision="highest"):
    """K2 on ``nbatch`` complex draws; arguments as
    :func:`synth_detect_reference`.

    On CUDA tensors this launches the kernel (two passes per launch of
    :func:`draws_per_launch` draws, each launch from the draw index it
    starts at) on the current stream, its products in the TF32 passes of
    ``precision`` (:data:`PASSES`), and counts each launch in
    ``synth_detect.LAUNCHES``, in ``LAUNCHES_BY_PASSES`` and, by the
    kernel its pass 1 takes (:func:`pass1_route`), in
    ``LAUNCHES_BY_ROUTE``, or raises for a shape it does not take
    (:func:`supports`); on CPU tensors it runs the plain version at
    ``precision``. ``sh_t`` is padded as ``wr`` is.
    ``laid``: the :class:`LaidW` of ``wr``, ``wi`` (and ``mix``), the
    engine's; without it the kernel's tables are laid out for the call.
    """
    N, P = _check(s_t, wr, wi, pm_t, nbatch, mix)
    npass = passes(precision)
    if laid is not None:
        _check_laid(laid, wr)
    dev = s_t.device
    if dev.type == "cpu":
        return synth_detect_reference(seed, s_t, wr, wi, pm_t, nbatch,
                                      mix=mix, stream=stream, sh_t=sh_t,
                                      precision=precision)
    if dev.type != "cuda":
        raise ValueError(f"synth_detect runs on CPU or CUDA, not {dev}")
    N = _launch_args(s_t, wr, wi, nbatch, mix, stream, "synth-detect")
    k0, k1 = _key(seed)
    wr, wi, pm_t = pad_pupil(wr, wi, pm_t)
    Pp = wr.shape[0]
    wpack, mpack = _w_tables(wr, wi, mix, laid, npass)
    check_subharm(sh_t, nbatch, Pp, dev)
    lib, _ = _library()
    nbatch = int(nbatch)
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, Pp, nbatch)
    g = torch.empty((2, per, N, Pp), dtype=torch.float32, device=dev)
    part = torch.empty((per, detect_parts(Pp), 4), dtype=torch.float32,
                       device=dev)
    route = _launch_route(lib, N, Pp, mpack is not None, npass)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_synth_detect(
                k0, k1, int(stream), d0, nb, s_t.data_ptr(),
                pm_t.data_ptr(), wpack.data_ptr(),
                None if mpack is None else mpack.data_ptr(),
                None if sh_t is None else sh_t[d0].data_ptr(),
                g[0].data_ptr(), g[1].data_ptr(), part.data_ptr(),
                out[d0:d0 + nb].data_ptr(), N, Pp, npass, cs)
            raise_on(lib, err, "synth_detect launch")
            count(synth_detect, npass)
            synth_detect.LAUNCHES_BY_ROUTE[route] += 1
    return _pack(out)


def count(wrapper, npass):
    """One launch of ``wrapper``'s kernel at ``npass`` TF32 passes: adds
    one to ``wrapper.LAUNCHES`` and to ``wrapper.LAUNCHES_BY_PASSES[npass]``,
    the count of that instantiation."""
    wrapper.LAUNCHES += 1
    wrapper.LAUNCHES_BY_PASSES[npass] += 1


def counters(wrapper):
    """Give ``wrapper`` its launch counts, all 0: ``LAUNCHES`` and
    ``LAUNCHES_BY_PASSES`` (by pass count, 1 and 3)."""
    wrapper.LAUNCHES = 0
    wrapper.LAUNCHES_BY_PASSES = {1: 0, 3: 0}


counters(synth_detect)
# launches by the kernel their pass 1 takes (pass1_route)
synth_detect.LAUNCHES_BY_ROUTE = {"ahead": 0, "inline": 0}


def synth_screens(seed, s_t, wr, wi, nbatch, npup=None, stream=0,
                  laid=None, precision="highest"):
    """K7 on ``nbatch`` complex draws: (2 * nbatch, npup, npup) float32
    screens; arguments as :func:`synth_screens_reference`.

    On CUDA tensors this launches the kernel (K2's pass 1 with Box-Muller
    noise, then the screens pass; launches as :func:`synth_detect`'s, at
    ``precision``) on the current stream and counts each launch in
    ``synth_screens.LAUNCHES`` and ``LAUNCHES_BY_PASSES``; on CPU tensors
    it runs the plain version. ``laid`` as :func:`synth_detect`'s.
    """
    npup = wr.shape[0] if npup is None else int(npup)
    if not 0 < npup <= wr.shape[0]:
        raise ValueError(f"npup must be in 1..{wr.shape[0]}, got {npup}")
    _check(s_t, wr, wi, None, nbatch, None)
    npass = passes(precision)
    if laid is not None:
        _check_laid(laid, wr)
    dev = s_t.device
    if dev.type == "cpu":
        return synth_screens_reference(seed, s_t, wr, wi, nbatch, npup=npup,
                                       stream=stream, precision=precision)
    if dev.type != "cuda":
        raise ValueError(f"synth_screens runs on CPU or CUDA, not {dev}")
    N = _launch_args(s_t, wr, wi, nbatch, None, stream, "synth-screens")
    k0, k1 = _key(seed)
    wr, wi, _ = pad_pupil(wr, wi, None)
    Pp = wr.shape[0]
    wpack, _ = _w_tables(wr, wi, None, laid, npass)
    lib, _ = _library()
    nbatch = int(nbatch)
    scr = torch.empty((2, nbatch, npup, npup), dtype=torch.float32,
                      device=dev)
    per = draws_per_launch(N, Pp, nbatch)
    g = torch.empty((2, per, N, Pp), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_synth_screens(
                k0, k1, int(stream), d0, nb, s_t.data_ptr(),
                wpack.data_ptr(), g[0].data_ptr(), g[1].data_ptr(),
                scr[0, d0].data_ptr(), scr[1, d0].data_ptr(), N, Pp, npup,
                npass, cs)
            raise_on(lib, err, "synth_screens launch")
            count(synth_screens, npass)
    return scr.reshape(2 * nbatch, npup, npup)


counters(synth_screens)


def screens_pass_reference(gr, gi, wr, wi, npup=None, precision="highest"):
    """K7's screens pass in stock torch ops: the screens ``Re, Im (W
    G')^T`` of each draw's ``G'`` (``gr``, ``gi``: (nbatch, N, P)) cropped
    to ``npup`` px (default the rows of ``wr``): (2 * nbatch, npup, npup)
    float32, real parts first, as :func:`synth_screens_reference`; the
    products at ``precision``."""
    npup = wr.shape[0] if npup is None else int(npup)
    wr, wi = wr[:npup], wi[:npup]
    gr, gi = gr[..., :npup], gi[..., :npup]
    re = (mm(wr, gr, precision) - mm(wi, gi, precision)).transpose(-2, -1)
    im = (mm(wr, gi, precision) + mm(wi, gr, precision)).transpose(-2, -1)
    return torch.cat([re, im]).contiguous()


def screens_pass(gr, gi, wr, wi, npup=None, laid=None, precision="highest"):
    """K7's screens pass alone: the screens (2 * nbatch, npup, npup) of
    :func:`screens_pass_reference` from each draw's ``G'`` (``gr``,
    ``gi``: (nbatch, N, P), P a multiple of 16, as :func:`synth_pass1`
    returns it; ``wr``, ``wi``: (P, N)). For timing the pass and holding it
    element by element against that plain version.

    On CUDA tensors this launches ``screens_pass`` of ``csrc/detect.cuh``
    (one launch of the given draws at ``precision``, counted in
    ``screens_pass.LAUNCHES`` and ``LAUNCHES_BY_PASSES``) on the current
    stream, or raises; on CPU tensors it runs the plain version. ``laid``
    as :func:`synth_detect`'s.
    """
    if gr.ndim != 3:
        raise ValueError(f"gr must be (nbatch, N, P), got {tuple(gr.shape)}")
    nbatch, N, P = gr.shape
    npup = P if npup is None else int(npup)
    if not 0 < npup <= P:
        raise ValueError(f"npup must be in 1..{P}, got {npup}")
    check_tables({"gr": (gr, None), "gi": (gi, (nbatch, N, P)),
                  "wr": (wr, (P, N)), "wi": (wi, (P, N))}, nbatch)
    npass = passes(precision)
    if laid is not None:
        _check_laid(laid, wr)
    dev = gr.device
    if dev.type == "cpu":
        return screens_pass_reference(gr, gi, wr, wi, npup, precision)
    if dev.type != "cuda":
        raise ValueError(f"screens_pass runs on CPU or CUDA, not {dev}")
    if P % _P_ALIGN or pupil_tiles(P) > 255:
        raise ValueError(f"the screens pass takes a pupil padded to a "
                         f"multiple of 16 px; got P={P}")
    wpack, _ = _w_tables(wr, wi, None, laid, npass)
    lib, _ = _library()
    scr = torch.empty((2, nbatch, npup, npup), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.fast_screens_pass(
            nbatch, wpack.data_ptr(), gr.data_ptr(), gi.data_ptr(),
            scr[0].data_ptr(), scr[1].data_ptr(), N, P, npup, npass,
            torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "screens_pass launch")
    count(screens_pass, npass)
    return scr.reshape(2 * nbatch, npup, npup)


counters(screens_pass)


def synth_pass1_reference(seed, s_t, wr, wi, nbatch, mix=None, stream=0,
                          draw0=0, precision="highest"):
    """Pass 1 of K2 and K7 in stock torch ops: ``(gr, gi)``, the real and
    imaginary parts of ``G' = X' W^T``, (nbatch, N, P) float32 for the P
    rows of ``wr``; arguments as :func:`synth_detect_reference`."""
    parts = list(_gprime_reference(seed, s_t, wr, wi, nbatch, mix, stream,
                                   draw0, None, precision))
    return (torch.cat([gr for _, gr, _ in parts]),
            torch.cat([gi for _, _, gi in parts]))


def synth_pass1(seed, s_t, wr, wi, nbatch, mix=None, stream=0, draw0=0,
                laid=None, precision="highest"):
    """Pass 1 of K2 ('mixed' noise with ``mix``) or of K7 and K2 'gauss'
    (``mix=None``) alone: ``(gr, gi)``, (nbatch, N, P) float32 with the
    pupil axis padded to :func:`padded_pupil` (padded columns are zero).
    For timing pass 1 and holding it against
    :func:`synth_pass1_reference` element by element.

    On CUDA tensors this launches pass 1 of ``csrc/synth_detect.cu``
    (launches of :func:`draws_per_launch` draws at ``precision``, counted in
    ``synth_pass1.LAUNCHES``, ``LAUNCHES_BY_PASSES`` and
    ``LAUNCHES_BY_ROUTE``) on the current stream, or raises; on CPU
    tensors it runs the plain version. ``laid`` as :func:`synth_detect`'s.
    """
    _check(s_t, wr, wi, None, nbatch, mix)
    npass = passes(precision)
    if laid is not None:
        _check_laid(laid, wr)
    wr, wi, _ = pad_pupil(wr, wi, None)
    dev = s_t.device
    if dev.type == "cpu":
        return synth_pass1_reference(seed, s_t, wr, wi, nbatch, mix=mix,
                                     stream=stream, draw0=draw0,
                                     precision=precision)
    if dev.type != "cuda":
        raise ValueError(f"synth_pass1 runs on CPU or CUDA, not {dev}")
    N = _launch_args(s_t, wr, wi, nbatch, mix, stream, "synth pass-1")
    k0, k1 = _key(seed)
    Pp = wr.shape[0]
    wpack, mpack = _w_tables(wr, wi, mix, laid, npass)
    lib, _ = _library()
    nbatch = int(nbatch)
    g = torch.empty((2, nbatch, N, Pp), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, Pp, nbatch)
    route = _launch_route(lib, N, Pp, mpack is not None, npass)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_synth_pass1(
                k0, k1, int(stream), int(draw0) + d0, nb, s_t.data_ptr(),
                wpack.data_ptr(), None if mpack is None else mpack.data_ptr(),
                g[0, d0].data_ptr(), g[1, d0].data_ptr(), N, Pp, npass, cs)
            raise_on(lib, err, "synth_pass1 launch")
            count(synth_pass1, npass)
            synth_pass1.LAUNCHES_BY_ROUTE[route] += 1
    return g[0], g[1]


counters(synth_pass1)
synth_pass1.LAUNCHES_BY_ROUTE = {"ahead": 0, "inline": 0}


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
    raise_on(lib, err, "sincos launch")
    return s, c
