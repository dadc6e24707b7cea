"""K1 and K3: colfac-basis synthesis and pupil-overlap detection.

The port of ``fast_tpu.ops.pallas_synth.fused_colfac_detect``: K1 is its
merged layout (``_colfac_detect_kernel_merged``), for pupils of at most
128 px, K3 its split layout (``_colfac_detect_kernel``), for wider ones;
:func:`colfac_layout` is the rule between them. For ``nbatch`` complex
draws each draws every column of ``G = W X`` as ``L_m z_m`` from the
per-column Cholesky factors of the pupil-row covariance, applies ``W`` and
returns the pupil-overlap sums of both screens of each draw, in K2's
output layout.

* :func:`pack_tables` turns the factors ``L`` (N, npup, npup) into the
  kernel's table ``S`` (N, K, P, 2) float32: per column the real-block
  form of ``M L_m^T`` ('mixed', ``M`` the 128 x 128 mixing matrix) or
  ``L_m^T`` ('gauss'), rows ``2q``/``2q + 1`` for the real and imaginary
  noise of lane ``q``, columns ``(Re, Im)`` of each pupil pixel (see
  ``csrc/colfac_detect.cu``).
* :func:`colfac_detect` is the wrapper: on a CUDA tensor it launches the
  hand-written kernel (built at first use) or raises; on a CPU tensor it
  runs :func:`colfac_detect_reference`.
* :func:`colfac_detect_reference` is the same function in stock torch ops,
  from the same Philox bits: counter ``(m * 128 + q, draw, stream, 1)``
  for lane ``q`` of column ``m``.

* :func:`pack_tables_split`, :func:`colfac_detect_split` and
  :func:`colfac_split_reference` are the same three for K3: the table
  ``T`` (N, Kq, P, 2) holds ``M L_m^T`` (or ``L_m^T``) once, real and
  imaginary parts interleaved per pupil pixel, and the Philox counter is
  ``(m * LW + q, draw, stream, 3)`` with ``LW`` the pupil rounded up to
  128 (``csrc/colfac_split.cu``).

* The passes alone, for timing them and holding each against its plain
  version: :func:`colfac_pass1` and :func:`split_pass1` (pass 1 of K1 and
  of K3: ``G'``, with :func:`colfac_pass1_reference` and
  :func:`split_pass1_reference`), and :func:`detect_pass` (the detect pass
  that K1, K2 and K3 share, ``csrc/detect.cuh``, against
  :func:`~fast_tpu_torch.ops.synth_detect.detect_reference`). Each counts
  its launches in its own ``LAUNCHES``. Both kernels run both products on
  the tensor cores in 3xTF32 on Hopper's ``wgmma``: pass 1 from tables
  split and laid out once (:func:`lay_tables`, :func:`lay_tables_split`,
  :class:`LaidTable`; :func:`laid_table` builds one from ``L``,
  :func:`kernel_table` the engine's), the detect pass from the laid W
  table (:class:`~fast_tpu_torch.ops.synth_detect.LaidW`, ``laid=``; laid
  out for the call without it).

Mixing width: 'mixed' noise mixes 128 uniforms per component per column
in K1, as the TPU kernel does over its 128-lane tile, and ``LW`` in K3,
the TPU kernel's lane width there; 'gauss' draws only the lanes that meet
nonzero rows of ``L``.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .synth_detect import (_P_MAX, _PB_MAX, _REF_POINTS, _check_laid,
                           _hi_lo, _key, _pack, _w_tables, box_muller,
                           check_subharm, check_tables, detect_parts,
                           detect_reference, draws_per_launch, mixing_matrix,
                           padded_pupil, philox4x32_10, pupil_tiles, raise_on,
                           uniforms)

LANES = 128  # Philox lanes per column; 'mixed' noise mixes all of them
_STAGES_K1 = 6   # fold groups in K1's ring of B stages
_STAGES_K3 = 4   # 8-deep steps in K3's
_X_TILE = 2 * 64 * 64  # words of one of K3's x tiles of noise
_MAX_CLUSTER = 8  # the portable cluster size


def supports(N, P):
    """Whether K1 takes an (N, N) grid with a P-pixel pupil: a pupil of at
    most 128 px and at most 65535 columns."""
    return 0 < P <= _P_MAX and 0 < N <= 65535


def colfac_layout(npup):
    """The colfac kernel of a pupil width: 'merged' (K1) up to 128 px,
    'split' (K3) above; the geometry rule of
    ``fast_tpu.ops.pallas_synth.colfac_layout``."""
    return "split" if int(npup) > _P_MAX else "merged"


def lane_width(npup):
    """K3's Philox lanes a column and its mixing width: the pupil rounded
    up to a multiple of 128, the TPU kernel's lane width."""
    return -(-int(npup) // LANES) * LANES


def pack_tables(L, mixed=True):
    """The kernel's factor table from ``L`` (N, npup, npup) complex.

    Float32 whatever the working type: ``S`` (N, K, P, 2) with
    ``P = padded_pupil(npup)`` and ``K`` rows, two per noise lane: 128
    lanes for 'mixed' noise, ``P`` for 'gauss', whose lanes past the
    pupil would meet zero rows.
    Per column ``B = M L^T`` ('mixed', the mix folded into the factor as
    ``fast_tpu.ops.pallas_synth.colfac_pack_tables_merged`` does) or
    ``B = L^T``, zero padded; ``S[2q, p] = (Re B, Im B)[q, p]`` and
    ``S[2q + 1, p] = (-Im B, Re B)[q, p]``. Runs on ``L``'s device; the
    mix is folded in float64, so no TF32 setting reaches the table.
    """
    L = L.to(torch.complex64)
    N, npup, _ = L.shape
    P = padded_pupil(npup)
    Kq = LANES if mixed else P
    Lt = L.transpose(1, 2)                      # Lt[m, q, p] = L[m, p, q]
    br = torch.zeros((N, Kq, P), dtype=torch.float32, device=L.device)
    bi = torch.zeros_like(br)
    br[:, :npup, :npup] = Lt.real
    bi[:, :npup, :npup] = Lt.imag
    if mixed:
        M = torch.from_numpy(mixing_matrix(LANES).astype(np.float64))
        M = M.to(L.device)
        br, bi = (M @ br.double()).float(), (M @ bi.double()).float()
    S = torch.stack([torch.stack([br, bi], dim=-1),
                     torch.stack([-bi, br], dim=-1)], dim=2)
    return S.reshape(N, 2 * Kq, P, 2).contiguous()


class LaidTable:
    """A factor table as the card's pass 1 reads it: ``data``, the table
    split into TF32 hi and lo parts and laid out in ``wgmma``'s
    core-matrix order (:func:`lay_tables`, :func:`lay_tables_split`), and
    ``shape``, the (N, K or Kq, P, 2) shape of the table it was laid from.
    The kernel wrappers take it in place of that table on the card."""

    def __init__(self, data, shape, split):
        self.data, self.shape, self.split = data, torch.Size(shape), split

    @property
    def device(self):
        return self.data.device

    @property
    def nbytes(self):
        return self.data.numel() * self.data.element_size()


def _core_steps(b):
    """``b`` (..., K, n), K a multiple of 8, as the 8-deep steps of a B
    operand of ``wgmma`` (``csrc/wgmma.cuh``): (..., K / 8, 8 n), column c
    and depth slot s of a step at word (c // 8) 64 + (s // 4) 32 + (c % 8) 4
    + s % 4, slot s holding depth 2 (s % 4) + s // 4 (the A fragments'
    order); ``synth_detect._core_layout`` with one tile of all n columns."""
    *lead, K, n = b.shape
    t = b.reshape(*lead, K // 8, 4, 2, n // 8, 8)
    nl = len(lead)
    perm = list(range(nl)) + [nl + i for i in (0, 3, 2, 4, 1)]
    return t.permute(perm).reshape(*lead, K // 8, 8 * n)


def lay_tables(S):
    """K1's table ``S`` (:func:`pack_tables`) as its pass 1 reads it: a
    :class:`LaidTable` of (N, K / 8, 2, 16 P) float32, per column and
    8-deep step of the K rows S_m's TF32 hi, then lo part (hi + lo carries
    22 of the 24 bits), over the 2P output columns in ``wgmma``'s
    core-matrix order, the columns of each 8 px block as 8 Re, then 8 Im
    (``csrc/colfac_detect.cu``). On ``S``'s device, in stock torch ops."""
    N, K, P, _ = S.shape
    B = S.reshape(N, K, P // 8, 8, 2).transpose(-1, -2).reshape(N, K, 2 * P)
    hi, lo = _hi_lo(B)
    data = torch.stack([_core_steps(hi), _core_steps(lo)], dim=2)
    return LaidTable(data.contiguous(), S.shape, split=False)


def _pass1_smem(P):
    """Bytes of K1's pass-1 shared memory at a padded pupil ``P``
    (``pass1_smem`` of ``csrc/colfac_detect.cu``): a ring of 6 fold groups,
    two 8-deep steps of hi and lo over 2P columns each, and 12 mbarriers."""
    return 4 * _STAGES_K1 * 2 * 2 * 8 * 2 * P + 8 * 2 * _STAGES_K1


def colfac_bits(seed, nbatch, N, lanes, stream=0, device="cpu", draw0=0,
                lane_stride=LANES, word=1):
    """The kernel's two random words per noise lane: ``(b1, b2)``, int64
    tensors of 32-bit values, shape (nbatch, N, lanes), for draws
    ``draw0 .. draw0 + nbatch - 1``; counter ``(m * lane_stride + q, d,
    stream, word)``, key the 64-bit ``seed``. K1: a stride of 128 and last
    word 1; K3: :func:`lane_width` and 3."""
    k0, k1 = _key(seed)
    m = torch.arange(N, dtype=torch.int64, device=device)[:, None]
    q = torch.arange(lanes, dtype=torch.int64, device=device)[None, :]
    e = (m * int(lane_stride) + q).reshape(1, -1)
    d = torch.arange(draw0, draw0 + nbatch, dtype=torch.int64,
                     device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    x0, x1, _, _ = philox4x32_10(e, d, zero + int(stream), zero + int(word),
                                 k0, k1)
    return x0.reshape(nbatch, N, lanes), x1.reshape(nbatch, N, lanes)


def _colfac_gprime(seed, S, nbatch, mixed, stream, draw0, bits):
    """K1's pass 1 in stock torch ops, in pieces of bounded size: yields
    ``(d0, gr, gi)``, the ``G'`` (nb, N, P) of draws ``d0 ..``."""
    N, K, P, _ = S.shape
    lanes = K // 2
    St = S.reshape(N, K, 2 * P)
    per = max(1, _REF_POINTS // (N * lanes))
    for d0 in range(0, int(nbatch), per):
        nb = min(per, int(nbatch) - d0)
        if bits is None:
            b = colfac_bits(seed, nb, N, lanes, stream, device=S.device,
                            draw0=draw0 + d0)
        else:
            b = (bits[0][d0:d0 + nb], bits[1][d0:d0 + nb])
        z = (torch.stack([uniforms(b[0]), uniforms(b[1])], dim=-1) if mixed
             else torch.stack(box_muller(*b), dim=-1))
        # (m, nb, K) @ (m, K, 2P): every column's noise times its factor
        g = (z.reshape(nb, N, K).transpose(0, 1) @ St).transpose(0, 1)
        g = g.reshape(nb, N, P, 2)
        yield d0, g[..., 0], g[..., 1]


def colfac_detect_reference(seed, S, wr, wi, pm_t, nbatch, mixed=True,
                            stream=0, draw0=0, bits=None, sh_t=None):
    """K1 in stock torch ops (see the module docstring).

    Args:
        seed: 64-bit integer key of the Philox generator.
        S: (N, K, P, 2) float32 factor table (:func:`pack_tables`).
        wr, wi: (P, N) float32 pruned inverse-DFT matrix, zero padded.
        pm_t: (P, P) float32 transposed pupil * mode, zero padded.
        nbatch: number of complex draws (2 * nbatch screens).
        mixed: raw uniforms ('mixed', the mix is in ``S``) or Box-Muller.
        stream: counter word that separates the streams of one seed.
        draw0: counter index of the first draw.
        bits: optional ``(b1, b2)`` integer tensors (nbatch, N, K // 2) of
            32-bit values in place of the Philox bits.
        sh_t: optional (nbatch, 2, P, P) transposed subharmonic screens.

    Returns:
        (2 * nbatch, 2) float32 tensor, the layout of K2's.
    """
    return _pack(torch.cat([
        detect_reference(gr, gi, wr, wi, pm_t,
                         None if sh_t is None
                         else sh_t[d0:d0 + gr.shape[0]])
        for d0, gr, gi in _colfac_gprime(seed, S, nbatch, mixed, stream,
                                         draw0, bits)]))


def _library():
    lib, info = _build.load_library("colfac_detect")
    if not getattr(lib, "_fast_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fast_colfac_detect.argtypes = [u, u, u, i, i, p, p, p, p, p, p, p,
                                           p, i, i, i, i, p]
        lib.fast_colfac_detect.restype = i
        lib.fast_colfac_pass1.argtypes = [u, u, u, i, i, p, p, p, i, i, i, i,
                                          p]
        lib.fast_colfac_pass1.restype = i
        lib.fast_detect_pass.argtypes = [i, p, p, p, p, p, p, p, i, i, p]
        lib.fast_detect_pass.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def _data(S, split):
    """The tensor of a table the wrappers take: ``S`` itself or a
    :class:`LaidTable`'s data (of the layout ``split`` says)."""
    if not isinstance(S, LaidTable):
        return S
    if S.split != split:
        raise ValueError(f"a table laid out for {'K1' if split else 'K3'} "
                         f"passed to {'K3' if split else 'K1'}")
    N, K, P, _ = S.shape
    if split:
        PB, nz, _ = _split_geom(P)
        want = (N, nz, -(-K // 64) * 8, 4, 8 * PB)
    else:
        want = (N, K // 8, 2, 16 * P)
    if tuple(S.data.shape) != want:
        raise ValueError(f"a LaidTable of {tuple(S.shape)} must hold {want}, "
                         f"got {tuple(S.data.shape)}")
    return S.data


def _laid(S, what):
    """``S`` as its pass 1 reads it on the card: a :class:`LaidTable`, or
    the plain table laid out anew for this call (``what`` does it)."""
    return S if isinstance(S, LaidTable) else what(S)


def _plain(S, what):
    """Raise unless the plain version can take ``S``: it takes the table of
    :func:`pack_tables` (:func:`pack_tables_split`), not a laid one."""
    if isinstance(S, LaidTable):
        raise ValueError(f"{what}'s plain version takes the unsplit table; a "
                         f"LaidTable runs only on the card")


def _check_table(S, mixed):
    if len(S.shape) != 4 or S.shape[-1] != 2:
        raise ValueError(f"S must be (N, K, P, 2), got {tuple(S.shape)}")
    N, K, P, _ = S.shape
    if mixed and K != 2 * LANES:
        raise ValueError(f"'mixed' noise takes S with K = {2 * LANES} rows, "
                         f"got {K}")
    if K % 32 or not 0 < K <= 2 * LANES:
        raise ValueError(f"S must have a multiple of 32 rows, at most "
                         f"{2 * LANES}; got {K}")
    return N, K, P


def _check(S, wr, wi, pm_t, nbatch, mixed):
    N, K, P = _check_table(S, mixed)
    check_tables({"S": (_data(S, False), None), "wr": (wr, (P, N)),
                  "wi": (wi, (P, N)), "pm_t": (pm_t, (P, P))}, nbatch)
    return N, K, P


def _check_launch(N, P, stream):
    """Raise unless K1's kernel takes the shape and the stream word."""
    if not supports(N, P) or P % 16:
        raise ValueError(
            f"the colfac-detect kernel takes a pupil padded to a multiple of "
            f"16 px up to {_P_MAX} px and at most 65535 columns; got N={N}, "
            f"P={P}")
    _check_stream(stream)


def _check_stream(stream):
    if not 0 <= int(stream) < 2 ** 32:
        raise ValueError("stream must fit in 32 bits")


def colfac_detect(seed, S, wr, wi, pm_t, nbatch, mixed=True, stream=0,
                  sh_t=None, laid=None):
    """K1 on ``nbatch`` complex draws; arguments as
    :func:`colfac_detect_reference`.

    On CUDA tensors this launches the kernel (two passes per launch of
    :func:`~fast_tpu_torch.ops.synth_detect.draws_per_launch` draws, each
    launch from the draw index it starts at) on the current stream and
    counts each launch in ``colfac_detect.LAUNCHES``, or raises for a
    shape it does not take (:func:`supports`); on CPU tensors it runs the
    plain version. On the card ``S`` may be the :class:`LaidTable` of
    :func:`lay_tables` (the engine's, laid out once per configuration); a
    plain ``S`` is laid out anew for the call. ``laid``: the
    :class:`~fast_tpu_torch.ops.synth_detect.LaidW` of ``wr``, ``wi`` that
    the detect pass reads (the engine's), else laid out for the call.
    """
    N, K, P = _check(S, wr, wi, pm_t, nbatch, mixed)
    if laid is not None:
        _check_laid(laid, wr)
    dev = S.device
    check_subharm(sh_t, nbatch, P, dev)
    if dev.type == "cpu":
        _plain(S, "colfac_detect")
        return colfac_detect_reference(seed, S, wr, wi, pm_t, nbatch,
                                       mixed=mixed, stream=stream, sh_t=sh_t)
    if dev.type != "cuda":
        raise ValueError(f"colfac_detect runs on CPU or CUDA, not {dev}")
    _check_launch(N, P, stream)
    S = _laid(S, lay_tables).data
    wpack, _ = _w_tables(wr, wi, None, laid)
    k0, k1 = _key(seed)
    lib, _ = _library()
    nbatch = int(nbatch)
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, P, nbatch)
    g = torch.empty((2, per, N, P), dtype=torch.float32, device=dev)
    part = torch.empty((per, detect_parts(P), 4), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_colfac_detect(
                k0, k1, int(stream), d0, nb, S.data_ptr(), wpack.data_ptr(),
                pm_t.data_ptr(),
                None if sh_t is None else sh_t[d0].data_ptr(),
                g[0].data_ptr(), g[1].data_ptr(), part.data_ptr(),
                out[d0:d0 + nb].data_ptr(), N, P, K, int(bool(mixed)), cs)
            raise_on(lib, err, "colfac_detect launch")
            colfac_detect.LAUNCHES += 1
    return _pack(out)


colfac_detect.LAUNCHES = 0


def colfac_pass1_reference(seed, S, nbatch, mixed=True, stream=0, draw0=0):
    """Pass 1 of K1 in stock torch ops: ``(gr, gi)``, the real and
    imaginary parts of ``G'``, (nbatch, N, P) float32; arguments as
    :func:`colfac_detect_reference`."""
    parts = list(_colfac_gprime(seed, S, nbatch, mixed, stream, draw0, None))
    return (torch.cat([gr for _, gr, _ in parts]),
            torch.cat([gi for _, _, gi in parts]))


def colfac_pass1(seed, S, nbatch, mixed=True, stream=0, draw0=0):
    """Pass 1 of K1 alone: ``(gr, gi)``, (nbatch, N, P) float32, the
    ``G'`` that :func:`colfac_detect` detects. For timing the pass and
    holding it against :func:`colfac_pass1_reference` element by element.

    On CUDA tensors this launches pass 1 of ``csrc/colfac_detect.cu``
    (launches of :func:`~fast_tpu_torch.ops.synth_detect.draws_per_launch`
    draws, counted in ``colfac_pass1.LAUNCHES``) on the current stream, or
    raises; on CPU tensors it runs the plain version. ``S`` as
    :func:`colfac_detect` takes it.
    """
    N, K, P = _check_table(S, mixed)
    check_tables({"S": (_data(S, False), None)}, nbatch)
    dev = S.device
    if dev.type == "cpu":
        _plain(S, "colfac_pass1")
        return colfac_pass1_reference(seed, S, nbatch, mixed=mixed,
                                      stream=stream, draw0=draw0)
    if dev.type != "cuda":
        raise ValueError(f"colfac_pass1 runs on CPU or CUDA, not {dev}")
    _check_launch(N, P, stream)
    S = _laid(S, lay_tables).data
    k0, k1 = _key(seed)
    lib, _ = _library()
    nbatch = int(nbatch)
    g = torch.empty((2, nbatch, N, P), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, P, nbatch)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_colfac_pass1(
                k0, k1, int(stream), int(draw0) + d0, nb, S.data_ptr(),
                g[0, d0].data_ptr(), g[1, d0].data_ptr(), N, P, K,
                int(bool(mixed)), cs)
            raise_on(lib, err, "colfac_pass1 launch")
            colfac_pass1.LAUNCHES += 1
    return g[0], g[1]


colfac_pass1.LAUNCHES = 0


def detect_pass(gr, gi, wr, wi, pm_t, sh_t=None, laid=None):
    """The detect pass of K1, K2 and K3 alone: the sums (nbatch, 4) of
    :func:`~fast_tpu_torch.ops.synth_detect.detect_reference` from each
    draw's ``G'`` (``gr``, ``gi``: (nbatch, N, P), P a multiple of 16, as
    the pass-1 wrappers return it). For timing the pass and holding it
    against that plain version.

    On CUDA tensors this launches ``detect_pass`` of ``csrc/detect.cuh``
    (one launch of the given draws, then ``sum_tiles``, counted in
    ``detect_pass.LAUNCHES``) on the current stream, or raises; on CPU
    tensors it runs the plain version. ``laid``: the
    :class:`~fast_tpu_torch.ops.synth_detect.LaidW` of ``wr``, ``wi``, else
    laid out for the call.
    """
    if gr.ndim != 3:
        raise ValueError(f"gr must be (nbatch, N, P), got {tuple(gr.shape)}")
    nbatch, N, P = gr.shape
    check_tables({"gr": (gr, None), "gi": (gi, (nbatch, N, P)),
                  "wr": (wr, (P, N)), "wi": (wi, (P, N)),
                  "pm_t": (pm_t, (P, P))}, nbatch)
    dev = gr.device
    check_subharm(sh_t, nbatch, P, dev)
    if laid is not None:
        _check_laid(laid, wr)
    if dev.type == "cpu":
        return detect_reference(gr, gi, wr, wi, pm_t, sh_t)
    if dev.type != "cuda":
        raise ValueError(f"detect_pass runs on CPU or CUDA, not {dev}")
    if P % 16 or pupil_tiles(P) > 255:
        raise ValueError(f"the detect pass takes a pupil padded to a "
                         f"multiple of 16 px; got P={P}")
    wpack, _ = _w_tables(wr, wi, None, laid)
    lib, _ = _library()
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    part = torch.empty((nbatch, detect_parts(P), 4), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.fast_detect_pass(
            nbatch, wpack.data_ptr(), gr.data_ptr(),
            gi.data_ptr(), pm_t.data_ptr(),
            None if sh_t is None else sh_t.data_ptr(), part.data_ptr(),
            out.data_ptr(), N, P, torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "detect_pass launch")
    detect_pass.LAUNCHES += 1
    return out


detect_pass.LAUNCHES = 0


# ---------------------------------------------------------------------------
# K3: the split layout, for pupils over 128 px
# ---------------------------------------------------------------------------


def _split_columns(L, mixed, per=64):
    """:func:`pack_tables_split`'s table ``per`` columns at a time: yields
    ``(m0, T[m0 : m0 + per])``."""
    L = L.to(torch.complex64)
    N, npup, _ = L.shape
    P = padded_pupil(npup)
    Kq = lane_width(npup) if mixed else P
    if mixed:
        M = torch.from_numpy(mixing_matrix(Kq).astype(np.float64))
        M = M[:, :npup].to(L.device)
    for m0 in range(0, N, per):
        Lt = torch.view_as_real(L[m0:m0 + per].transpose(1, 2))
        T = torch.zeros((Lt.shape[0], Kq, P, 2), dtype=torch.float32,
                        device=L.device)
        if mixed:
            # (Kq, npup) @ (cols, npup, npup real-imag pairs), in float64
            T[:, :, :npup] = torch.einsum("jq,mqpc->mjpc", M,
                                          Lt.double()).float()
        else:
            T[:, :npup, :npup] = Lt
        yield m0, T


def pack_tables_split(L, mixed=True):
    """K3's factor table from ``L`` (N, npup, npup) complex.

    Float32 whatever the working type: ``T`` (N, Kq, P, 2) with
    ``P = padded_pupil(npup)`` and ``Kq`` noise lanes a column:
    :func:`lane_width` for 'mixed' noise, ``P`` for 'gauss'.
    ``T[m, q, p] = (Re, Im) B_m[q, p]`` with ``B = M L^T`` ('mixed', ``M``
    the ``LW x LW`` mixing matrix folded in float64) or ``B = L^T``, zero
    padded: the transposed, cropped
    ``fast_tpu.ops.pallas_synth.colfac_pack_tables(L, W, 'highest',
    noise)``, each part stored once. Runs on ``L``'s device, 64 columns
    at a time (1.7 GB of table at N=1024 with a 402 px pupil).
    """
    N, npup, _ = L.shape
    P = padded_pupil(npup)
    Kq = lane_width(npup) if mixed else P
    T = torch.empty((N, Kq, P, 2), dtype=torch.float32, device=L.device)
    for m0, part in _split_columns(L, mixed):
        T[m0:m0 + part.shape[0]] = part
    return T


def _split_geom(P):
    """How K3's pass 1 covers a padded pupil ``P`` (``split_geom`` of
    ``csrc/colfac_split.cu``): ``(PB, nz, cs)``, nz slices of PB <= 208 px
    (a multiple of 16), run as clusters of cs blocks: all nz where nz <=
    8, else one."""
    nz = -(-P // _PB_MAX)
    return -(-(P // 16) // nz) * 16, nz, nz if nz <= _MAX_CLUSTER else 1


def _split_smem(P):
    """Bytes of K3's pass-1 shared memory at a padded pupil ``P``
    (``pass1_smem`` of ``csrc/colfac_split.cu``): a ring of 4 steps of
    B_r and B_i, hi and lo, over PB px; two x tiles of noise; 12
    mbarriers."""
    PB = _split_geom(P)[0]
    return 4 * (_STAGES_K3 * 32 * PB + 2 * _X_TILE) + 8 * (2 * _STAGES_K3 + 4)


def _lay_split(T):
    """:func:`lay_tables_split`'s data of the columns of ``T``."""
    n, Kq, P, _ = T.shape
    PB, nz, _ = _split_geom(P)
    k64 = -(-Kq // 64) * 64
    t = torch.nn.functional.pad(T, (0, 0, 0, nz * PB - P, 0, k64 - Kq))
    t = t.reshape(n, k64, nz, PB, 2).permute(0, 4, 2, 1, 3)
    hi, lo = _hi_lo(t)
    return torch.stack([_core_steps(x[:, i]) for i in (0, 1)
                        for x in (hi, lo)], dim=3)


def lay_tables_split(T):
    """K3's table ``T`` (:func:`pack_tables_split`) as its pass 1 reads
    it: a :class:`LaidTable` of (N, nz, Kq64 / 8, 4, 8 PB) float32: per
    column, pupil slice of PB px (:func:`_split_geom`) and 8-deep step of
    the Kq lanes (padded with zeros to Kq64, a multiple of 64), B_r's
    TF32 hi and lo parts, then B_i's, over the slice in ``wgmma``'s
    core-matrix order (``csrc/colfac_split.cu``). On ``T``'s device, 64
    columns at a time."""
    parts = [_lay_split(T[m0:m0 + 64]) for m0 in range(0, T.shape[0], 64)]
    return LaidTable(torch.cat(parts).contiguous(), T.shape, split=True)


def laid_table(L, mixed=True):
    """The :class:`LaidTable` of the factors ``L`` (N, npup, npup) on
    ``L``'s device: K1's or K3's by :func:`colfac_layout`, K3's laid from
    :func:`pack_tables_split`'s columns 64 at a time, so that the unsplit
    table never exists whole."""
    if colfac_layout(L.shape[1]) != "split":
        return lay_tables(pack_tables(L, mixed=mixed))
    N, npup, _ = L.shape
    P = padded_pupil(npup)
    Kq = lane_width(npup) if mixed else P
    PB, nz, _ = _split_geom(P)
    data = torch.empty((N, nz, -(-Kq // 64) * 8, 4, 8 * PB),
                       dtype=torch.float32, device=L.device)
    for m0, part in _split_columns(L, mixed):
        data[m0:m0 + part.shape[0]] = _lay_split(part)
    return LaidTable(data, (N, Kq, P, 2), split=True)


def kernel_table(L, mixed=True):
    """The colfac kernel's table of the factors ``L`` on ``L``'s device, as
    the engine keeps it: on the card the :class:`LaidTable` its pass 1
    reads (:func:`laid_table`, built once per configuration), on the CPU
    the table the plain version takes (:func:`pack_tables`,
    :func:`pack_tables_split`)."""
    if L.device.type == "cuda":
        return laid_table(L, mixed)
    split = colfac_layout(L.shape[1]) == "split"
    return (pack_tables_split if split else pack_tables)(L, mixed=mixed)


def _split_gprime(seed, T, nbatch, mixed, stream, draw0, bits, LW):
    """K3's pass 1 in stock torch ops, in pieces of bounded size: yields
    ``(d0, gr, gi)``, the ``G'`` (nb, N, P) of draws ``d0 ..``."""
    N, Kq, P, _ = T.shape
    tr, ti = T[..., 0].contiguous(), T[..., 1].contiguous()
    per = max(1, _REF_POINTS // (N * Kq))
    for d0 in range(0, int(nbatch), per):
        nb = min(per, int(nbatch) - d0)
        if bits is None:
            b = colfac_bits(seed, nb, N, Kq, stream, device=T.device,
                            draw0=draw0 + d0, lane_stride=LW, word=3)
        else:
            b = (bits[0][d0:d0 + nb], bits[1][d0:d0 + nb])
        zr, zi = ((uniforms(b[0]), uniforms(b[1])) if mixed
                  else box_muller(*b))
        # (m, nb, Kq) @ (m, Kq, P): every column's noise times its factor
        zr, zi = zr.transpose(0, 1), zi.transpose(0, 1)
        yield (d0, (zr @ tr - zi @ ti).transpose(0, 1),
               (zr @ ti + zi @ tr).transpose(0, 1))


def colfac_split_reference(seed, T, wr, wi, pm_t, nbatch, mixed=True,
                           stream=0, draw0=0, bits=None, sh_t=None, LW=None):
    """K3 in stock torch ops (see the module docstring).

    Args: as :func:`colfac_detect_reference`, with ``T`` (N, Kq, P, 2) of
    :func:`pack_tables_split`, ``bits`` of shape (nbatch, N, Kq) and ``LW``
    the lane stride of the Philox counter (default: ``Kq`` rounded up to
    128, which is :func:`lane_width` of the pupil for both noises).

    Returns:
        (2 * nbatch, 2) float32 tensor, the layout of K2's.
    """
    LW = lane_width(T.shape[1]) if LW is None else int(LW)
    return _pack(torch.cat([
        detect_reference(gr, gi, wr, wi, pm_t,
                         None if sh_t is None
                         else sh_t[d0:d0 + gr.shape[0]])
        for d0, gr, gi in _split_gprime(seed, T, nbatch, mixed, stream,
                                        draw0, bits, LW)]))


def _library_split():
    lib, info = _build.load_library("colfac_split")
    if not getattr(lib, "_fast_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fast_colfac_split.argtypes = [u, u, u, i, i, p, p, p, p, p, p, p,
                                          p, i, i, i, i, i, p]
        lib.fast_colfac_split.restype = i
        lib.fast_split_pass1.argtypes = [u, u, u, i, i, p, p, p, i, i, i, i,
                                         i, p]
        lib.fast_split_pass1.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def _check_split_table(T, LW):
    if len(T.shape) != 4 or T.shape[-1] != 2:
        raise ValueError(f"T must be (N, Kq, P, 2), got {tuple(T.shape)}")
    N, Kq, P, _ = T.shape
    LW = lane_width(Kq) if LW is None else int(LW)
    if Kq % 16 or not 0 < Kq <= LW:
        raise ValueError(f"T must have a multiple of 16 lanes, at most the "
                         f"lane stride {LW}; got {Kq}")
    if P % 16 or N > 65535 or N * LW >= 2 ** 32:
        raise ValueError(
            f"the split colfac-detect kernel takes a pupil padded to a "
            f"multiple of 16 px and at most 65535 columns; got N={N}, P={P}")
    return N, Kq, P, LW


def _check_split(T, wr, wi, pm_t, nbatch, LW):
    N, Kq, P, LW = _check_split_table(T, LW)
    check_tables({"T": (_data(T, True), None), "wr": (wr, (P, N)),
                  "wi": (wi, (P, N)), "pm_t": (pm_t, (P, P))}, nbatch)
    return N, Kq, P, LW


def colfac_detect_split(seed, T, wr, wi, pm_t, nbatch, mixed=True, stream=0,
                        sh_t=None, LW=None, laid=None):
    """K3 on ``nbatch`` complex draws; arguments as
    :func:`colfac_split_reference`.

    On CUDA tensors this launches the kernel (launches as
    :func:`colfac_detect`'s) on the current stream and counts each launch
    in ``colfac_detect_split.LAUNCHES``, or raises; on CPU tensors it runs
    the plain version. On the card ``T`` may be the :class:`LaidTable` of
    :func:`lay_tables_split` or :func:`laid_table`; a plain ``T`` is laid
    out anew for the call. ``laid`` as :func:`colfac_detect`'s.
    """
    N, Kq, P, LW = _check_split(T, wr, wi, pm_t, nbatch, LW)
    if laid is not None:
        _check_laid(laid, wr)
    dev = T.device
    check_subharm(sh_t, nbatch, P, dev)
    if dev.type == "cpu":
        _plain(T, "colfac_detect_split")
        return colfac_split_reference(seed, T, wr, wi, pm_t, nbatch,
                                      mixed=mixed, stream=stream, sh_t=sh_t,
                                      LW=LW)
    if dev.type != "cuda":
        raise ValueError(f"colfac_detect_split runs on CPU or CUDA, not {dev}")
    _check_stream(stream)
    T = _laid(T, lay_tables_split).data
    wpack, _ = _w_tables(wr, wi, None, laid)
    k0, k1 = _key(seed)
    lib, _ = _library_split()
    nbatch = int(nbatch)
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, P, nbatch)
    g = torch.empty((2, per, N, P), dtype=torch.float32, device=dev)
    part = torch.empty((per, detect_parts(P), 4), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_colfac_split(
                k0, k1, int(stream), d0, nb, T.data_ptr(), wpack.data_ptr(),
                pm_t.data_ptr(),
                None if sh_t is None else sh_t[d0].data_ptr(),
                g[0].data_ptr(), g[1].data_ptr(), part.data_ptr(),
                out[d0:d0 + nb].data_ptr(), N, P, Kq, LW, int(bool(mixed)),
                cs)
            raise_on(lib, err, "colfac_detect_split launch")
            colfac_detect_split.LAUNCHES += 1
    return _pack(out)


colfac_detect_split.LAUNCHES = 0


def split_pass1_reference(seed, T, nbatch, mixed=True, stream=0, draw0=0,
                          LW=None):
    """Pass 1 of K3 in stock torch ops: ``(gr, gi)``, (nbatch, N, P)
    float32; arguments as :func:`colfac_split_reference`."""
    LW = lane_width(T.shape[1]) if LW is None else int(LW)
    parts = list(_split_gprime(seed, T, nbatch, mixed, stream, draw0, None,
                               LW))
    return (torch.cat([gr for _, gr, _ in parts]),
            torch.cat([gi for _, _, gi in parts]))


def split_pass1(seed, T, nbatch, mixed=True, stream=0, draw0=0, LW=None):
    """Pass 1 of K3 alone: ``(gr, gi)``, (nbatch, N, P) float32, the
    ``G'`` that :func:`colfac_detect_split` detects. For timing the pass and
    holding it against :func:`split_pass1_reference` element by element.

    On CUDA tensors this launches pass 1 of ``csrc/colfac_split.cu``
    (launches of :func:`~fast_tpu_torch.ops.synth_detect.draws_per_launch`
    draws, counted in ``split_pass1.LAUNCHES``) on the current stream, or
    raises; on CPU tensors it runs the plain version. ``T`` as
    :func:`colfac_detect_split` takes it.
    """
    N, Kq, P, LW = _check_split_table(T, LW)
    check_tables({"T": (_data(T, True), None)}, nbatch)
    dev = T.device
    if dev.type == "cpu":
        _plain(T, "split_pass1")
        return split_pass1_reference(seed, T, nbatch, mixed=mixed,
                                     stream=stream, draw0=draw0, LW=LW)
    if dev.type != "cuda":
        raise ValueError(f"split_pass1 runs on CPU or CUDA, not {dev}")
    _check_stream(stream)
    T = _laid(T, lay_tables_split).data
    k0, k1 = _key(seed)
    lib, _ = _library_split()
    nbatch = int(nbatch)
    g = torch.empty((2, nbatch, N, P), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, P, nbatch)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_split_pass1(
                k0, k1, int(stream), int(draw0) + d0, nb, T.data_ptr(),
                g[0, d0].data_ptr(), g[1, d0].data_ptr(), N, P, Kq, LW,
                int(bool(mixed)), cs)
            raise_on(lib, err, "split_pass1 launch")
            split_pass1.LAUNCHES += 1
    return g[0], g[1]


split_pass1.LAUNCHES = 0
