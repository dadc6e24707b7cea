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
  the tensor cores (3xTF32 ``mma.sync``).

Mixing width: 'mixed' noise mixes 128 uniforms per component per column
in K1, as the TPU kernel does over its 128-lane tile, and ``LW`` in K3,
the TPU kernel's lane width there; 'gauss' draws only the lanes that meet
nonzero rows of ``L``.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .synth_detect import (_P_MAX, _REF_POINTS, _key, _pack, box_muller,
                           check_subharm, check_tables, detect_reference,
                           draws_per_launch, mixing_matrix, padded_pupil,
                           philox4x32_10, pupil_tiles, raise_on, uniforms)

LANES = 128  # Philox lanes per column; 'mixed' noise mixes all of them


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
        lib.fast_detect_pass.argtypes = [i, p, p, p, p, p, p, p, p, i, i, p]
        lib.fast_detect_pass.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def _check_table(S, mixed):
    if S.ndim != 4 or S.shape[-1] != 2:
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
    check_tables({"S": (S, None), "wr": (wr, (P, N)), "wi": (wi, (P, N)),
                  "pm_t": (pm_t, (P, P))}, nbatch)
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
                  sh_t=None):
    """K1 on ``nbatch`` complex draws; arguments as
    :func:`colfac_detect_reference`.

    On CUDA tensors this launches the kernel (two passes per launch of
    :func:`~fast_tpu_torch.ops.synth_detect.draws_per_launch` draws, each
    launch from the draw index it starts at) on the current stream and
    counts each launch in ``colfac_detect.LAUNCHES``, or raises for a
    shape it does not take (:func:`supports`); on CPU tensors it runs the
    plain version.
    """
    N, K, P = _check(S, wr, wi, pm_t, nbatch, mixed)
    dev = S.device
    check_subharm(sh_t, nbatch, P, dev)
    if dev.type == "cpu":
        return colfac_detect_reference(seed, S, wr, wi, pm_t, nbatch,
                                       mixed=mixed, stream=stream, sh_t=sh_t)
    if dev.type != "cuda":
        raise ValueError(f"colfac_detect runs on CPU or CUDA, not {dev}")
    _check_launch(N, P, stream)
    k0, k1 = _key(seed)
    lib, _ = _library()
    nbatch = int(nbatch)
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, P, nbatch)
    g = torch.empty((2, per, N, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_colfac_detect(
                k0, k1, int(stream), d0, nb, S.data_ptr(), wr.data_ptr(),
                wi.data_ptr(), pm_t.data_ptr(),
                None if sh_t is None else sh_t[d0].data_ptr(),
                g[0].data_ptr(), g[1].data_ptr(), out[d0:d0 + nb].data_ptr(),
                N, P, K, int(bool(mixed)), cs)
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
    raises; on CPU tensors it runs the plain version.
    """
    N, K, P = _check_table(S, mixed)
    check_tables({"S": (S, None)}, nbatch)
    dev = S.device
    if dev.type == "cpu":
        return colfac_pass1_reference(seed, S, nbatch, mixed=mixed,
                                      stream=stream, draw0=draw0)
    if dev.type != "cuda":
        raise ValueError(f"colfac_pass1 runs on CPU or CUDA, not {dev}")
    _check_launch(N, P, stream)
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


def detect_pass(gr, gi, wr, wi, pm_t, sh_t=None):
    """The detect pass of K1, K2 and K3 alone: the sums (nbatch, 4) of
    :func:`~fast_tpu_torch.ops.synth_detect.detect_reference` from each
    draw's ``G'`` (``gr``, ``gi``: (nbatch, N, P), P a multiple of 16, as
    the pass-1 wrappers return it). For timing the pass and holding it
    against that plain version.

    On CUDA tensors this launches ``detect_pass`` of ``csrc/detect.cuh``
    (one launch of the given draws, counted in ``detect_pass.LAUNCHES``) on
    the current stream, or raises; on CPU tensors it runs the plain
    version.
    """
    if gr.ndim != 3:
        raise ValueError(f"gr must be (nbatch, N, P), got {tuple(gr.shape)}")
    nbatch, N, P = gr.shape
    check_tables({"gr": (gr, None), "gi": (gi, (nbatch, N, P)),
                  "wr": (wr, (P, N)), "wi": (wi, (P, N)),
                  "pm_t": (pm_t, (P, P))}, nbatch)
    dev = gr.device
    check_subharm(sh_t, nbatch, P, dev)
    if dev.type == "cpu":
        return detect_reference(gr, gi, wr, wi, pm_t, sh_t)
    if dev.type != "cuda":
        raise ValueError(f"detect_pass runs on CPU or CUDA, not {dev}")
    if P % 16 or pupil_tiles(P) > 255:
        raise ValueError(f"the detect pass takes a pupil padded to a "
                         f"multiple of 16 px; got P={P}")
    lib, _ = _library()
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    part = torch.empty((nbatch, pupil_tiles(P) ** 2, 4), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        err = lib.fast_detect_pass(
            nbatch, wr.data_ptr(), wi.data_ptr(), gr.data_ptr(),
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
    L = L.to(torch.complex64)
    N, npup, _ = L.shape
    P = padded_pupil(npup)
    Kq = lane_width(npup) if mixed else P
    T = torch.zeros((N, Kq, P, 2), dtype=torch.float32, device=L.device)
    if not mixed:
        T[:, :npup, :npup] = torch.view_as_real(L.transpose(1, 2))
        return T
    M = torch.from_numpy(mixing_matrix(Kq).astype(np.float64)).to(L.device)
    for m0 in range(0, N, 64):
        # (Kq, npup) @ (cols, npup, npup real-imag pairs), in float64
        Lt = torch.view_as_real(L[m0:m0 + 64].transpose(1, 2)).double()
        T[m0:m0 + 64, :, :npup] = torch.einsum(
            "jq,mqpc->mjpc", M[:, :npup], Lt).float()
    return T


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
                                          p, p, i, i, i, i, i, p]
        lib.fast_colfac_split.restype = i
        lib.fast_split_pass1.argtypes = [u, u, u, i, i, p, p, p, i, i, i, i,
                                         i, p]
        lib.fast_split_pass1.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def _check_split_table(T, LW):
    if T.ndim != 4 or T.shape[-1] != 2:
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
    check_tables({"T": (T, None), "wr": (wr, (P, N)), "wi": (wi, (P, N)),
                  "pm_t": (pm_t, (P, P))}, nbatch)
    return N, Kq, P, LW


def colfac_detect_split(seed, T, wr, wi, pm_t, nbatch, mixed=True, stream=0,
                        sh_t=None, LW=None):
    """K3 on ``nbatch`` complex draws; arguments as
    :func:`colfac_split_reference`.

    On CUDA tensors this launches the kernel (launches as
    :func:`colfac_detect`'s) on the current stream and counts each launch
    in ``colfac_detect_split.LAUNCHES``, or raises; on CPU tensors it runs
    the plain version.
    """
    N, Kq, P, LW = _check_split(T, wr, wi, pm_t, nbatch, LW)
    dev = T.device
    check_subharm(sh_t, nbatch, P, dev)
    if dev.type == "cpu":
        return colfac_split_reference(seed, T, wr, wi, pm_t, nbatch,
                                      mixed=mixed, stream=stream, sh_t=sh_t,
                                      LW=LW)
    if dev.type != "cuda":
        raise ValueError(f"colfac_detect_split runs on CPU or CUDA, not {dev}")
    _check_stream(stream)
    k0, k1 = _key(seed)
    lib, _ = _library_split()
    nbatch = int(nbatch)
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    per = draws_per_launch(N, P, nbatch)
    g = torch.empty((2, per, N, P), dtype=torch.float32, device=dev)
    part = torch.empty((per, pupil_tiles(P) ** 2, 4), dtype=torch.float32,
                       device=dev)
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for d0 in range(0, nbatch, per):
            nb = min(per, nbatch - d0)
            err = lib.fast_colfac_split(
                k0, k1, int(stream), d0, nb, T.data_ptr(), wr.data_ptr(),
                wi.data_ptr(), pm_t.data_ptr(),
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
    raises; on CPU tensors it runs the plain version.
    """
    N, Kq, P, LW = _check_split_table(T, LW)
    check_tables({"T": (T, None)}, nbatch)
    dev = T.device
    if dev.type == "cpu":
        return split_pass1_reference(seed, T, nbatch, mixed=mixed,
                                     stream=stream, draw0=draw0, LW=LW)
    if dev.type != "cuda":
        raise ValueError(f"split_pass1 runs on CPU or CUDA, not {dev}")
    _check_stream(stream)
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
