"""K1: colfac-basis synthesis and pupil-overlap detection.

The port of ``fast_tpu.ops.pallas_synth.fused_colfac_detect`` (merged
layout, ``_colfac_detect_kernel_merged``). For ``nbatch`` complex draws it
draws each column of ``G = W X`` as ``L_m z_m`` from the per-column
Cholesky factors of the pupil-row covariance, applies ``W`` and returns the
pupil-overlap sums of both screens of each draw, in K2's output layout.

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

Mixing width: 'mixed' noise mixes 128 uniforms per component per column,
as the TPU kernel does over its 128-lane tile, whatever the pupil width;
'gauss' draws only the lanes that meet nonzero rows of ``L``.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .synth_detect import (_MAX_DRAWS, _P_MAX, _REF_POINTS, _key, _pack,
                           box_muller, check_subharm, check_tables,
                           detect_reference, mixing_matrix, padded_pupil,
                           philox4x32_10, raise_on, uniforms)

LANES = 128  # Philox lanes per column; 'mixed' noise mixes all of them


def supports(N, P):
    """Whether the kernel takes an (N, N) grid with a P-pixel pupil: a
    pupil of at most 128 px and at most 65535 columns."""
    return 0 < P <= _P_MAX and 0 < N <= 65535


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


def colfac_bits(seed, nbatch, N, lanes, stream=0, device="cpu", draw0=0):
    """The kernel's two random words per noise lane: ``(b1, b2)``, int64
    tensors of 32-bit values, shape (nbatch, N, lanes), for draws
    ``draw0 .. draw0 + nbatch - 1``; counter ``(m * 128 + q, d, stream,
    1)``, key the 64-bit ``seed``."""
    k0, k1 = _key(seed)
    m = torch.arange(N, dtype=torch.int64, device=device)[:, None]
    q = torch.arange(lanes, dtype=torch.int64, device=device)[None, :]
    e = (m * LANES + q).reshape(1, -1)
    d = torch.arange(draw0, draw0 + nbatch, dtype=torch.int64,
                     device=device)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    x0, x1, _, _ = philox4x32_10(e, d, zero + int(stream), zero + 1, k0, k1)
    return x0.reshape(nbatch, N, lanes), x1.reshape(nbatch, N, lanes)


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
    N, K, P, _ = S.shape
    lanes = K // 2
    St = S.reshape(N, K, 2 * P)
    per = max(1, _REF_POINTS // (N * lanes))
    parts = []
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
        parts.append(detect_reference(
            g[..., 0], g[..., 1], wr, wi, pm_t,
            None if sh_t is None else sh_t[d0:d0 + nb]))
    return _pack(torch.cat(parts))


def _library():
    lib, info = _build.load_library("colfac_detect")
    if not getattr(lib, "_fast_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fast_colfac_detect.argtypes = [u, u, u, i, i, p, p, p, p, p, p, p,
                                           p, i, i, i, i, p]
        lib.fast_colfac_detect.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def _check(S, wr, wi, pm_t, nbatch, mixed):
    if S.ndim != 4 or S.shape[-1] != 2:
        raise ValueError(f"S must be (N, K, P, 2), got {tuple(S.shape)}")
    N, K, P, _ = S.shape
    if mixed and K != 2 * LANES:
        raise ValueError(f"'mixed' noise takes S with K = {2 * LANES} rows, "
                         f"got {K}")
    if K % 32 or not 0 < K <= 2 * LANES:
        raise ValueError(f"S must have a multiple of 32 rows, at most "
                         f"{2 * LANES}; got {K}")
    check_tables({"S": (S, None), "wr": (wr, (P, N)), "wi": (wi, (P, N)),
                  "pm_t": (pm_t, (P, P))}, nbatch)
    return N, K, P


def colfac_detect(seed, S, wr, wi, pm_t, nbatch, mixed=True, stream=0,
                  sh_t=None):
    """K1 on ``nbatch`` complex draws; arguments as
    :func:`colfac_detect_reference`.

    On CUDA tensors this launches the kernel (two passes per launch of at
    most 4096 draws, the n-th launch from draw ``4096 * n``) on the
    current stream and counts each launch in ``colfac_detect.LAUNCHES``,
    or raises for a shape it does not take (:func:`supports`); on CPU
    tensors it runs the plain version.
    """
    N, K, P = _check(S, wr, wi, pm_t, nbatch, mixed)
    dev = S.device
    check_subharm(sh_t, nbatch, P, dev)
    if dev.type == "cpu":
        return colfac_detect_reference(seed, S, wr, wi, pm_t, nbatch,
                                       mixed=mixed, stream=stream, sh_t=sh_t)
    if dev.type != "cuda":
        raise ValueError(f"colfac_detect runs on CPU or CUDA, not {dev}")
    if not supports(N, P) or P % 16:
        raise ValueError(
            f"the colfac-detect kernel takes a pupil padded to a multiple of "
            f"16 px up to {_P_MAX} px and at most 65535 columns; got N={N}, "
            f"P={P}")
    if not 0 <= int(stream) < 2 ** 32:
        raise ValueError("stream must fit in 32 bits")
    k0, k1 = _key(seed)
    lib, _ = _library()
    nbatch = int(nbatch)
    out = torch.empty((nbatch, 4), dtype=torch.float32, device=dev)
    per = min(nbatch, _MAX_DRAWS)
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

