"""K4 and K5: the AR(1)-in-Fourier frozen-flow coupling series.

The port of ``fast_tpu.ops.pallas_synth.ar_flow_fused`` (K4,
``_ar_flow_kernel``) and ``ar_flow_streamed`` (K5, ``_ar_stream_kernel``).
Per time step every layer's Fourier state is multiplied by its phasor
``alpha e^{i kappa . v dt}``, optionally gets boiling noise times
``sqrt(1 - alpha^2) sqrt(PSD) df``, the layers are summed, the pruned
inverse DFT takes the sum to the pupil crop, and the real part of that
screen is reduced to ``(sum pm cos phi, sum pm sin phi)``.

* :func:`ar_flow_fused` and :func:`ar_flow_streamed` are the wrappers, with
  the arguments and returns of the JAX functions of the same names. On CUDA
  tensors they launch the hand-written kernel of ``csrc/ar_flow.cu`` (built
  at first use) or raise; on CPU tensors they run
  :func:`ar_flow_reference`. The fused one
  keeps every layer of a mode in one thread's registers (at most
  :data:`FUSED_MAX_LAYERS` layers); the streamed one walks the layers in
  blocks that add into the layer sum in turn, for any number of layers.
  :func:`select` is the rule that picks between them.
* :func:`ar_flow_reference` is the same function in stock torch ops, step
  by step, from the same Philox4x32-10 bits: counter ``(mode, layer,
  absolute step, 2)``, key the 64-bit seed. Its update uses the kernel's
  operations in the kernel's order (no fused multiply-add), so state and
  layer sum agree with the kernel bit for bit and only the two matrix
  products differ. ``bits`` replaces the Philox bits (``"zero"``: all
  zero, what the Pallas interpreter's PRNG yields).

Noise, as the TPU kernels: 'uniform' is ``i sqrt(3) 2^-23 - sqrt(3)`` on
the top 24 bits of a word (unit variance), 'gauss' is Box-Muller with
``u1 = i1 2^-24 + 2^-25``, ``u2 = i2 2^-24``. The counter holds the
absolute step of the series (``step0`` + the step within the call), so a
series cut into several calls is the same series.
"""

import ctypes

import torch

from . import _build
from .synth_detect import (_P_MAX, _REF_POINTS, _key, box_muller, pad_pupil,
                           philox4x32_10, raise_on, sincos, uniforms)

#: Most layers the fused kernel holds in one thread's registers.
FUSED_MAX_LAYERS = 8
#: Layers per block of the streamed kernel, unless the caller says.
STREAM_LAYERS = 4
#: Most steps of one kernel launch; a longer series takes several.
MAX_STEPS = 4096
_NOISE_CODE = {"uniform": 1, "gauss": 2}
_N_MAX = 32768  # grid sides whose mode index fits the kernel's int


def supports(N, P):
    """Whether the kernel takes an (N, N) grid with a P-pixel pupil: a
    pupil of at most 128 px."""
    return 0 < P <= _P_MAX and 0 < N <= _N_MAX


def select(nlayers):
    """The wrapper for a profile of ``nlayers`` layers: the fused kernel
    while the layers fit one thread's registers, else the streamed one."""
    return ar_flow_fused if nlayers <= FUSED_MAX_LAYERS else ar_flow_streamed


def tile_steps(N):
    """Steps per tile of the layer sum A and of G' in device memory: 256
    for grids up to 256^2, fewer for larger ones (at most 2^24 grid points
    of A, 134 MB), never under 16."""
    return max(16, min(256, (1 << 24) // (N * N)))


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


def ar_bits(seed, step0, nsteps, L, N, device="cpu"):
    """The kernel's two random words per (step, layer, mode): ``(b1, b2)``,
    int64 tensors of 32-bit values, shape (nsteps, L, N, N), for the
    absolute steps ``step0 .. step0 + nsteps - 1``; counter ``(row * N +
    col, layer, step, 2)``, key the 64-bit ``seed``."""
    k0, k1 = _key(seed)
    e = torch.arange(N * N, dtype=torch.int64, device=device)[None, None, :]
    lay = torch.arange(L, dtype=torch.int64, device=device)[None, :, None]
    s = torch.arange(step0, step0 + nsteps, dtype=torch.int64,
                     device=device)[:, None, None]
    two = torch.full((), 2, dtype=torch.int64, device=device)
    x0, x1, _, _ = philox4x32_10(e, lay, s, two, k0, k1)
    return x0.reshape(nsteps, L, N, N), x1.reshape(nsteps, L, N, N)


def ar_noise(seed, step0, nsteps, L, N, noise="uniform", device="cpu",
             bits=None):
    """The boiling noise ``(z1, z2)`` of ``nsteps`` steps: float32 (nsteps,
    L, N, N), real and imaginary parts. ``bits``: None for the Philox bits
    of :func:`ar_bits`, ``"zero"`` for zero bits, or ``(b1, b2)`` integer
    tensors of that shape."""
    if noise not in _NOISE_CODE:
        raise ValueError("noise must be 'uniform'|'gauss'")
    if bits is None:
        b1, b2 = ar_bits(seed, step0, nsteps, L, N, device)
    elif isinstance(bits, str) and bits == "zero":
        b1 = b2 = torch.zeros((nsteps, L, N, N), dtype=torch.int64,
                              device=device)
    else:
        b1, b2 = bits
    if noise == "uniform":
        return uniforms(b1), uniforms(b2)
    return box_muller(b1, b2)


class NoiseStream:
    """The kernel's boiling noise, step by step, for the stock-op routes:
    ``stream(step)`` is the complex (L, N, N) noise of the absolute step
    ``step`` in ``dtype``. Steps are drawn in blocks, up to the step
    ``end``, and must be asked for in rising order."""

    def __init__(self, seed, L, N, end, noise="uniform", device="cpu",
                 dtype=torch.complex64):
        self.seed, self.L, self.N, self.noise = seed, L, N, noise
        self.end, self.device, self.dtype = int(end), device, dtype
        self._per = max(1, _REF_POINTS // (L * N * N))
        self._first, self._z = 0, None

    def __call__(self, step):
        if self._z is None or not (self._first <= step
                                   < self._first + self._z[0].shape[0]):
            self._first = step
            self._z = ar_noise(self.seed, step,
                               max(1, min(self._per, self.end - step)),
                               self.L, self.N, self.noise, self.device)
        i = step - self._first
        return torch.complex(self._z[0][i], self._z[1][i]).to(self.dtype)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _pack(a0, ph, ns, W, pm):
    """The wrappers' arguments as the kernel takes them: the state and the
    phasor as (2, L, N, N) float32 (a fresh copy of the state: the kernel
    updates it in place), ``ns`` (L, N, N) float32 or None, and ``wr``,
    ``wi`` (P, N), ``pm_t`` (P, P) transposed, zero padded to a multiple of
    16 pupil pixels."""
    if a0.ndim != 3 or a0.shape[1] != a0.shape[2] or not a0.is_complex():
        raise ValueError(f"a0 must be complex (L, N, N), got "
                         f"{a0.dtype} {tuple(a0.shape)}")
    L, N, _ = a0.shape
    dev = a0.device
    if tuple(ph.shape) != (L, N, N) or not ph.is_complex():
        raise ValueError(f"step_phasor_scaled must be complex {(L, N, N)}")
    if ns is not None and tuple(ns.shape) != (L, N, N):
        raise ValueError(f"noise_scale must be {(L, N, N)}")
    npup = W.shape[0]
    if tuple(W.shape) != (npup, N) or tuple(pm.shape) != (npup, npup):
        raise ValueError(f"W must be (npup, {N}) and pupil_mode (npup, npup)")
    for name, t in (("step_phasor_scaled", ph), ("noise_scale", ns),
                    ("W", W), ("pupil_mode", pm)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a0 on {dev}")
    f32 = torch.float32
    st = torch.stack([a0.real, a0.imag]).to(f32).contiguous()
    ph2 = torch.stack([ph.real, ph.imag]).to(f32).contiguous()
    ns32 = None if ns is None else ns.to(f32).contiguous()
    wr, wi, pm_t = pad_pupil(W.real.to(f32).contiguous(),
                             W.imag.to(f32).contiguous(),
                             pm.to(f32).T.contiguous())
    return st, ph2, ns32, wr, wi, pm_t


def detect_real_reference(ar, ai, wr, wi, pm_t):
    """The kernel's two products and its detect pass in stock torch ops:
    from the layer sums ``ar + i ai`` (T, N, N), ``G' = A^T W^T`` (T, N,
    P), the transposed screen ``Re(W G')`` (T, P, P) and ``(sum pm_t cos,
    sum pm_t sin)``: (T, 2) float32."""
    art, ait = ar.transpose(-2, -1), ai.transpose(-2, -1)
    gr = art @ wr.T - ait @ wi.T
    gi = art @ wi.T + ait @ wr.T
    s, c = sincos(wr @ gr - wi @ gi)
    return torch.stack([(pm_t * c).sum((-2, -1)), (pm_t * s).sum((-2, -1))],
                       dim=-1)


def _reference(seed, st, ph2, ns, wr, wi, pm_t, nsteps, noise, step0, bits):
    """The plain version on packed arguments; ``st`` is advanced in place.
    Returns the (nsteps, 2) sums."""
    _, L, N, _ = st.shape
    sr, si = st[0], st[1]
    pr, pi = ph2[0], ph2[1]
    per = max(1, _REF_POINTS // (L * N * N))
    parts = []
    for t0 in range(0, nsteps, per):
        nt = min(per, nsteps - t0)
        if ns is not None:
            blk = bits
            if not (bits is None or isinstance(bits, str)):
                blk = (bits[0][t0:t0 + nt], bits[1][t0:t0 + nt])
            z1, z2 = ar_noise(seed, step0 + t0, nt, L, N, noise, st.device,
                              blk)
        A = torch.empty((2, nt, N, N), dtype=torch.float32, device=st.device)
        for t in range(nt):
            # every product and sum rounded on its own, in the kernel's order
            nr = sr * pr - si * pi
            ni = sr * pi + si * pr
            if ns is not None:
                nr = nr + z1[t] * ns
                ni = ni + z2[t] * ns
            sr, si = nr, ni
            sum_r, sum_i = sr[0], si[0]
            for lay in range(1, L):
                sum_r = sum_r + sr[lay]
                sum_i = sum_i + si[lay]
            A[0, t], A[1, t] = sum_r, sum_i
        parts.append(detect_real_reference(A[0], A[1], wr, wi, pm_t))
    st[0], st[1] = sr, si
    return torch.cat(parts)


def ar_flow_reference(seed, a0, step_phasor_scaled, noise_scale, W,
                      pupil_mode, nsteps, noise="uniform", step0=0,
                      bits=None):
    """K4 and K5 in stock torch ops (see the module docstring).

    Args:
        seed: 64-bit integer key of the Philox generator.
        a0: (L, N, N) complex initial Fourier state.
        step_phasor_scaled: (L, N, N) complex ``alpha e^{i kappa . v dt}``.
        noise_scale: (L, N, N) real ``sqrt(1 - alpha^2) sqrt(PSD) df``, or
            None for pure frozen flow.
        W: (npup, N) complex pruned inverse-DFT matrix.
        pupil_mode: (npup, npup) pupil * mode weights.
        nsteps: series length.
        noise: 'uniform' or 'gauss'.
        step0: absolute step of the first step (the Philox counter).
        bits: None, ``"zero"``, or ``(b1, b2)`` integer tensors (nsteps, L,
            N, N) of 32-bit values in place of the Philox bits.

    Returns:
        ``(couplings, a_final)``: (nsteps, 2) float32 unnormalised
        couplings and the (L, N, N) complex64 state after the last step.
    """
    st, ph2, ns, wr, wi, pm_t = _pack(a0, step_phasor_scaled, noise_scale, W,
                                      pupil_mode)
    out = _reference(seed, st, ph2, ns, wr, wi, pm_t, int(nsteps), noise,
                     int(step0), bits)
    return out, torch.complex(st[0], st[1])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _library():
    lib, info = _build.load_library("ar_flow")
    if not getattr(lib, "_fast_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fast_ar_flow.argtypes = [u, u, u, i, i, i, i, i] + [p] * 13 \
            + [i, i, p]
        lib.fast_ar_flow.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def _ar_flow(wrapper, lb, seed, a0, ph, ns, W, pm, nsteps, noise, step0,
             max_steps):
    nsteps, step0 = int(nsteps), int(step0)
    if nsteps <= 0:
        raise ValueError("nsteps must be positive")
    if noise not in _NOISE_CODE:
        raise ValueError("noise must be 'uniform'|'gauss'")
    if not 0 <= step0 <= step0 + nsteps <= 2 ** 32:
        raise ValueError("step0 + nsteps must fit in 32 bits")
    k0, k1 = _key(seed)
    st, ph2, ns, wr, wi, pm_t = _pack(a0, ph, ns, W, pm)
    dev = st.device
    if dev.type == "cpu":
        out = _reference(seed, st, ph2, ns, wr, wi, pm_t, nsteps, noise,
                         step0, None)
        return out, torch.complex(st[0], st[1])
    if dev.type != "cuda":
        raise ValueError(f"the AR flow kernels run on CPU or CUDA, not {dev}")
    _, L, N, _ = st.shape
    if not supports(N, pm.shape[0]):
        raise ValueError(
            f"the AR flow kernels take a pupil of at most {_P_MAX} px; got "
            f"N={N}, a {pm.shape[0]} px pupil")
    lib, _ = _library()
    P = wr.shape[0]
    per = min(nsteps, int(max_steps))
    tile = min(per, tile_steps(N))
    a = torch.empty((2, tile, N, N), dtype=torch.float32, device=dev)
    g = torch.empty((2, tile, N, P), dtype=torch.float32, device=dev)
    out = torch.empty((nsteps, 2), dtype=torch.float32, device=dev)
    code = 0 if ns is None else _NOISE_CODE[noise]
    with torch.cuda.device(dev):
        cs = torch.cuda.current_stream(dev).cuda_stream
        for t0 in range(0, nsteps, per):
            err = lib.fast_ar_flow(
                k0, k1, step0 + t0, min(per, nsteps - t0), tile, L, lb, code,
                st[0].data_ptr(), st[1].data_ptr(), ph2[0].data_ptr(),
                ph2[1].data_ptr(), None if ns is None else ns.data_ptr(),
                wr.data_ptr(), wi.data_ptr(), pm_t.data_ptr(),
                a[0].data_ptr(), a[1].data_ptr(), g[0].data_ptr(),
                g[1].data_ptr(), out[t0:].data_ptr(), N, P, cs)
            raise_on(lib, err, f"{wrapper.__name__} launch")
            wrapper.LAUNCHES += 1
    return out, torch.complex(st[0], st[1])


def ar_flow_fused(seed, a0, step_phasor_scaled, noise_scale, W, pupil_mode,
                  nsteps, noise="uniform", step0=0, max_steps=MAX_STEPS):
    """K4: the whole coupling series with every layer of a mode advanced
    in one thread's registers; arguments and returns as
    :func:`ar_flow_reference`.

    On CUDA tensors this launches the kernel (three passes per time tile,
    one launch per ``max_steps`` steps, the n-th from the absolute step
    ``step0 + max_steps * n``) on the current stream and counts each launch
    in ``ar_flow_fused.LAUNCHES``, or raises for what it does not take
    (:func:`supports`, more than :data:`FUSED_MAX_LAYERS` layers); on CPU
    tensors it runs the plain version.
    """
    L = a0.shape[0]
    if L > FUSED_MAX_LAYERS:
        raise ValueError(
            f"the fused AR kernel holds at most {FUSED_MAX_LAYERS} layers "
            f"per mode, got {L}; ar_flow_streamed takes any number")
    return _ar_flow(ar_flow_fused, L, seed, a0, step_phasor_scaled,
                    noise_scale, W, pupil_mode, nsteps, noise, step0,
                    max_steps)


def ar_flow_streamed(seed, a0, step_phasor_scaled, noise_scale, W,
                     pupil_mode, nsteps, noise="uniform", step0=0,
                     max_steps=MAX_STEPS, lb_layers=STREAM_LAYERS):
    """K5: the same series with the layers advanced in blocks of
    ``lb_layers`` (1 to 8), each block adding its layers into the layer sum
    in turn, for any number of layers; arguments and returns as
    :func:`ar_flow_fused`. Launches count in ``ar_flow_streamed.LAUNCHES``.
    """
    lb = int(lb_layers)
    if not 1 <= lb <= FUSED_MAX_LAYERS:
        raise ValueError(f"lb_layers must be 1..{FUSED_MAX_LAYERS}")
    return _ar_flow(ar_flow_streamed, lb, seed, a0, step_phasor_scaled,
                    noise_scale, W, pupil_mode, nsteps, noise, step0,
                    max_steps)


ar_flow_fused.LAUNCHES = 0
ar_flow_streamed.LAUNCHES = 0
