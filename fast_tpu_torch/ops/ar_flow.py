"""K4, K5 and K6: the AR(1)-in-Fourier frozen-flow coupling series.

The port of ``fast_tpu.ops.pallas_synth.ar_flow_fused`` (K4,
``_ar_flow_kernel``), ``ar_flow_streamed`` (K5, ``_ar_stream_kernel``) and
``ar_flow_fused_batch`` (K6, ``_ar_flow_kernel_batch``: B independent
series sharing ``W``, one per orbit sample of a temporal scan).
Per time step every layer's Fourier state is multiplied by its phasor
``alpha e^{i kappa . v dt}``, optionally gets boiling noise times
``sqrt(1 - alpha^2) sqrt(PSD) df``, the layers are summed, the pruned
inverse DFT takes the sum to the pupil crop, and the real part of that
screen is reduced to ``(sum pm cos phi, sum pm sin phi)``.

* :func:`ar_flow_fused`, :func:`ar_flow_streamed` and
  :func:`ar_flow_fused_batch` are the wrappers, with the arguments and
  returns of the JAX functions of the same names. On CUDA tensors they
  launch the hand-written kernel of ``csrc/ar_flow.cu`` (built at first
  use) or raise; on CPU tensors they run the plain version. The fused one
  keeps every layer of a mode in one thread's registers (at most
  :data:`FUSED_MAX_LAYERS` layers); the streamed one walks the layers in
  blocks that add into the layer sum in turn, for any number of layers.
  :func:`select` is the rule that picks between them, and the batched one
  follows it for each of its series. Any pupil width. Both DFT products
  run as the iid kernels' second pass (``csrc/detect.cuh``, ``wgmma`` in
  the TF32 passes of ``precision``: three at 'high' and 'highest', one at
  'default', ``synth_detect.PASSES``) on the laid W table
  (``synth_detect.laid_w``, given as ``laid=`` or laid out for the call);
  :func:`ar_dft` and :func:`ar_detect` run each alone. The update is the
  same at every precision.
* :func:`ar_flow_reference` and :func:`ar_flow_batch_reference` are the
  same functions in stock torch ops, step by step, from the same
  Philox4x32-10 bits (:func:`ar_bits`), key the 64-bit seed (series 0 of
  a batch is the single series of K4; ``series0``, 0 unless the caller
  says, lets a rank draw the noise of series ``series0 ..`` of a larger
  batch). Their update uses the kernel's operations in the kernel's order
  (no fused multiply-add), so state and layer sum agree with the kernel
  bit for bit and only the two matrix products differ; those take
  ``precision`` as the kernels' do (``synth_detect.mm``). ``bits`` replaces
  the Philox bits (``"zero"``: all zero, what the Pallas interpreter's
  PRNG yields).

Noise, as the TPU kernels: 'uniform' is ``i sqrt(3) 2^-23 - sqrt(3)`` on
the top 24 bits of a word (unit variance), 'gauss' is Box-Muller with
``u1 = i1 2^-24 + 2^-25``, ``u2 = i2 2^-24``. One Philox call serves two
steps: counter ``(mode, (series0 + series) * L + layer, absolute step //
2, 2)``, its words 0 and 1 the even step's two words, 2 and 3 the odd
step's. The counter holds the absolute step of the series (``step0`` +
the step within the call), so a series cut into several calls, at an
even or an odd step, is the same series.
"""

import ctypes

import torch

from . import _build
from .synth_detect import (_G_BYTES, _REF_POINTS, _check_laid, _key,
                           box_muller, count, counters, detect_parts, laid_w,
                           mm, pad_pupil, padded_pupil, passes,
                           philox4x32_10, pupil_tiles, raise_on, sincos,
                           uniforms)

#: Most layers the fused kernel holds in one thread's registers.
FUSED_MAX_LAYERS = 8
#: Layers per block of the streamed kernel, unless the caller says.
STREAM_LAYERS = 4
#: Most steps of one kernel launch; a longer series takes several.
MAX_STEPS = 4096
_NOISE_CODE = {"uniform": 1, "gauss": 2}
_N_MAX = 32768  # grid sides whose mode index fits the kernel's int
_T_MAX = 255    # pupil tiles of 128 px (csrc/detect.cuh, pass2_takes)
_B_MAX = 65535  # series of one launch (a grid axis of the update pass)
_TILE_PAIRS = 1024  # most (step, series) pairs of a tile


def supports(N, P):
    """Whether the kernels take an (N, N) grid with a P-pixel pupil: any
    grid side up to 32768 and any pupil the tiles of ``csrc/detect.cuh``
    cover (up to 32640 px)."""
    return 0 < N <= _N_MAX and 0 < P and pupil_tiles(padded_pupil(P)) \
        <= _T_MAX


def select(nlayers):
    """The wrapper for a profile of ``nlayers`` layers: the fused kernel
    while the layers fit one thread's registers, else the streamed one."""
    return ar_flow_fused if nlayers <= FUSED_MAX_LAYERS else ar_flow_streamed


def tile_steps(N, P=128, nseries=1):
    """Steps per tile of the layer sum A and of G' in device memory, for
    ``nseries`` series at an (N, N) grid and a padded pupil P: 1024 (step,
    series) pairs for grids up to 256^2, fewer for larger ones (at most
    2^26 grid points of A, 537 MB, and 2 GiB of G'), never under 16
    pairs; then divided among the series, at least one step. A tile's
    pairs are the rows of the products' launches, which have to fill the
    card's 132 SMs (64 pairs at 512^2 give the detect 48 blocks of
    work)."""
    pairs = max(16, min(_TILE_PAIRS, (1 << 26) // (N * N)))
    pairs = min(pairs, max(1, _G_BYTES // (8 * N * P)))
    return max(1, pairs // nseries)


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


def ar_bits(seed, step0, nsteps, L, N, device="cpu", layer0=0):
    """The kernel's two random words per (step, row, mode): ``(b1, b2)``,
    int64 tensors of 32-bit values, shape (nsteps, L, N, N), for the
    absolute steps ``step0 .. step0 + nsteps - 1`` and the state rows
    ``layer0 .. layer0 + L - 1`` (row ``s * nlayers + l`` is layer l of
    series s); counter ``(row * N + col, state row, step // 2, 2)``, key
    the 64-bit ``seed``: words 0 and 1 of the call at an even step, 2 and
    3 at an odd one."""
    k0, k1 = _key(seed)
    e = torch.arange(N * N, dtype=torch.int64, device=device)[None, None, :]
    lay = torch.arange(layer0, layer0 + L, dtype=torch.int64,
                       device=device)[None, :, None]
    s = torch.arange(step0, step0 + nsteps, dtype=torch.int64,
                     device=device)[:, None, None]
    two = torch.full((), 2, dtype=torch.int64, device=device)
    x0, x1, x2, x3 = philox4x32_10(e, lay, s >> 1, two, k0, k1)
    odd = (s & 1).bool()
    return (torch.where(odd, x2, x0).reshape(nsteps, L, N, N),
            torch.where(odd, x3, x1).reshape(nsteps, L, N, N))


def ar_noise(seed, step0, nsteps, L, N, noise="uniform", device="cpu",
             bits=None, layer0=0):
    """The boiling noise ``(z1, z2)`` of ``nsteps`` steps: float32 (nsteps,
    L, N, N), real and imaginary parts, of the state rows ``layer0 ..``.
    ``bits``: None for the Philox bits of :func:`ar_bits`, ``"zero"`` for
    zero bits, or ``(b1, b2)`` integer tensors of that shape."""
    if noise not in _NOISE_CODE:
        raise ValueError("noise must be 'uniform'|'gauss'")
    if bits is None:
        b1, b2 = ar_bits(seed, step0, nsteps, L, N, device, layer0)
    elif isinstance(bits, str) and bits == "zero":
        b1 = b2 = torch.zeros((nsteps, L, N, N), dtype=torch.int64,
                              device=device)
    else:
        b1, b2 = bits
    if noise == "uniform":
        return uniforms(b1), uniforms(b2)
    return box_muller(b1, b2)


class NoiseStream:
    """The kernels' boiling noise of one series, step by step, for the
    stock-op routes: ``stream(step)`` is the complex (L, N, N) noise of the
    absolute step ``step`` in ``dtype``, of series ``series`` of a batch
    (state rows ``series * L ..``; series 0 is the single series of K4),
    from its layer ``layer0`` on (a rank's layers of a layer-sharded
    series draw the rows ``layer0 .. layer0 + L - 1``).
    Steps are drawn in blocks, up to the step ``end``, and must be asked
    for in rising order."""

    def __init__(self, seed, L, N, end, noise="uniform", device="cpu",
                 dtype=torch.complex64, series=0, layer0=0):
        self.seed, self.L, self.N, self.noise = seed, L, N, noise
        self.end, self.device, self.dtype = int(end), device, dtype
        self.layer0 = int(series) * L + int(layer0)
        self._per = max(1, _REF_POINTS // (L * N * N))
        self._first, self._z = 0, None

    def __call__(self, step):
        if self._z is None or not (self._first <= step
                                   < self._first + self._z[0].shape[0]):
            self._first = step
            self._z = ar_noise(self.seed, step,
                               max(1, min(self._per, self.end - step)),
                               self.L, self.N, self.noise, self.device,
                               layer0=self.layer0)
        i = step - self._first
        return torch.complex(self._z[0][i], self._z[1][i]).to(self.dtype)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _pack(a0, ph, ns, W, pm, batch=False):
    """The wrappers' arguments as the kernel takes them, with a leading
    series axis (of one series unless ``batch``): the states and the
    phasors as (2, B, L, N, N) float32 (a fresh copy of the states: the
    kernel updates them in place), ``ns`` (B, L, N, N) float32 or None, and
    ``wr``, ``wi`` (P, N), ``pm_t`` (B, P, P) transposed, zero padded to a
    multiple of 16 pupil pixels."""
    lead = "(B, L, N, N)" if batch else "(L, N, N)"
    if (a0.ndim != (4 if batch else 3) or a0.shape[-1] != a0.shape[-2]
            or not a0.is_complex()):
        raise ValueError(f"a0 must be complex {lead}, got "
                         f"{a0.dtype} {tuple(a0.shape)}")
    shape = tuple(a0.shape)
    N = shape[-1]
    dev = a0.device
    if tuple(ph.shape) != shape or not ph.is_complex():
        raise ValueError(f"step_phasor_scaled must be complex {shape}")
    if ns is not None and tuple(ns.shape) != shape:
        raise ValueError(f"noise_scale must be {shape}")
    npup = W.shape[0]
    pm_shape = (shape[0], npup, npup) if batch else (npup, npup)
    if tuple(W.shape) != (npup, N) or tuple(pm.shape) != pm_shape:
        raise ValueError(f"W must be (npup, {N}) and pupil_mode "
                         f"{'(B, npup, npup)' if batch else '(npup, npup)'}")
    for name, t in (("step_phasor_scaled", ph), ("noise_scale", ns),
                    ("W", W), ("pupil_mode", pm)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, a0 on {dev}")
    if not batch:
        a0, ph, pm = a0[None], ph[None], pm[None]
        ns = None if ns is None else ns[None]
    f32 = torch.float32
    st = torch.stack([a0.real, a0.imag]).to(f32).contiguous()
    ph2 = torch.stack([ph.real, ph.imag]).to(f32).contiguous()
    ns32 = None if ns is None else ns.to(f32).contiguous()
    wr, wi, pm_t = pad_pupil(W.real.to(f32).contiguous(),
                             W.imag.to(f32).contiguous(),
                             pm.to(f32).transpose(-2, -1).contiguous())
    return st, ph2, ns32, wr, wi, pm_t.contiguous()


def ar_dft_reference(ar, ai, wr, wi, precision="highest"):
    """The kernel's first product in stock torch ops: from the layer sums
    ``ar + i ai`` (..., N, N), ``G' = A^T W^T``, ``(gr, gi)`` (..., N, P)
    for the P rows of ``wr``, ``wi``; the products at ``precision``."""
    art, ait = ar.transpose(-2, -1), ai.transpose(-2, -1)
    wrt, wit = wr.T, wi.T
    return (mm(art, wrt, precision) - mm(ait, wit, precision),
            mm(art, wit, precision) + mm(ait, wrt, precision))


def ar_detect_reference(gr, gi, wr, wi, pm_t, precision="highest"):
    """The kernel's detect pass in stock torch ops: from ``G'`` (``gr``,
    ``gi``: (..., N, P)), the transposed screen ``Re(W G')`` (..., P, P)
    and ``(sum pm_t cos, sum pm_t sin)``: (..., 2) float32, with ``pm_t``
    broadcast over the leading axes ((B, P, P) for B series on the last
    one); the products at ``precision``."""
    s, c = sincos(mm(wr, gr, precision) - mm(wi, gi, precision))
    return torch.stack([(pm_t * c).sum((-2, -1)), (pm_t * s).sum((-2, -1))],
                       dim=-1)


def detect_real_reference(ar, ai, wr, wi, pm_t, precision="highest"):
    """The kernel's two products and its detect pass in stock torch ops:
    from the layer sums ``ar + i ai`` (..., N, N), ``G' = A^T W^T`` (...,
    N, P) (:func:`ar_dft_reference`), then :func:`ar_detect_reference`."""
    return ar_detect_reference(*ar_dft_reference(ar, ai, wr, wi, precision),
                               wr, wi, pm_t, precision)


def _reference(seed, st, ph2, ns, wr, wi, pm_t, nsteps, noise, step0, bits,
               series0=0, precision="highest"):
    """The plain version on packed arguments; ``st`` (2, B, L, N, N) is
    advanced in place, series s drawing the Philox rows of series
    ``series0 + s``. Returns the (nsteps, B, 2) sums."""
    _, B, L, N, _ = st.shape
    sr, si = st[0], st[1]
    pr, pi = ph2[0], ph2[1]
    per = max(1, _REF_POINTS // (B * L * N * N))
    parts = []
    for t0 in range(0, nsteps, per):
        nt = min(per, nsteps - t0)
        if ns is not None:
            blk = bits
            if not (bits is None or isinstance(bits, str)):
                blk = tuple(b[t0:t0 + nt].reshape(nt, B * L, N, N)
                            for b in bits)
            z1, z2 = (z.view(nt, B, L, N, N) for z in ar_noise(
                seed, step0 + t0, nt, B * L, N, noise, st.device, blk,
                layer0=series0 * L))
        A = torch.empty((2, nt, B, N, N), dtype=torch.float32,
                        device=st.device)
        for t in range(nt):
            # every product and sum rounded on its own, in the kernel's order
            nr = sr * pr - si * pi
            ni = sr * pi + si * pr
            if ns is not None:
                nr = nr + z1[t] * ns
                ni = ni + z2[t] * ns
            sr, si = nr, ni
            sum_r, sum_i = sr[:, 0], si[:, 0]
            for lay in range(1, L):
                sum_r = sum_r + sr[:, lay]
                sum_i = sum_i + si[:, lay]
            A[0, t], A[1, t] = sum_r, sum_i
        parts.append(detect_real_reference(A[0], A[1], wr, wi, pm_t,
                                           precision))
    st[0], st[1] = sr, si
    return torch.cat(parts)


def ar_flow_reference(seed, a0, step_phasor_scaled, noise_scale, W,
                      pupil_mode, nsteps, noise="uniform", step0=0,
                      bits=None, precision="highest"):
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
        precision: the ``PRECISION`` of the two products
            (``synth_detect.PASSES``).

    Returns:
        ``(couplings, a_final)``: (nsteps, 2) float32 unnormalised
        couplings and the (L, N, N) complex64 state after the last step.
    """
    st, ph2, ns, wr, wi, pm_t = _pack(a0, step_phasor_scaled, noise_scale, W,
                                      pupil_mode)
    out = _reference(seed, st, ph2, ns, wr, wi, pm_t, int(nsteps), noise,
                     int(step0), bits, precision=precision)
    return out[:, 0], torch.complex(st[0, 0], st[1, 0])


def ar_flow_batch_reference(seed, a0, step_phasor_scaled, noise_scale, W,
                            pupil_modes, nsteps, noise="uniform", step0=0,
                            bits=None, series0=0, precision="highest"):
    """K6 in stock torch ops: :func:`ar_flow_reference` for B series at
    once, series s drawing the rows ``(series0 + s) * L ..`` of the Philox
    counter.

    Args: as :func:`ar_flow_reference`, with a leading series axis on
    ``a0``, ``step_phasor_scaled``, ``noise_scale`` (B, L, N, N) and
    ``pupil_modes`` (B, npup, npup); ``W`` is shared; ``bits`` are (nsteps,
    B, L, N, N); ``series0`` is the index of the first series in the
    Philox counter (series ``series0 ..`` of a larger batch).

    Returns:
        ``(couplings, a_final)``: (nsteps, B, 2) float32 and the (B, L, N,
        N) complex64 states after the last step.
    """
    st, ph2, ns, wr, wi, pm_t = _pack(a0, step_phasor_scaled, noise_scale, W,
                                      pupil_modes, batch=True)
    out = _reference(seed, st, ph2, ns, wr, wi, pm_t, int(nsteps), noise,
                     int(step0), bits, int(series0), precision)
    return out, torch.complex(st[0], st[1])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _library():
    lib, info = _build.load_library("ar_flow")
    if not getattr(lib, "_fast_typed", False):
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        lib.fast_ar_flow.argtypes = [u, u, u] + [i] * 7 + [p] * 13 \
            + [i, i, i, p]
        lib.fast_ar_flow.restype = i
        lib.fast_ar_dft.argtypes = [i] + [p] * 5 + [i, i, i, p]
        lib.fast_ar_dft.restype = i
        lib.fast_ar_detect.argtypes = [i, i] + [p] * 6 + [i, i, i, p]
        lib.fast_ar_detect.restype = i
        lib.fast_error_string.argtypes = [i]
        lib.fast_error_string.restype = ctypes.c_char_p
        lib._fast_typed = True
    return lib, info


def _wpack(wr, wi, laid, npass):
    """The laid W table's ``wpack`` of ``npass`` TF32 passes for the padded
    ``wr``, ``wi``: ``laid``'s (checked against them) or laid out for the
    call."""
    if laid is None:
        laid = laid_w(wr, wi)
    _check_laid(laid, wr)
    return laid.tables(npass)[0]


def _ar_flow(wrapper, lb, seed, a0, ph, ns, W, pm, nsteps, noise, step0,
             max_steps, batch=False, series0=0, laid=None,
             precision="highest"):
    nsteps, step0, series0 = int(nsteps), int(step0), int(series0)
    npass = passes(precision)
    if nsteps <= 0:
        raise ValueError("nsteps must be positive")
    if series0 < 0:
        raise ValueError("series0 must not be negative")
    if noise not in _NOISE_CODE:
        raise ValueError("noise must be 'uniform'|'gauss'")
    if not 0 <= step0 <= step0 + nsteps <= 2 ** 32:
        raise ValueError("step0 + nsteps must fit in 32 bits")
    k0, k1 = _key(seed)
    st, ph2, ns, wr, wi, pm_t = _pack(a0, ph, ns, W, pm, batch)
    if laid is not None:
        _check_laid(laid, wr)
    dev = st.device
    _, B, L, N, _ = st.shape
    if dev.type == "cpu":
        out = _reference(seed, st, ph2, ns, wr, wi, pm_t, nsteps, noise,
                         step0, None, series0, precision)
    elif dev.type != "cuda":
        raise ValueError(f"the AR flow kernels run on CPU or CUDA, not {dev}")
    elif (not supports(N, W.shape[0]) or B > _B_MAX
          or (series0 + B) * L > 0x7FFFFFFF):
        raise ValueError(
            f"the AR flow kernels take a grid of at most {_N_MAX} px, a "
            f"pupil of at most {128 * _T_MAX} px, at most {_B_MAX} series "
            f"and Philox rows below 2^31; got N={N}, a {W.shape[0]} px "
            f"pupil, {B} series from series {series0} of {L} layers")
    else:
        lib, _ = _library()
        P = wr.shape[0]
        per = min(nsteps, int(max_steps))
        tile = min(per, tile_steps(N, P, B))
        wpack = _wpack(wr, wi, laid, npass)
        a = torch.empty((2, tile * B, N, N), dtype=torch.float32, device=dev)
        g = torch.empty((2, tile * B, N, P), dtype=torch.float32, device=dev)
        part = torch.empty((tile * B, detect_parts(P), 2),
                           dtype=torch.float32, device=dev)
        out = torch.empty((nsteps, B, 2), dtype=torch.float32, device=dev)
        code = 0 if ns is None else _NOISE_CODE[noise]
        with torch.cuda.device(dev):
            cs = torch.cuda.current_stream(dev).cuda_stream
            for t0 in range(0, nsteps, per):
                err = lib.fast_ar_flow(
                    k0, k1, step0 + t0, min(per, nsteps - t0), tile, B,
                    series0, L, lb, code, st[0].data_ptr(), st[1].data_ptr(),
                    ph2[0].data_ptr(), ph2[1].data_ptr(),
                    None if ns is None else ns.data_ptr(), wpack.data_ptr(),
                    pm_t.data_ptr(), a[0].data_ptr(), a[1].data_ptr(),
                    g[0].data_ptr(), g[1].data_ptr(), part.data_ptr(),
                    out[t0:].data_ptr(), N, P, npass, cs)
                raise_on(lib, err, f"{wrapper.__name__} launch")
                count(wrapper, npass)
    if batch:
        return out, torch.complex(st[0], st[1])
    return out[:, 0], torch.complex(st[0, 0], st[1, 0])


def ar_flow_fused(seed, a0, step_phasor_scaled, noise_scale, W, pupil_mode,
                  nsteps, noise="uniform", step0=0, max_steps=MAX_STEPS,
                  laid=None, precision="highest"):
    """K4: the whole coupling series with every layer of a mode advanced
    in one thread's registers; arguments and returns as
    :func:`ar_flow_reference`.

    On CUDA tensors this launches the kernel (three passes per time tile,
    one launch per ``max_steps`` steps, the n-th from the absolute step
    ``step0 + max_steps * n``) on the current stream and counts each
    launch in ``ar_flow_fused.LAUNCHES`` and ``LAUNCHES_BY_PASSES``, or
    raises for what it does not take (:func:`supports`, more than
    :data:`FUSED_MAX_LAYERS` layers); on CPU tensors it runs the plain
    version. Both products at ``precision`` (``synth_detect.PASSES``).
    ``laid``: the :class:`~fast_tpu_torch.ops.synth_detect.LaidW` of ``W``
    (the engine's ``tables["w_laid"]``), else W is laid out for the call.
    """
    L = a0.shape[0]
    if L > FUSED_MAX_LAYERS:
        raise ValueError(
            f"the fused AR kernel holds at most {FUSED_MAX_LAYERS} layers "
            f"per mode, got {L}; ar_flow_streamed takes any number")
    return _ar_flow(ar_flow_fused, L, seed, a0, step_phasor_scaled,
                    noise_scale, W, pupil_mode, nsteps, noise, step0,
                    max_steps, laid=laid, precision=precision)


def ar_flow_streamed(seed, a0, step_phasor_scaled, noise_scale, W,
                     pupil_mode, nsteps, noise="uniform", step0=0,
                     max_steps=MAX_STEPS, lb_layers=STREAM_LAYERS,
                     laid=None, precision="highest"):
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
                    max_steps, laid=laid, precision=precision)


def ar_flow_fused_batch(seed, a0, step_phasor_scaled, noise_scale, W,
                        pupil_modes, nsteps, noise="uniform", step0=0,
                        max_steps=MAX_STEPS, series0=0, laid=None,
                        precision="highest"):
    """K6: B independent series sharing ``W`` in one launch per
    ``max_steps`` steps; arguments and returns as
    :func:`ar_flow_batch_reference`.

    Each series' layers are advanced as :func:`select` would for one
    series: all in one thread's registers up to
    :data:`FUSED_MAX_LAYERS` layers, else in blocks of
    :data:`STREAM_LAYERS`; series s draws the rows ``(series0 + s) * L
    ..`` of the Philox counter, so series 0 is K4's series from the same
    seed, and a call on series ``series0 ..`` of a batch draws what the
    call on the whole batch draws for them. On
    CUDA tensors this launches the kernel on the current stream and counts
    each launch in ``ar_flow_fused_batch.LAUNCHES``, or raises; on CPU
    tensors it runs the plain version. ``laid`` as
    :func:`ar_flow_fused`'s.
    """
    L = a0.shape[1] if a0.ndim == 4 else 0
    lb = L if L <= FUSED_MAX_LAYERS else STREAM_LAYERS
    return _ar_flow(ar_flow_fused_batch, lb, seed, a0, step_phasor_scaled,
                    noise_scale, W, pupil_modes, nsteps, noise, step0,
                    max_steps, batch=True, series0=series0, laid=laid,
                    precision=precision)


counters(ar_flow_fused)
counters(ar_flow_streamed)
counters(ar_flow_fused_batch)


def _pass_tables(wr, wi, what):
    """``wr``, ``wi`` (npup, N) float32 padded to :func:`padded_pupil`."""
    if wr.ndim != 2 or wr.shape != wi.shape:
        raise ValueError(f"{what}: wr, wi must be (npup, N)")
    return pad_pupil(wr.contiguous(), wi.contiguous(), None)[:2]


def _check_f32(what, dev, **tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{what}: {name} must be float32 on {dev}")


def ar_dft(a_re, a_im, wr, wi, laid=None, precision="highest"):
    """The kernels' first product alone: ``G' = A^T W^T`` of nj layer sums
    ``a_re + i a_im`` (nj, N, N) float32 for a pupil ``wr + i wi`` (npup,
    N) float32; returns ``(gr, gi)``, (nj, N, P) float32 with the pupil
    axis padded to a multiple of 16 (padded columns are zero). For timing
    the pass and holding it against :func:`ar_dft_reference` element by
    element.

    On CUDA tensors this launches ``ar_dft`` of ``csrc/ar_flow.cu`` (the
    second pass of ``csrc/detect.cuh`` on the laid W table ``laid``, or W
    laid out for the call; one launch, counted in ``ar_dft.LAUNCHES`` and
    ``LAUNCHES_BY_PASSES``) on the current stream, or raises; on CPU
    tensors it runs the plain version; both at ``precision``.
    """
    if (a_re.ndim != 3 or a_re.shape != a_im.shape
            or a_re.shape[-1] != a_re.shape[-2]):
        raise ValueError("a_re, a_im must be (nj, N, N)")
    nj, N = a_re.shape[0], a_re.shape[-1]
    if wr.ndim != 2 or wr.shape[-1] != N:
        raise ValueError(f"wr, wi must be (npup, {N})")
    dev = a_re.device
    _check_f32("ar_dft", dev, a_re=a_re, a_im=a_im, wr=wr, wi=wi)
    wr, wi = _pass_tables(wr, wi, "ar_dft")
    npass = passes(precision)
    if laid is not None:
        _check_laid(laid, wr)
    if dev.type == "cpu":
        return ar_dft_reference(a_re, a_im, wr, wi, precision)
    if dev.type != "cuda":
        raise ValueError(f"ar_dft runs on CPU or CUDA, not {dev}")
    if not supports(N, wr.shape[0]):
        raise ValueError(f"ar_dft takes a grid of at most {_N_MAX} px and "
                         f"a pupil of at most {128 * _T_MAX} px")
    P = wr.shape[0]
    a_re, a_im = a_re.contiguous(), a_im.contiguous()
    wpack = _wpack(wr, wi, laid, npass)
    lib, _ = _library()
    g = torch.empty((2, nj, N, P), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fast_ar_dft(nj, wpack.data_ptr(), a_re.data_ptr(),
                              a_im.data_ptr(), g[0].data_ptr(),
                              g[1].data_ptr(), N, P, npass,
                              torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "ar_dft launch")
    count(ar_dft, npass)
    return g[0], g[1]


def ar_detect(gr, gi, wr, wi, pm_t, laid=None, precision="highest"):
    """The kernels' detect pass alone: the (nj, 2) sums ``(sum pm_t cos
    phi^T, sum pm_t sin phi^T)`` of ``phi^T = Re(W G')`` for nj pairs'
    ``G'`` (``gr``, ``gi``: (nj, N, P) float32, P a multiple of 16, as
    :func:`ar_dft` returns it), pair j weighted by ``pm_t[j % B]`` (``pm_t``:
    (B, P, P) float32, transposed and padded; nj a multiple of B: steps of
    B series); ``wr``, ``wi`` (npup, N). For timing the pass and holding
    it against :func:`ar_detect_reference`.

    On CUDA tensors this launches ``ar_detect`` of ``csrc/ar_flow.cu`` and
    its ``sum_tiles`` (counted once in ``ar_detect.LAUNCHES`` and
    ``LAUNCHES_BY_PASSES``) on the current stream, or raises; on CPU
    tensors it runs the plain version; both at ``precision``. ``laid`` as
    :func:`ar_dft`'s.
    """
    if gr.ndim != 3 or gr.shape != gi.shape:
        raise ValueError("gr, gi must be (nj, N, P)")
    nj, N, P = gr.shape
    dev = gr.device
    _check_f32("ar_detect", dev, gr=gr, gi=gi, wr=wr, wi=wi, pm_t=pm_t)
    wr, wi = _pass_tables(wr, wi, "ar_detect")
    if tuple(wr.shape) != (P, N):
        raise ValueError(f"ar_detect: W must pad to ({P}, {N})")
    if pm_t.ndim != 3 or pm_t.shape[1:] != (P, P) or nj % pm_t.shape[0]:
        raise ValueError(f"ar_detect: pm_t must be (B, {P}, {P}) with B "
                         f"dividing {nj}")
    npass = passes(precision)
    if laid is not None:
        _check_laid(laid, wr)
    B = pm_t.shape[0]
    if dev.type == "cpu":
        return ar_detect_reference(gr.reshape(nj // B, B, N, P),
                                   gi.reshape(nj // B, B, N, P), wr, wi,
                                   pm_t, precision).reshape(nj, 2)
    if dev.type != "cuda":
        raise ValueError(f"ar_detect runs on CPU or CUDA, not {dev}")
    if not supports(N, P):
        raise ValueError(f"ar_detect takes a grid of at most {_N_MAX} px "
                         f"and a pupil of at most {128 * _T_MAX} px")
    gr, gi, pm_t = gr.contiguous(), gi.contiguous(), pm_t.contiguous()
    wpack = _wpack(wr, wi, laid, npass)
    lib, _ = _library()
    part = torch.empty((nj, detect_parts(P), 2), dtype=torch.float32,
                       device=dev)
    out = torch.empty((nj, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fast_ar_detect(nj, B, wpack.data_ptr(), gr.data_ptr(),
                                 gi.data_ptr(), pm_t.data_ptr(),
                                 part.data_ptr(), out.data_ptr(), N, P, npass,
                                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on(lib, err, "ar_detect launch")
    count(ar_detect, npass)
    return out


counters(ar_dft)
counters(ar_detect)
