"""Optical-communications layer of the port.

The behaviour of ``fast_tpu.comms`` (after the reference's
``fast/comms.py``) in PyTorch's idiom, on the run device:

* **Modem** (:class:`Modulator`): symbols from ``torch.randint`` and AWGN
  from ``torch.randn``, both drawn from an explicit generator on the run
  device, decided with the closed forms of ``fast_tpu``'s modem (phase
  rounding for PSK rings, per-axis clipped rounding for square QAM, a 0.5
  threshold for OOK) instead of an M-way distance search. The stream is
  worked in chunks over the iteration axis, each chunk reduced to its
  error count and EVM sums on the device, so the peak memory is bounded
  whatever NITER is; ``run()`` keeps no stream. The streams are made on
  first access by re-running the same chunks from the generator state
  saved when the stream was modulated, so they reproduce the reported SEP
  exactly.
* **I-Q plane PDFs** (:func:`convolve_awgn_qam`): the per-symbol 2-D
  histograms of ``constellation[c] * |samples|`` are integer counts from
  ``torch.bincount`` over the flattened (symbol, row, column) index (exact
  on the card, where float atomics would not be); the AWGN smoothing is
  the separable Toeplitz product ``K H K^T``, the shot-noise smoothing a
  sum of per-bin Gaussians in row blocks.
* **GMI / MI**: one einsum over the Gray-label bit-membership matrix.
* **Fade statistics** (:func:`fade_prob`, :func:`fade_dur`): run-length
  bookkeeping with ``cumsum`` and an integer ``scatter_add``.

Each function that ``fast_tpu`` runs as a jitted program (the modem, the
PDFs, GMI/MI, ``fade_dur``) takes ``device=``: by default the device of a
tensor input, else ``"cuda"``, which raises without a card (as
``Fast(params)`` does) unless the caller passes ``"cpu"``. The PDFs work
in float64 on the CPU and float32 on the card unless ``dtype=`` says
otherwise. The constellations, Gray labels, closed-form error rates and
payload packing are host numpy, as in ``fast_tpu``.
"""

import numpy as np
import torch
from scipy.special import erfc

from .engine import Fast, _resolve_device
from .interop import as_torch_dtype
# namespace parity: the reference re-exports aotools' gaussian2d here
# (``fast/comms.py:8``)
from .ops.apertures import gaussian2d  # noqa: F401
from .ops.rng import make_generator

_MODEM_SYMBOLS = 1 << 24  # symbols of one modem chunk (~0.7 GB of buffers)
_HIST_POINTS = 1 << 24    # (symbol, sample) pairs binned by one bincount
_SHOT_ELEMENTS = 1 << 24  # elements of one row block of the shot-noise sum


def _run_device(device, data):
    """The device of a run: ``device``, else that of ``data`` if it is a
    tensor, else ``"cuda"``; raises for a missing card."""
    if device is None:
        device = data.device if torch.is_tensor(data) else "cuda"
    return _resolve_device(device)


def _as_tensor(data, device):
    """``data`` (numpy, sequence or tensor) as a tensor on ``device``."""
    if torch.is_tensor(data):
        return data.to(device)
    return torch.as_tensor(np.asarray(data), device=device)


# ---------------------------------------------------------------------------
# constellations and Gray labelling (host numpy)
# ---------------------------------------------------------------------------


def _parse_scheme(modulation):
    """Scheme name -> (kind, M, phase offset). kind in {ook, psk, qam}."""
    if modulation == "OOK":
        return "ook", 2, 0.0
    if modulation == "BPSK":
        return "psk", 2, 0.0
    if modulation in ("QPSK", "QAM"):
        return "psk", 4, -np.pi / 4
    parts = modulation.split("-")
    if len(parts) == 2 and parts[0].isdigit():
        M = int(parts[0])
        if parts[1] == "PSK":
            return "psk", M, 0.0
        if parts[1] == "QAM":
            n_side = int(round(np.sqrt(M)))
            if n_side * n_side != M:
                raise ValueError(
                    f"{M}-QAM not possible as {M} is not a perfect square, "
                    "only square M-QAM modulations supported")
            return "qam", M, 0.0
    raise ValueError(f"Modulation scheme {modulation} not supported")


def _qam_axis_levels(M):
    """Per-axis amplitude levels of the square M-QAM grid."""
    n_side = int(round(np.sqrt(M)))
    return np.linspace(-1, 1, n_side) / np.sqrt(2)


def define_constellation(modulation):
    """Complex constellation points for a named modulation scheme.

    The reference's geometry (``fast/comms.py:418-474``): OOK on the real
    axis, unit-circle PSK (QPSK offset by -pi/4), square M-QAM filling the
    unit box scaled by 1/sqrt(2).
    """
    kind, M, offset = _parse_scheme(modulation)
    if kind == "ook":
        return np.array([0.0, 1.0])
    if kind == "psk":
        return np.exp(1j * (2 * np.pi * np.arange(M) / M + offset))
    levels = _qam_axis_levels(M)
    re, im = np.meshgrid(levels, levels, indexing="xy")
    return (re + 1j * im).ravel()


def gray_labels_qam(M):
    """Gray-coded integer labels over the square QAM grid.

    ``gray(i) = i ^ (i >> 1)`` laid out row-major with every other row
    reversed (boustrophedon), so horizontally and vertically adjacent
    points differ in exactly one bit (the reference's labels,
    ``fast/comms.py:477-500``, as integers).
    """
    n_side = int(round(np.sqrt(M)))
    idx = np.arange(M)
    grid = (idx ^ (idx >> 1)).reshape(n_side, n_side)
    grid[1::2] = grid[1::2, ::-1]
    return grid.ravel()


def _bit_membership(M):
    """(m, M) bool matrix: row i = 'bit i (MSB first) of the Gray label is 0'."""
    m = int(np.log2(M))
    labels = gray_labels_qam(M)
    shifts = np.arange(m - 1, -1, -1)
    return ((labels[None, :] >> shifts[:, None]) & 1) == 0


# ---------------------------------------------------------------------------
# the modem
# ---------------------------------------------------------------------------


def _modem_points(kind, M, offset, q_lo, q_step, device):
    """The constellation as the modem computes it: complex64 on ``device``."""
    f32 = torch.float32
    k = torch.arange(M, dtype=f32, device=device)
    if kind == "ook":
        return torch.complex(k, torch.zeros_like(k))
    if kind == "psk":
        ang = 2 * np.pi * k / M + np.float32(offset)
        return torch.complex(torch.cos(ang), torch.sin(ang))
    n_side = int(round(np.sqrt(M)))
    q_lo, q_step = np.float32(q_lo), np.float32(q_step)
    return torch.complex(q_lo + q_step * torch.remainder(k, n_side),
                         q_lo + q_step * torch.div(k, n_side,
                                                   rounding_mode="floor"))


def _modem_chunks(gen, power, fixed, esn0_db, *, kind, M, offset, q_lo,
                  q_step, S, noisy):
    """Modulate, corrupt and decide the (S, B) symbol stream over the
    iterations of ``power`` (B,), in chunks of iterations drawn from
    ``gen`` one after the other. Yields ``(symbols, decisions, recv, tx)``
    per chunk: (S, b) int64, int64, complex64, complex64. ``fixed`` (S,)
    are payload symbols, or None for random ones."""
    dev = power.device
    f32 = torch.float32
    points = _modem_points(kind, M, offset, q_lo, q_step, dev)
    Es = (points.abs() ** 2).mean()
    n_side = int(round(np.sqrt(M)))
    step = np.float32(2 * np.pi / M)
    p32 = power.to(f32)
    per = max(1, _MODEM_SYMBOLS // S)
    for b0 in range(0, p32.shape[0], per):
        pb = p32[b0:b0 + per]
        nb = pb.shape[0]
        if fixed is None:
            symbols = torch.randint(0, M, (S, nb), generator=gen, device=dev)
        else:
            symbols = fixed[:, None].expand(S, nb)
        tx = points[symbols]
        recv = tx
        if noisy:
            snr = float(np.sqrt(10.0 ** (esn0_db / 10.0))) * pb
            if kind == "ook":
                noise = torch.randn((S, nb), generator=gen, dtype=f32,
                                    device=dev)
                recv = tx + noise * (Es / snr)
            else:
                z = torch.randn((2, S, nb), generator=gen, dtype=f32,
                                device=dev)
                recv = tx + (torch.sqrt(Es / 2) / snr) * torch.complex(z[0],
                                                                       z[1])
        if kind == "ook":
            decisions = (recv.real > 0.5).long()
        elif kind == "psk":
            n = torch.round((torch.atan2(recv.imag, recv.real)
                             - np.float32(offset)) / step)
            decisions = torch.remainder(n, M).long()
        else:
            q_lo32, q_step32 = np.float32(q_lo), np.float32(q_step)
            k_re = torch.clamp(torch.round((recv.real - q_lo32) / q_step32),
                               0, n_side - 1)
            k_im = torch.clamp(torch.round((recv.imag - q_lo32) / q_step32),
                               0, n_side - 1)
            decisions = (k_im * n_side + k_re).long()
        yield symbols, decisions, recv, tx


_UNSET = object()  # distinguishes "never assigned" from an assigned None


class Modulator:
    """Modulate/demodulate symbol streams over the MC power series.

    The surface of ``fast_tpu.comms.Modulator`` (after the reference's
    ``fast/comms.py:13-145``): OOK/BPSK/QPSK/M-PSK/square M-QAM, optional
    AWGN at average symbol SNR ``EsN0``, SEP and EVM.

    ``power`` is a numpy array or a tensor; a complex one (a ``COHERENT``
    run's field) becomes ``|field|^2``. It is normalised by its mean on the
    run ``device`` (by default the device of a tensor ``power``, else
    ``"cuda"``), so a series already on the card never goes to the host;
    ``power``, ``amplitude`` and ``snr`` are float64 tensors there, and
    the streams (``symbols``, ``recv_signal``, ``recv_symbols``,
    ``awgn``) tensors there, (symbols_per_iter, iterations) as in
    ``fast_tpu``. ``rng`` is an int seed, a ``numpy.random.Generator`` (a
    seed is drawn from it), a ``torch.Generator`` on the run device, or
    None for fresh entropy.
    """

    _demodulated = False

    def __init__(self, power, modulation, EsN0=None, symbols_per_iter=1000,
                 data=None, rng=None, device=None):
        self.device = _run_device(device, power)
        power = _as_tensor(power, self.device)
        if power.is_complex():
            power = power.abs() ** 2
        power = power.to(torch.float64)
        self.power = power / power.mean()
        self.amplitude = torch.sqrt(self.power)
        self.modulation = modulation
        self.symbols_per_iter = symbols_per_iter
        self.EsN0 = EsN0
        self.data = data
        self._generator = _as_generator(rng, self.device)
        if EsN0 is not None:
            self.snr = np.sqrt(10 ** (EsN0 / 10)) * self.power

    def generate_symbols(self):
        """Resolve the scheme and, for payload data, the symbol stream."""
        kind, M, offset = _parse_scheme(self.modulation)
        self._kind, self._offset = kind, offset
        self.nsymbols = M
        self.bits_per_symbol = int(np.log2(M))
        if self.data is not None:
            s, self._pad_bits = pack_payload(self.data, self.bits_per_symbol)
            self.symbols_per_iter = len(s)
            self._fixed_symbols = torch.as_tensor(np.asarray(s, np.int64),
                                                  device=self.device)
        else:
            self._fixed_symbols = None

    def modulate(self):
        self._modulate_impl()
        return self.recv_signal  # makes the streams (parity)

    def _modulate_impl(self):
        """Modulate without making the streams (what run() does)."""
        if self.modulation is None:
            self.recv_signal = self.power
            return
        self.generate_symbols()
        self.constellation = define_constellation(self.modulation)
        self.Es = float((np.abs(self.constellation) ** 2).mean())
        self._run_kernel()

    def _run_kernel(self):
        kind, M = self._kind, self.nsymbols
        if kind == "qam":
            levels = _qam_axis_levels(M)
            q_lo, q_step = float(levels[0]), float(levels[1] - levels[0])
        else:
            q_lo = q_step = 0.0
        noisy = self.EsN0 is not None
        self._chunk_args = (self.power, self._fixed_symbols,
                            self.EsN0 if noisy else 0.0)
        self._chunk_kw = dict(kind=kind, M=M, offset=self._offset, q_lo=q_lo,
                              q_step=q_step, S=self.symbols_per_iter,
                              noisy=noisy)
        # every pass over the stream starts from this state: the lazy
        # streams are those the reported SEP and EVM were computed from
        self._gen_state = self._generator.get_state()
        self._streams = None
        self._stats = None
        self._noisy = noisy
        # a re-modulation regenerates every stream: drop any
        # reference-parity attribute assignments (the reference keeps
        # plain attributes, which its modulate() overwrites) so stale
        # overrides can't shadow the fresh streams
        self._symbols_override = None
        self._recv_override = None
        self._awgn_override = None
        self._recv_symbols_override = _UNSET
        self._demodulated = False

    def _chunks(self):
        gen = torch.Generator(device=self.device)
        gen.set_state(self._gen_state)
        return _modem_chunks(gen, *self._chunk_args, **self._chunk_kw)

    def _stats_vals(self):
        """(sep, evm), from one pass over the stream that keeps no chunk,
        unless already known."""
        if self._stats is None:
            acc = _StatsSum()
            for chunk in self._chunks():
                acc.add(*chunk)
            self._stats = acc.result()
        return self._stats

    def _fetch_streams(self):
        """The symbol, decision and received streams (made once, on first
        access, by the same pass as the statistics)."""
        if self._streams is None:
            acc = _StatsSum()
            parts = []
            for chunk in self._chunks():
                acc.add(*chunk)
                parts.append(chunk[:3])
            self._streams = tuple(torch.cat(p, dim=1) for p in zip(*parts))
            if self._stats is None:  # sticky once reported
                self._stats = acc.result()
        return self._streams

    @property
    def symbols(self):
        """Transmitted symbol indices (made on first access)."""
        if getattr(self, "_symbols_override", None) is not None:
            return self._symbols_override
        return self._fetch_streams()[0]

    @symbols.setter
    def symbols(self, value):
        self._symbols_override = value

    @property
    def recv_signal(self):
        """Received (noisy, faded) signal stream (made on first access):
        real for OOK, complex otherwise."""
        if getattr(self, "_recv_override", None) is not None:
            return self._recv_override
        recv = self._fetch_streams()[2]
        return recv.real if self._kind == "ook" else recv

    @recv_signal.setter
    def recv_signal(self, value):
        self._recv_override = value

    @property
    def recv_symbols(self):
        """Hard symbol decisions (made on first access; None before
        demodulation)."""
        ov = getattr(self, "_recv_symbols_override", _UNSET)
        if ov is not _UNSET:
            return ov
        if not self._demodulated:
            return None
        return self._fetch_streams()[1]

    @recv_symbols.setter
    def recv_symbols(self, value):
        self._recv_symbols_override = value

    @property
    def awgn(self):
        """The AWGN realisation added to the stream (reference parity),
        recovered as ``recv - tx``; 0 when noiseless."""
        if getattr(self, "_awgn_override", None) is not None:
            return self._awgn_override
        if not getattr(self, "_noisy", False):
            return 0
        tx = torch.as_tensor(self.constellation,
                             device=self.device)[self.symbols]
        if self._kind == "ook":
            tx = tx.real
        return self.recv_signal - tx

    @awgn.setter
    def awgn(self, value):
        # reference-compatible attribute assignment (the reference keeps
        # ``awgn`` as a plain attribute, fast/comms.py:78-86); assigned
        # values shadow the recovered recv - tx array
        self._awgn_override = value

    def demodulate(self):
        if self.modulation is None:
            self.recv_symbols = None
            return None
        self._demodulated = True
        if self.data is not None:
            decided = self.recv_symbols.cpu().numpy()
            self.recv_data = np.stack([
                np.frombuffer(
                    unpack_payload(decided[:, b], self.bits_per_symbol,
                                   self._pad_bits),
                    dtype=np.uint8)
                for b in range(decided.shape[1])
            ])
        return self.recv_symbols

    def compute_sep(self):
        """Symbol error probability over the stream."""
        self.sep = (None if self.modulation is None
                    else self._stats_vals()[0])
        return self.sep

    def compute_evm(self):
        """Error vector magnitude relative to the transmitted RMS."""
        self.evm = (None if self.modulation is None
                    else self._stats_vals()[1])
        return self.evm

    def run(self):
        self._modulate_impl()
        # mark demodulated (decisions are made on first access of
        # recv_symbols); payload-data mode decodes now, which needs the
        # stream
        self._demodulated = self.modulation is not None
        if self.data is not None:
            self.demodulate()
        self.compute_sep()
        self.compute_evm()


class _StatsSum:
    """SEP and EVM over the chunks of a stream: the error count exactly
    (int64), the EVM sums in float64, on the stream's device."""

    def __init__(self):
        self.errors = self.abs_err = self.tx2 = 0
        self.n = 0

    def add(self, symbols, decisions, recv, tx):
        self.errors = self.errors + (decisions != symbols).sum()
        self.abs_err = self.abs_err + (tx - recv).abs().double().sum()
        self.tx2 = self.tx2 + (tx.abs() ** 2).double().sum()
        self.n += symbols.numel()

    def result(self):
        """(sep, evm): errors / n, mean |tx - recv| over the RMS of tx."""
        sep = int(self.errors) / self.n
        evm = float(self.abs_err / self.n / torch.sqrt(self.tx2 / self.n))
        return sep, evm


def _as_generator(rng, device):
    if isinstance(rng, torch.Generator):
        if torch.device(rng.device).type != device.type:
            raise ValueError(f"rng is a generator on {rng.device}, the run "
                             f"is on {device}")
        return rng
    if isinstance(rng, np.random.Generator):
        rng = int(rng.integers(2 ** 63))
    elif rng is not None:
        rng = int(rng)
    return make_generator(rng, device=device)


def _result_series(result):
    """A result's series where it is: the device tensor until the host has
    asked for it, else its numpy copy. Unscaled (the modem normalises)."""
    return result._raw if result._np is None else result._np


class FastFSOC(Fast):
    """``Fast`` subclass wiring MODULATION/EsN0 into a post-run
    :class:`Modulator` on the run device."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.modulation = self.params["MODULATION"]
        self.EsN0 = self.params["EsN0"]

    def run(self):
        result = super().run()
        self.modulator = Modulator(_result_series(result), self.modulation,
                                   self.EsN0, device=self.device)
        self.modulator.run()
        return result

    def make_header(self, params):
        hdr = super().make_header(params)
        hdr["MODULATION"] = str(params["MODULATION"])
        hdr["EsN0"] = self.EsN0 if self.EsN0 is not None else "None"
        return hdr


# ---------------------------------------------------------------------------
# fade statistics
# ---------------------------------------------------------------------------


def _fade_run_stats(below):
    """(total fade samples, run count), Python ints, over the complete
    interior runs of the bool series ``below``: a run counts when it
    starts after t=0 (a 0->1 transition exists) and ends before the
    series does (the reference's split-at-starts / drop-unterminated
    bookkeeping, ``fast/comms.py:180-194``)."""
    n = below.shape[0]
    prev = torch.cat([below.new_zeros(1), below[:-1]])
    starts = below & ~prev
    starts[0] = False
    seg = torch.cumsum(starts, 0)              # 0 = before the first start
    lengths = torch.zeros(n // 2 + 2, dtype=torch.int64, device=below.device)
    lengths.scatter_add_(0, seg, (below & (seg > 0)).long())
    nruns = seg[-1]
    unterminated = below[-1] & (nruns > 0)
    last_len = torch.where(unterminated, lengths[nruns], 0)
    total = lengths.sum() - lengths[0] - last_len
    count = nruns - unterminated.long()
    return int(total), int(count)


def fade_prob(I, threshold, min_fades=30):
    """Probability of power below ``threshold``; NaN when fewer than
    ``min_fades`` fade samples exist (reference ``fast/comms.py:171-177``).
    A tensor ``I`` is counted on its device."""
    if torch.is_tensor(I):
        below = I < threshold
        nfades, size = int(below.sum()), below.numel()
    else:
        below = np.asarray(I) < threshold
        nfades, size = int(below.sum()), below.size
    if nfades < min_fades:
        return np.nan
    return nfades / size


def fade_dur(I, threshold, dt=1, min_fades=30, device=None):
    """Mean duration of complete fades below ``threshold``, NaN for fewer
    than ``min_fades`` of them (reference ``fast/comms.py:180-194``)."""
    dev = _run_device(device, I)
    total, count = _fade_run_stats(_as_tensor(I, dev).reshape(-1)
                                   < threshold)
    if count < min_fades:
        return np.nan
    return total / count * dt


# ---------------------------------------------------------------------------
# analytic error rates (host numpy)
# ---------------------------------------------------------------------------


def Q(x):
    """Gaussian tail probability."""
    return 0.5 * erfc(x / np.sqrt(2))


def ber_ook(EbN0, samples=None):
    """OOK bit error rate, optionally MC-averaged over fading ``samples``
    (Andrews & Phillips 2005 ch. 11 eq. 58; reference ``comms.py:197-221``)."""
    snr = np.sqrt(10 ** (EbN0 / 10))
    if samples is None:
        return Q(snr)
    s = samples / samples.mean()
    return Q(s * snr).mean()


def sep_qam(M, EsN0, samples=None):
    """Square M-QAM symbol error probability (Rice)."""
    EsN0_frac = 10 ** (EsN0 / 10)
    pre = (np.sqrt(M) - 1) / np.sqrt(M)
    if samples is not None:
        s = samples / samples.mean()
        EsN0_frac = EsN0_frac * s ** 2
    q = Q(np.sqrt(3 / (M - 1) * EsN0_frac))
    sep = 4 * (pre * q - pre ** 2 * q ** 2)
    return sep if samples is None else sep.mean()


def ber_qam(M, EbN0, samples=None):
    """Square M-QAM bit error rate (Gray coding, nearest-neighbour errors)."""
    return sep_qam(M, 10 * np.log10(np.log2(M)) + EbN0, samples) / np.log2(M)


# ---------------------------------------------------------------------------
# I-Q plane PDFs, mutual information
# ---------------------------------------------------------------------------


def _toeplitz_correlate_matrix(g, npxls):
    """K with K[i, j] = g[j - i + len(g)//2]: correlate1d as a matmul."""
    c = g.shape[0] // 2
    ij = torch.arange(npxls, device=g.device)
    idx = ij[None, :] - ij[:, None] + c
    valid = (idx >= 0) & (idx < g.shape[0])
    return torch.where(valid, g[idx.clamp(0, g.shape[0] - 1)], 0.0)


def _bin_index(v, lo, dx, hi, npxls):
    """Bin of each value, as a float; ``np.histogram2d`` closes the last
    bin on the right."""
    ix = torch.floor((v - lo) / dx)
    return torch.where(v == lo + hi, npxls - 1, ix)


def _histogram_counts(amp, pts_r, pts_i, lo_r, lo_i, dx, hi, npxls):
    """Per-symbol 2-D histogram counts of ``point_c * amp``: (M, npxls,
    npxls) int64, from one ``bincount`` per block of samples over the
    flattened (c, i, j) index; values outside the region go to one bin
    past the end, which is dropped."""
    M, nb = pts_r.shape[0], npxls
    size = M * nb * nb
    base = (torch.arange(M, device=amp.device) * (nb * nb))[:, None]
    counts = torch.zeros(size + 1, dtype=torch.int64, device=amp.device)
    per = max(1, _HIST_POINTS // M)
    for s0 in range(0, amp.shape[0], per):
        a = amp[None, s0:s0 + per]
        ixr = _bin_index(pts_r[:, None] * a, lo_r[:, None], dx, hi, nb)
        ixi = _bin_index(pts_i[:, None] * a, lo_i[:, None], dx, hi, nb)
        inside = (ixr >= 0) & (ixr < nb) & (ixi >= 0) & (ixi < nb)
        flat = (base + ixr.clamp(0, nb - 1).long() * nb
                + ixi.clamp(0, nb - 1).long())
        counts += torch.bincount(torch.where(inside, flat, size).reshape(-1),
                                 minlength=size + 1)
    return counts[:size].reshape(M, nb, nb)


def _iq_geometry(amp, M, npxls, EsN0, N0, individual, dtype):
    """The constellation ``(pts_r, pts_i)`` and the binning of the I-Q
    plane: ``(lo_r, lo_i)`` per symbol, the bin width, the region and
    ``N0``, ``mean |samples|``, all tensors of ``dtype``."""
    dev = amp.device
    pts = define_constellation(f"{M}-QAM")
    pts_r = torch.as_tensor(pts.real, dtype=dtype, device=dev)
    pts_i = torch.as_tensor(pts.imag, dtype=dtype, device=dev)
    mean_amp = amp.mean()
    region = (1 / (np.sqrt(M) - 1) if individual else 2.0) * mean_amp
    if N0 is not None:
        N0 = torch.tensor(float(N0), dtype=dtype, device=dev)
    else:
        Es = ((pts_r ** 2 + pts_i ** 2) * mean_amp ** 2).mean()
        esn0 = torch.tensor(float(EsN0 if EsN0 is not None else 0),
                            dtype=dtype, device=dev)
        N0 = Es / 10.0 ** (esn0 / 10.0)
    if not individual:
        # enlarge the decision region when the noise cloud would spill out
        region = torch.maximum(
            region, 2 * (mean_amp / np.sqrt(2) + 2 * torch.sqrt(N0)))
    dx = region / npxls
    if individual:
        lo_r = -region / 2 + pts_r * mean_amp
        lo_i = -region / 2 + pts_i * mean_amp
    else:
        lo_r = lo_i = (-region / 2).expand(M)
    return pts_r, pts_i, lo_r, lo_i, dx, region, N0, mean_amp


def _iq_pdf(amp, M, npxls, EsN0, N0, individual, shot, dtype):
    """Received I-Q plane PDFs per M-QAM symbol under AWGN: (M, npxls,
    npxls) of ``dtype`` on the device of ``amp`` (N,) = |samples|."""
    amp = amp.to(dtype)
    pts_r, pts_i, lo_r, lo_i, dx, region, N0, mean_amp = _iq_geometry(
        amp, M, npxls, EsN0, N0, individual, dtype)
    H = _histogram_counts(amp, pts_r, pts_i, lo_r, lo_i, dx, region,
                          npxls).to(dtype) / amp.shape[0]
    sigma2 = torch.clamp(N0 / (2 * dx ** 2), min=1.0)  # in bin units
    if not shot:
        x_g = torch.arange(npxls + 1, dtype=dtype, device=amp.device) \
            - npxls / 2
        g = torch.exp(-x_g ** 2 / sigma2) / torch.sqrt(np.pi * sigma2)
        K = _toeplitz_correlate_matrix(g, npxls)
        return K @ H @ K.T

    # shot noise: per-bin Gaussians whose variance scales with the bin's
    # radius, s = r^2 / (sigma2 mean_amp^2), summed over the bins in
    # blocks of rows
    grid = torch.arange(npxls, dtype=dtype, device=amp.device)
    xb = lo_r[:, None] + grid[None, :] * dx          # (M, npxls) left edges
    yb = lo_i[:, None] + grid[None, :] * dx
    s = (xb[:, :, None] ** 2 + yb[:, None, :] ** 2) / (sigma2 * mean_amp ** 2)
    W = H * s / np.pi
    d2 = (grid[None, :] - grid[:, None]) ** 2        # (bin, u): (u - bin)^2
    out = torch.zeros((M, npxls, npxls), dtype=dtype, device=amp.device)
    rows = max(1, _SHOT_ELEMENTS // (M * npxls ** 2))
    for i0 in range(0, npxls, rows):
        s_b = s[:, i0:i0 + rows, :, None]            # (M, r, j, 1)
        Au = torch.exp(-d2[None, i0:i0 + rows, None, :] * s_b)   # (M,r,j,u)
        Av = torch.exp(-d2[None, None, :, :] * s_b)               # (M,r,j,v)
        Wa = (W[:, i0:i0 + rows, :, None] * Au).reshape(M, -1, npxls)
        out += Wa.transpose(1, 2) @ Av.reshape(M, -1, npxls)
    return out


def _pdf_dtype(dtype, device):
    if dtype is not None:
        return as_torch_dtype(dtype)
    return torch.float64 if device.type == "cpu" else torch.float32


def _pdfs(samples, M, npxls, EsN0, N0, individual, shot, dtype, device):
    dev = _run_device(device, samples)
    amp = _as_tensor(samples, dev).abs().reshape(-1)
    return _iq_pdf(amp, int(M), int(npxls), EsN0, N0, individual, bool(shot),
                   _pdf_dtype(dtype, dev))


def convolve_awgn_qam(samples, M, npxls, EsN0, N0=None,
                      region_size="individual", shot=False, dtype=None,
                      device=None):
    """Received I-Q plane PDFs per M-QAM symbol under AWGN: (M, npxls,
    npxls) on the run device.

    Bins ``constellation[c] * |samples|`` into per-symbol 2-D histograms
    and smooths them with the AWGN Gaussian (separable Toeplitz products)
    or per-bin shot-noise Gaussians. Reference behaviour:
    ``fast/comms.py:317-415``.
    """
    if region_size not in ("individual", "full"):
        raise ValueError(
            "decision_region_size must be either 'full' or 'individual'")
    return _pdfs(samples, M, npxls, EsN0, N0, region_size == "individual",
                 shot, dtype, device)


def _masked_log2(f):
    return torch.where(f > 0, torch.log2(torch.where(f > 0, f, 1.0)), 0.0)


def _gmi_reduce(fyx, M):
    """Sum over bit positions of the bit-wise information integrals."""
    lfy = _masked_log2(fyx.mean(0))
    B0 = torch.as_tensor(_bit_membership(M), dtype=fyx.dtype,
                         device=fyx.device)           # (m, M): bit == 0
    fyb = torch.einsum("bic,cuv->biuv", torch.stack([B0, 1 - B0]),
                       fyx) / (M / 2)
    term = torch.where(fyb > 0, fyb * (_masked_log2(fyb) - lfy), 0.0)
    return float(term.sum((-1, -2)).mean(0).sum())


def generalised_mutual_information_qam(samples, M, npxls, EsN0, N0=None,
                                       shot=False, dtype=None, device=None):
    """GMI for bit-wise soft-decision decoding (Alvarado et al. 2016).

    Reference behaviour: ``fast/comms.py:265-302``; the per-bit loop is a
    single einsum against the Gray-label bit-membership matrix.
    """
    fyx = _pdfs(samples, M, npxls, EsN0, N0, False, shot, dtype, device)
    return _gmi_reduce(fyx, int(M))


def _mi_reduce(fyx):
    fy = fyx.mean(0)
    term = torch.where(fyx > 0,
                       fyx * (_masked_log2(fyx) - _masked_log2(fy)), 0.0)
    return float(term.sum((-1, -2)).mean())


def mutual_information_qam(samples, M, npxls, EsN0, N0=None, shot=False,
                           dtype=None, device=None):
    """Symbol-wise mutual information (Alvarado et al. 2016 eq. 16;
    reference ``fast/comms.py:304-314``)."""
    fyx = _pdfs(samples, M, npxls, EsN0, N0, False, shot, dtype, device)
    return _mi_reduce(fyx)


# ---------------------------------------------------------------------------
# payload packing (host numpy)
# ---------------------------------------------------------------------------


def pack_payload(payload, bits_per_symbol):
    """Byte payload -> (symbols, pad_bits), MSB-first within each symbol."""
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
    pad = (-len(bits)) % bits_per_symbol
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    weights = 1 << np.arange(bits_per_symbol - 1, -1, -1)
    return bits.reshape(-1, bits_per_symbol) @ weights, pad


def unpack_payload(symbols, bits_per_symbol, pad_bits=0):
    """Symbol stream -> byte payload (inverse of :func:`pack_payload`)."""
    symbols = np.asarray(symbols, dtype=np.int64)
    shifts = np.arange(bits_per_symbol - 1, -1, -1)
    bits = ((symbols[:, None] >> shifts) & 1).astype(np.uint8).ravel()
    if pad_bits:
        bits = bits[:-pad_bits]
    return np.packbits(bits).tobytes()


def flip_bits(data, ber, rng=None):
    """Randomly flip bits of a payload at rate ``ber`` (testing utility)."""
    rng = np.random.default_rng() if rng is None else rng
    if isinstance(data, str):
        raw = data.encode("ascii")
    elif isinstance(data, np.ndarray):
        raw = data.tobytes()
    else:
        raise TypeError("String or numpy array as data please")
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    bits ^= (rng.random(bits.size) < ber).astype(np.uint8)
    out = np.packbits(bits).tobytes()
    if isinstance(data, str):
        return bytes(b & 0x7F for b in out).decode("ascii")
    return np.frombuffer(out, dtype=data.dtype).reshape(data.shape)
