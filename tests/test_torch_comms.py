"""The comms layer of fast_tpu_torch against fast_tpu.comms, on the CPU,
and the card's modem and PDFs against the CPU port where a card is.

* Host numpy: constellations, Gray labels, bit membership, payload
  packing and bit flipping equal ``fast_tpu``'s; the closed-form error
  rates within 1e-12 relative.
* Fades: ``fade_prob`` and ``fade_dur`` (and the run counts under them)
  exactly equal on identical series, numpy or tensor, including a fade at
  t=0, an unterminated last run and fewer fades than ``min_fades``.
* PDFs: the per-symbol histogram counts equal ``fast_tpu``'s exactly at
  float64 on the same binning; ``convolve_awgn_qam`` ('individual',
  'full', shot noise, a given ``N0``), GMI and MI on identical samples
  within 1e-10 (relative to the largest PDF value; absolute in bits).
* Modem: noiseless, with a fixed payload, it decides exactly as
  ``fast_tpu``'s (every symbol right, the payload decoded). With noise its
  SEP lies within 4 standard errors of ``sep_qam`` at constant power, and
  within 4 combined standard errors (over iterations, whose symbols share
  a power) of ``fast_tpu.comms.Modulator``'s on the same fading power.
  The lazy streams reproduce the SEP of ``run()`` exactly and its EVM to
  1e-6 (their float64 constellation against the modem's float32 one),
  over several chunks; re-modulating clears assigned streams.
* ``FastFSOC(..., device="cpu")`` for OOK, BPSK and QAM on a small link
  agrees with ``fast_tpu.FastFSOC`` in distribution: SEP within 4
  combined standard errors over iterations.
* Devices: without ``device=``, a tensor input sets the device and numpy
  input means ``"cuda"``, which raises without a card.
* On the card (marker ``cuda``): the modem's SEP and EVM against the CPU
  port on the same power, each within 4 combined standard errors over
  iterations (different generators); the PDFs (float32) within 1e-3 of
  the largest PDF value of the CPU port's float64 ones, and GMI/MI within
  1e-3 bit/symbol.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_comms.py -m cuda
"""

import numpy as np
import pytest
import torch

from fast_tpu_torch import comms as tc

torch.set_num_threads(1)

REL = 1e-10
SIGMAS = 4.0


@pytest.fixture(scope="module")
def jc():
    from fast_tpu import comms
    return comms


def close(got, ref, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= rel * scale


@pytest.fixture(scope="module")
def samples():
    rng = np.random.default_rng(21)
    amp = np.sqrt(np.exp(rng.normal(-0.1, 0.45, size=3000)))
    return amp * np.exp(1j * rng.uniform(0, 2 * np.pi, amp.size))


def fading_power(n, seed, sigma=0.4):
    return np.exp(np.random.default_rng(seed).normal(0, sigma, n))


# ---------------------------------------------------------------------------
# host numpy
# ---------------------------------------------------------------------------


NAMES = ["OOK", "BPSK", "QPSK", "QAM", "8-PSK", "16-PSK", "16-QAM",
         "64-QAM"]


def test_constellations_labels_membership(jc):
    for name in NAMES:
        np.testing.assert_array_equal(tc.define_constellation(name),
                                      jc.define_constellation(name))
        assert tc._parse_scheme(name) == jc._parse_scheme(name)
    for bad in ("8-QAM", "FSK"):
        with pytest.raises(ValueError):
            tc.define_constellation(bad)
    for M in (4, 16, 64, 256):
        np.testing.assert_array_equal(tc.gray_labels_qam(M),
                                      jc.gray_labels_qam(M))
        np.testing.assert_array_equal(tc._bit_membership(M),
                                      jc._bit_membership(M))


def test_payload_packing_and_flips(jc):
    payload = b"parity check payload"
    for bps in (1, 2, 3, 4, 6):
        s, pad = tc.pack_payload(payload, bps)
        rs, rpad = jc.pack_payload(payload, bps)
        np.testing.assert_array_equal(s, rs)
        assert pad == rpad
        assert tc.unpack_payload(s, bps, pad) == jc.unpack_payload(s, bps,
                                                                   pad)
        assert tc.unpack_payload(s, bps, pad) == payload
    data = np.arange(4000, dtype=np.uint16)
    np.testing.assert_array_equal(
        tc.flip_bits(data, 0.05, np.random.default_rng(1)),
        jc.flip_bits(data, 0.05, np.random.default_rng(1)))
    assert tc.flip_bits("fast link", 0.1, np.random.default_rng(2)) == \
        jc.flip_bits("fast link", 0.1, np.random.default_rng(2))


def test_closed_form_error_rates(jc):
    power = fading_power(3000, 4)
    pairs = [(tc.Q(np.linspace(0, 6, 13)), jc.Q(np.linspace(0, 6, 13))),
             (tc.ber_ook(9), jc.ber_ook(9)),
             (tc.ber_ook(9, power), jc.ber_ook(9, power))]
    for M in (4, 16, 64):
        pairs += [(tc.sep_qam(M, 12), jc.sep_qam(M, 12)),
                  (tc.sep_qam(M, 12, power), jc.sep_qam(M, 12, power)),
                  (tc.ber_qam(M, 8), jc.ber_qam(M, 8)),
                  (tc.ber_qam(M, 8, power), jc.ber_qam(M, 8, power))]
    for got, ref in pairs:
        close(got, ref, 1e-12)


# ---------------------------------------------------------------------------
# fades
# ---------------------------------------------------------------------------


def _series(case):
    rng = np.random.default_rng(31)
    if case == "lognormal":
        return np.exp(rng.normal(0, 0.6, size=4000))
    I = np.ones(1000)
    for i in range(40):  # 40 fades of 3 samples
        I[i * 25 + 5: i * 25 + 8] = 0.0
    if case == "fade at t=0":
        I[:4] = 0.0
    elif case == "unterminated":
        I[-6:] = 0.0
    elif case == "few fades":
        I[200:] = 1.0
    return I


@pytest.mark.parametrize("case", ["lognormal", "regular", "fade at t=0",
                                  "unterminated", "few fades"])
def test_fades_equal_fast_tpus(jc, case):
    I = _series(case)
    for th in (0.4, 0.7, 1.0):
        for x in (I, torch.from_numpy(I)):
            got_p = tc.fade_prob(x, th)
            got_d = tc.fade_dur(x, th, dt=0.25, device="cpu")
            got_d10 = tc.fade_dur(x, th, dt=2.0, min_fades=10, device="cpu")
            np.testing.assert_array_equal(got_p, jc.fade_prob(I, th))
            np.testing.assert_array_equal(got_d, jc.fade_dur(I, th, dt=0.25))
            np.testing.assert_array_equal(
                got_d10, jc.fade_dur(I, th, dt=2.0, min_fades=10))
        below = I < th
        assert tc._fade_run_stats(torch.from_numpy(below)) == tuple(
            int(v) for v in jc._fade_run_stats(below))
    if case == "few fades":
        assert np.isnan(tc.fade_dur(I, 0.5, device="cpu"))
        assert tc.fade_dur(I, 0.5, min_fades=8, device="cpu") == 3.0


# ---------------------------------------------------------------------------
# I-Q PDFs, GMI and MI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("region", ["individual", "full"])
@pytest.mark.parametrize("M", [4, 16])
def test_histogram_counts_exactly_fast_tpus(jc, samples, M, region):
    import jax.numpy as jnp
    amp = torch.from_numpy(np.abs(samples))
    geo = tc._iq_geometry(amp, M, 32, 11, None, region == "individual",
                          torch.float64)
    pts_r, pts_i, lo_r, lo_i, dx, hi = geo[:6]
    counts = tc._histogram_counts(amp, pts_r, pts_i, lo_r, lo_i, dx, hi, 32)
    ref = jc._histogram_iq(*(jnp.asarray(t.numpy()) for t in (
        amp, pts_r, pts_i, lo_r, lo_i, dx)), hi.item(), 32, jnp.float64)
    ref = np.asarray(ref) * amp.shape[0]
    np.testing.assert_array_equal(counts.numpy(), np.round(ref))
    assert np.abs(ref - np.round(ref)).max() < 1e-9


@pytest.mark.parametrize("kw", [
    dict(region_size="individual"), dict(region_size="full"),
    dict(region_size="full", shot=True), dict(N0=0.02),
    dict(region_size="full", N0=0.5, shot=True)], ids=str)
@pytest.mark.parametrize("M", [4, 16])
def test_convolve_awgn_qam(jc, samples, M, kw):
    x = samples[:800] if kw.get("shot") else samples
    got = tc.convolve_awgn_qam(x, M, 24, 11, device="cpu", **kw)
    assert got.dtype == torch.float64 and got.shape == (M, 24, 24)
    close(got, jc.convolve_awgn_qam(x, M, 24, 11, **kw))


@pytest.mark.parametrize("kw", [dict(EsN0=6), dict(EsN0=14),
                                dict(EsN0=10, N0=0.05),
                                dict(EsN0=10, shot=True)], ids=str)
def test_gmi_mi(jc, samples, kw):
    x = samples[:800] if kw.get("shot") else samples
    for fn in ("generalised_mutual_information_qam",
               "mutual_information_qam"):
        got = getattr(tc, fn)(x, 16, 24, device="cpu", **kw)
        ref = getattr(jc, fn)(x, 16, 24, **kw)
        assert abs(got - ref) <= REL


def test_pdf_dtype_and_region_check(samples):
    assert tc.convolve_awgn_qam(samples, 4, 16, 10, dtype=np.float32,
                                device="cpu").dtype == torch.float32
    with pytest.raises(ValueError):
        tc.convolve_awgn_qam(samples, 4, 16, 10, region_size="half",
                             device="cpu")


# ---------------------------------------------------------------------------
# the modem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["OOK", "BPSK", "QPSK", "8-PSK",
                                    "16-QAM", "64-QAM"])
def test_noiseless_payload_decides_as_fast_tpus(jc, scheme):
    payload = b"hello fast-tpu, decode me!"
    power = fading_power(6, 3)
    m = tc.Modulator(power, scheme, data=payload, device="cpu")
    m.run()
    ref = jc.Modulator(power, scheme, data=payload, rng=0)
    ref.run()
    np.testing.assert_array_equal(m.recv_symbols.numpy(),
                                  np.asarray(ref.recv_symbols))
    np.testing.assert_array_equal(m.symbols.numpy(), np.asarray(ref.symbols))
    assert m.sep == ref.sep == 0.0 and m.evm == ref.evm == 0.0
    for row in m.recv_data:
        assert row.tobytes() == payload
    np.testing.assert_array_equal(m.recv_data, ref.recv_data)


def per_iteration_errors(m):
    """Per-iteration symbol error rates of a modulator's streams."""
    sym, dec = m.symbols, m.recv_symbols
    if torch.is_tensor(sym):
        return (dec != sym).double().mean(0).cpu().numpy()
    return (np.asarray(dec) != np.asarray(sym)).mean(0)


def se(x):
    return x.std(ddof=1) / np.sqrt(x.size)


@pytest.mark.parametrize("M,esn0", [(16, 12), (64, 18)])
def test_sep_against_sep_qam_at_constant_power(M, esn0):
    m = tc.Modulator(np.full(400, 2.5), f"{M}-QAM", EsN0=esn0,
                     symbols_per_iter=500, rng=5, device="cpu")
    m.run()
    p = tc.sep_qam(M, esn0)
    assert abs(m.sep - p) <= SIGMAS * np.sqrt(p * (1 - p) / 200000)


@pytest.mark.parametrize("scheme,esn0", [("16-QAM", 12), ("QPSK", 8),
                                         ("OOK", 10), ("8-PSK", 14)])
def test_sep_against_fast_tpus_modulator(jc, scheme, esn0):
    power = fading_power(1000, 8)
    m = tc.Modulator(power, scheme, EsN0=esn0, symbols_per_iter=200,
                     rng=np.random.default_rng(9), device="cpu")
    m.run()
    ref = jc.Modulator(power, scheme, EsN0=esn0, symbols_per_iter=200,
                       rng=np.random.default_rng(9))
    ref.run()
    e, r = per_iteration_errors(m), per_iteration_errors(ref)
    assert m.sep == pytest.approx(e.mean(), abs=1e-12)
    assert abs(m.sep - ref.sep) <= SIGMAS * np.hypot(se(e), se(r))
    if scheme == "16-QAM":  # the fading-averaged closed form
        p = tc.sep_qam(16, esn0, m.power.numpy())
        assert abs(m.sep - p) <= SIGMAS * se(e)


def test_lazy_streams_reproduce_run_over_chunks(monkeypatch):
    monkeypatch.setattr(tc, "_MODEM_SYMBOLS", 32 * 37)  # 14 chunks
    power = fading_power(512, 3, 0.3)
    m = tc.Modulator(power, "16-QAM", EsN0=10, symbols_per_iter=32, rng=11,
                     device="cpu")
    m.run()
    sep, evm = m.sep, m.evm
    tx = torch.as_tensor(m.constellation)[m.symbols]  # makes the streams
    assert m.symbols.shape == (32, 512)
    assert float((m.recv_symbols != m.symbols).double().mean()) == sep
    err = m.recv_signal - tx
    evm_streams = float(err.abs().mean() / torch.sqrt((tx.abs() ** 2).mean()))
    # tx here from the float64 constellation, the modem's in float32
    assert evm_streams == pytest.approx(evm, rel=1e-6)
    close(m.awgn, err, 1e-12)
    assert (m.sep, m.evm) == (sep, evm)


def test_one_pass_per_use(monkeypatch):
    """run() makes one pass over the stream and keeps none of it; the
    modulate()/demodulate() workflow makes one pass, which also gives the
    statistics; the streams come from one more pass after run()."""
    calls = {"n": 0}
    real = tc._modem_chunks

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tc, "_modem_chunks", counting)
    power = fading_power(256, 5, 0.3)
    m = tc.Modulator(power, "QPSK", EsN0=12, symbols_per_iter=16, rng=2,
                     device="cpu")
    m.run()
    assert calls["n"] == 1 and m._streams is None
    m.symbols
    assert calls["n"] == 2
    m2 = tc.Modulator(power, "QPSK", EsN0=12, symbols_per_iter=16, rng=2,
                      device="cpu")
    m2.modulate()
    m2.demodulate()
    assert m2.compute_sep() is not None and m2.compute_evm() is not None
    assert calls["n"] == 3
    assert (m2.sep, m2.evm) == (m.sep, m.evm)


def test_remodulate_clears_parity_overrides():
    power = fading_power(128, 7, 0.3)
    m = tc.Modulator(power, "QPSK", EsN0=12, symbols_per_iter=8, rng=2,
                     device="cpu")
    m.modulate()
    m.demodulate()
    custom = torch.zeros_like(m.symbols)
    m.symbols = custom
    m.recv_signal = np.ones(3)
    m.awgn = 5.0
    m.recv_symbols = None  # the modulation-None parity assignment
    assert m.symbols is custom
    assert m.recv_symbols is None
    m.modulate()
    assert m.symbols is not custom
    assert np.shape(m.recv_signal) != (3,)
    assert m.recv_symbols is None  # pre-demodulation state, not the override
    m.demodulate()
    assert m.recv_symbols is not None
    assert np.shape(m.awgn) == np.shape(m.recv_signal)


def test_power_inputs_and_generators():
    rng = np.random.default_rng(4)
    field = rng.normal(size=300) + 1j * rng.normal(size=300)
    a = tc.Modulator(field, "QPSK", EsN0=9, symbols_per_iter=20, rng=3,
                     device="cpu")
    b = tc.Modulator(torch.from_numpy(np.abs(field) ** 2), "QPSK", EsN0=9,
                     symbols_per_iter=20, rng=torch.Generator().manual_seed(3))
    assert a.device == b.device == torch.device("cpu")
    close(a.power, b.power, 1e-15)
    assert float(a.power.mean()) == pytest.approx(1.0, rel=1e-12)
    a.run()
    b.run()
    assert (a.sep, a.evm) == (b.sep, b.evm)
    none = tc.Modulator(field, None, device="cpu")
    none.run()
    assert none.sep is None and none.evm is None
    assert none.recv_signal is none.power


def test_device_defaults():
    I = torch.from_numpy(fading_power(200, 1))
    assert np.isfinite(tc.fade_dur(I, 1.0, min_fades=1))
    assert tc.convolve_awgn_qam(I, 4, 8, 10).device.type == "cpu"
    if torch.cuda.is_available():
        assert tc.Modulator(I.numpy(), "OOK").device.type == "cuda"
        return
    for call in (lambda: tc.Modulator(I.numpy(), "OOK"),
                 lambda: tc.fade_dur(I.numpy(), 1.0),
                 lambda: tc.convolve_awgn_qam(I.numpy(), 4, 8, 10),
                 lambda: tc.mutual_information_qam(I.numpy(), 4, 8, 10)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# FastFSOC
# ---------------------------------------------------------------------------


def small_params(**overrides):
    import fast_tpu_torch
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": 256, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 17, "LOGLEVEL": "WARNING", "EsN0": 8,
    })
    p.update(overrides)
    return p


@pytest.mark.parametrize("scheme", ["OOK", "BPSK", "QAM"])
def test_fastfsoc_against_fast_tpus(scheme):
    import fast_tpu
    import fast_tpu_torch
    from fast_tpu_torch.utils import fits
    sim = fast_tpu_torch.FastFSOC(small_params(MODULATION=scheme),
                                  device="cpu")
    res = sim.run()
    assert res is sim.result and np.isfinite(sim.I).all()
    m = sim.modulator
    assert m.device == torch.device("cpu") and m.symbols_per_iter == 1000
    close(m.power, sim.I / sim.I.mean(), 1e-12)
    ref = fast_tpu.FastFSOC(small_params(MODULATION=scheme, SYNTH="matmul"))
    ref.run()
    e, r = per_iteration_errors(m), per_iteration_errors(ref.modulator)
    assert m.sep == pytest.approx(e.mean(), abs=1e-12)
    assert abs(m.sep - ref.modulator.sep) <= SIGMAS * np.hypot(se(e), se(r))
    hdr = sim.make_header(sim.params)
    assert isinstance(hdr, fits.Header)
    assert hdr["MODULATION"] == scheme and hdr["EsN0"] == 8


def test_fastfsoc_coherent_field():
    import fast_tpu_torch
    sim = fast_tpu_torch.FastFSOC(small_params(
        MODULATION="16-QAM", EsN0=None, COHERENT=True, NITER=64),
        device="cpu")
    sim.run()
    field = sim.I
    assert np.iscomplexobj(field)
    # |field|^2 of the float32 field: float32 round-off
    close(sim.modulator.power, np.abs(field) ** 2 / (np.abs(field) ** 2)
          .mean(), 1e-6)
    assert sim.modulator.sep == 0.0
    assert sim.make_header(sim.params)["EsN0"] == "None"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,esn0", [("16-QAM", 12), ("8-PSK", 14),
                                         ("OOK", 10)])
def test_modem_on_card_against_cpu(cuda_device, scheme, esn0):
    power = torch.from_numpy(fading_power(4096, 8))
    stats = {}
    for dev in ("cpu", cuda_device):
        m = tc.Modulator(power.to(dev), scheme, EsN0=esn0,
                         symbols_per_iter=256, rng=7)
        assert m.device.type == torch.device(dev).type
        m.run()
        e = per_iteration_errors(m)
        assert m.sep == pytest.approx(e.mean(), abs=1e-12)
        v = (m.recv_signal - torch.as_tensor(m.constellation,
                                             device=m.device)[m.symbols])
        ev = (v.abs().double().mean(0) / np.sqrt(m.Es)).cpu().numpy()
        stats[str(dev)] = (m.sep, se(e), m.evm, se(ev))
    (s0, se0, v0, sv0), (s1, se1, v1, sv1) = stats.values()
    assert abs(s0 - s1) <= SIGMAS * np.hypot(se0, se1)
    assert abs(v0 - v1) <= SIGMAS * np.hypot(sv0, sv1)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(region_size="individual"),
                                dict(region_size="full"),
                                dict(region_size="full", shot=True)], ids=str)
def test_pdfs_on_card_against_cpu(cuda_device, samples, kw):
    x = torch.from_numpy(samples)
    got = tc.convolve_awgn_qam(x.to(cuda_device), 16, 32, 12, **kw)
    ref = tc.convolve_awgn_qam(x, 16, 32, 12, **kw)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert float((got.cpu().double() - ref).abs().max()) <= \
        1e-3 * float(ref.abs().max())
    if kw["region_size"] == "full":
        for fn in ("generalised_mutual_information_qam",
                   "mutual_information_qam"):
            g = getattr(tc, fn)(x.to(cuda_device), 16, 32, 12,
                                shot=kw.get("shot", False))
            r = getattr(tc, fn)(x, 16, 32, 12, shot=kw.get("shot", False))
            assert abs(g - r) <= 1e-3


@pytest.mark.cuda
def test_fades_on_card_equal_cpu(cuda_device):
    I = torch.from_numpy(np.exp(np.random.default_rng(12).normal(0, 0.6,
                                                                 200000)))
    for th in (0.2, 0.5, 1.0):
        assert tc._fade_run_stats((I < th).to(cuda_device)) == \
            tc._fade_run_stats(I < th)
        assert tc.fade_prob(I.to(cuda_device), th) == tc.fade_prob(I, th)
