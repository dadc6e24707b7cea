"""The iid slice of fast_tpu_torch against fast_tpu, on the CPU.

Small config: the flagship link at NPXLS=64, DX=0.02 (P=42).

* Analytic fields agree to float64 round-off (1e-10 relative).
* One K2 chunk on the JAX package's own tables (through
  ``tables_from_numpy``) with zero random bits equals the TPU kernel run
  in the Pallas interpreter, whose PRNG yields zero bits (1e-3, float32
  products in another order).
* Monte Carlo runs agree in distribution, never bit for bit (different
  generators): mean normalised power within 5 combined standard errors,
  scintillation index within 20% (its standard error at 4096 draws is a
  few percent, and the two runs are independent).
"""

import numpy as np
import pytest
import torch

import fast_tpu
import fast_tpu_torch
from fast_tpu.ops import pallas_synth
from fast_tpu_torch.engine import resolve_synth
from fast_tpu_torch.interop import tables_from_numpy
from fast_tpu_torch.ops import synth_detect as sd

torch.set_num_threads(1)

NITER = 4096


def small_params(**overrides):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": NITER, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 11, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


@pytest.fixture(scope="module")
def jax_sim():
    sim = fast_tpu.Fast(small_params(SYNTH="matmul"))
    sim.run()
    return sim


@pytest.fixture(scope="module")
def port_run():
    sim = fast_tpu_torch.Fast(small_params(), device="cpu")
    before = sd.synth_detect.LAUNCHES
    res = sim.run()
    assert sd.synth_detect.LAUNCHES == before  # CPU: plain version only
    return sim, res


@pytest.mark.parametrize("name", [
    "powerspec", "logamp_powerspec", "powerspec_per_layer",
    "turb_powerspec", "alias_powerspec", "G_ao", "logamp_var", "phs_var",
    "phs_var_weights", "aniso_servo_error", "alias_error", "noise_error",
    "fitting_error", "diffraction_limit", "W0", "_norm"])
def test_fields_match(jax_sim, port_run, name):
    ref = np.asarray(getattr(jax_sim, name), np.float64)
    got = np.asarray(getattr(port_run[0], name), np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-10 * max(np.abs(ref).max(), 1e-300)


def jax_tables(sim):
    return dict(
        powerspec=np.asarray(sim.powerspec),
        pupil_mode=np.asarray(sim.pupil * sim.pupil_mode),
        W_pruned=np.asarray(sim._W_pruned), df=float(sim.freq.main.df),
        dx=sim.dx, norm=sim._norm, logamp_var=sim.logamp_var,
        diffraction_limit=sim.diffraction_limit, pup_crop=sim.pup_crop)


@pytest.mark.parametrize("noise", ["gauss", "mixed"])
def test_chunk_on_jax_tables_matches_pallas_interpret(jax_sim, noise):
    T = tables_from_numpy(jax_tables(jax_sim))
    nbatch = 4
    c = np.asarray(pallas_synth.fused_synthesis_detect(
        1, jax_sim._sqrt_psd, float(jax_sim.freq.main.df), nbatch,
        jax_sim._W_pruned, jax_sim._pm, interpret=True, precision="highest",
        noise=noise))
    ref = (c[:, 0] + 1j * c[:, 1]) * (jax_sim.dx ** 2 / jax_sim._norm)
    N = jax_sim.Npxls
    zero = torch.zeros((nbatch, N, N), dtype=torch.int64)
    s = sd.synth_detect_reference(
        0, T["s_t"], T["wr"], T["wi"], T["pm_t"], nbatch,
        mix=T["mix"] if noise == "mixed" else None, bits=(zero, zero))
    got = (torch.complex(s[:, 0], s[:, 1])
           * (float(T["dx"]) ** 2 / float(T["norm"]))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("args,synth", [
    (("auto", torch.float32, CUDA, 256, 82), "pallas_fused"),
    (("auto", torch.float32, CUDA, 102, 102), "pallas_fused"),
    (("pallas_fused", torch.float32, CUDA, 4096, 128), "pallas_fused"),
    (("auto", torch.float32, CPU, 1024, 402), "pallas_fused"),
    (("auto", torch.float32, CUDA, 1024, 402), "pallas_fused"),
    (("auto", torch.float64, CUDA, 1024, 402), "fft"),
    (("matmul", torch.float32, CUDA, 1024, 402), "matmul"),
])
def test_resolve_synth(args, synth):
    assert resolve_synth(*args) == synth


@pytest.mark.parametrize("args", [
    ("pallas_fused", torch.float32, CUDA, 4096, 255 * 128 + 1),
])
def test_resolve_synth_refuses_what_the_kernel_does_not_take(args):
    """On the card 'auto' never falls back to another path: a shape the
    kernel does not take (a pupil over the 32640 px of 255 tiles) raises,
    naming the stock-op path."""
    with pytest.raises(ValueError, match="SYNTH='matmul'"):
        resolve_synth(*args)


def test_tables_carry_the_engine_tables(jax_sim, port_run):
    T = tables_from_numpy(jax_tables(jax_sim))
    for k in ("s_t", "wr", "wi", "pm_t", "mix", "sqrt_psd", "pm", "W"):
        torch.testing.assert_close(port_run[0].tables[k], T[k], rtol=1e-6,
                                   atol=0)
    assert tuple(T["pup_crop"].tolist()) == jax_sim.pup_crop


def in_distribution(r, ref, si_rel=0.2):
    r, ref = np.asarray(r, np.float64), np.asarray(ref, np.float64)
    assert r.shape == ref.shape and np.isfinite(r).all()
    se = np.hypot(r.std(), ref.std()) / np.sqrt(r.size)
    assert abs(r.mean() - ref.mean()) <= 5 * se
    si, si_ref = r.var() / r.mean() ** 2, ref.var() / ref.mean() ** 2
    assert abs(si - si_ref) <= si_rel * si_ref


def test_auto_run_in_distribution(jax_sim, port_run):
    sim, res = port_run
    assert sim._synth == "pallas_fused"
    in_distribution(res.power / res._dl,
                    jax_sim.result.power / jax_sim.diffraction_limit)
    assert abs(res.avg_power_dBm - jax_sim.result.avg_power_dBm) < 0.1


@pytest.mark.parametrize("overrides,synth", [
    ({"MC_NOISE": "gauss", "NITER": 2048}, "pallas_fused"),
    ({"SYNTH": "matmul"}, "matmul"),
    ({"DTYPE": "float64"}, "fft"),
])
def test_run_in_distribution(jax_sim, overrides, synth):
    sim = fast_tpu_torch.Fast(small_params(**overrides), device="cpu")
    assert sim._synth == synth
    res = sim.run()
    ref = jax_sim.result.power / jax_sim.diffraction_limit
    in_distribution(res.power / res._dl, ref[:sim.Niter])
    assert abs(res.avg_power_dBm - jax_sim.result.avg_power_dBm) < 0.1


def test_run_is_reproducible_and_logamp_matches():
    sim = fast_tpu_torch.Fast(small_params(NITER=256), device="cpu")
    a = sim.run()
    si_dev = a.scintillation_index
    chi = sim.logamp
    assert chi.shape == (256,)
    assert abs(chi.var() / sim.logamp_var - 1) < 0.3
    pa = np.array(a.power)
    assert abs(si_dev - a.scintillation_index) <= 1e-6 * si_dev
    np.testing.assert_array_equal(pa, sim.run().power)
    sim.set_seed(12)
    assert not np.array_equal(pa, sim.run().power)


def test_coherent_run(jax_sim):
    sim = fast_tpu_torch.Fast(small_params(COHERENT=True, SYNTH="matmul"),
                              device="cpu")
    res = sim.run()
    assert np.iscomplexobj(res._r) and res._r.shape == (NITER,)
    in_distribution(np.abs(res._r) ** 2,
                    jax_sim.result.power / jax_sim.diffraction_limit)


def test_saved_file_loads_in_fast_tpu(port_run, tmp_path):
    sim, res = port_run
    fname = str(tmp_path / "port.fits")
    sim.save(fname)
    back = fast_tpu.load(fname)
    np.testing.assert_allclose(back.power, res.power, rtol=1e-12)
    assert back.hdr["SEED"] == 11 and back.hdr["NITER"] == NITER
    own = fast_tpu_torch.load(fname)
    np.testing.assert_allclose(own.power, res.power, rtol=1e-12)
