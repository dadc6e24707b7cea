"""The check against faults planted under the timed path, and the
control: each comes out not correct. Whole runs of the tiny cells of
:mod:`perfbench.tests.tiny` on the CPU; the chip check is skipped
(``device="cpu"``), everything else is a run's."""

import numpy as np
import pytest
import torch

from fast_tpu_torch import engine
from fast_tpu_torch.ops import ar_flow
from perfbench import check, control, harness, run
from perfbench.reference import plain
from perfbench.tests import tiny

torch.set_num_threads(1)
SEED = 2 ** 31 + 1451


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root, base = tiny.make(tmp_path_factory.mktemp("bench"))
    return harness.Spec(root=root, base=base)


def _stream_not_advanced(mp):
    orig = engine.chunk_couplings
    mp.setattr(engine, "chunk_couplings",
               lambda *a, **kw: orig(*a, **{**kw, "stream": 0}))


def _state_unchanged(mp):
    orig = ar_flow.select

    def select(nlayers):
        kernel = orig(nlayers)
        return lambda seed, a, *r, **kw: (kernel(seed, a, *r, **kw)[0], a)
    mp.setattr(ar_flow, "select", select)


def _half_batch(mp):
    orig = engine._moments
    mp.setattr(engine, "_moments", lambda out: orig(out[:out.shape[0] // 2]))


def _altered_iid(mp):
    orig = engine.chunk_couplings

    def chunk(*a, **kw):
        c = orig(*a, **kw)
        return c * 1.01 if kw["stream"] == 1 else c
    mp.setattr(engine, "chunk_couplings", chunk)


def _altered_temporal(mp):
    orig = ar_flow.select

    def select(nlayers):
        kernel = orig(nlayers)

        def k(*a, **kw):
            c, s = kernel(*a, **kw)
            return (c * 1.01 if kw["step0"] else c), s
        return k
    mp.setattr(ar_flow, "select", select)


def _altered_last_chunk(mp):
    """The AR couplings of the last chunk of a run altered, the earlier
    chunks sound."""
    orig = ar_flow.select

    def select(nlayers):
        kernel = orig(nlayers)

        def k(*a, **kw):
            c, s = kernel(*a, **kw)
            return (c * 1.01 if kw["step0"] == 192 else c), s
        return k
    mp.setattr(ar_flow, "select", select)


FAULTS = [("tiny.tiny_iid", _stream_not_advanced),
          ("tiny.tiny_temporal", _state_unchanged),
          ("tiny.tiny_iid", _half_batch), ("tiny.tiny_temporal", _half_batch),
          ("tiny.tiny_sweep", _half_batch),
          ("tiny.tiny_iid", _altered_iid),
          ("tiny.tiny_temporal", _altered_temporal),
          ("tiny.tiny_temporal", _altered_last_chunk),
          ("tiny.tiny_sweep", _altered_iid)]


@pytest.mark.parametrize("cell, fault", FAULTS,
                         ids=[f"{c.split('_', 1)[1]}-{f.__name__[1:]}"
                              for c, f in FAULTS])
def test_fault_comes_out_not_correct(spec, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run.drive(cell, SEED, 0.2, False, spec=spec, device="cpu")
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_comes_out_not_correct(spec, cell):
    [r] = control.readings(cell, [SEED], spec=spec, device="cpu")
    assert r["power_gap"] > tiny.LIMITS["power_gap"]
    assert r["moments_gap"] > tiny.LIMITS["moments_gap"]
    assert r["program_power_gap"] < tiny.LIMITS["power_gap"]


def test_philox_copy_gives_the_programs_bits():
    from fast_tpu_torch.ops import synth_detect as sd
    e = torch.arange(4096, dtype=torch.int64)[None, :]
    d = torch.arange(3, dtype=torch.int64)[:, None]
    z = torch.zeros((), dtype=torch.int64)
    k0, k1 = plain.key(2 ** 63 - 12345)
    want = sd.philox4x32_10(e, d, z + 7, z, k0, k1)
    got = plain.philox4x32_10(e, d, z + 7, z, k0, k1)
    for w, g in zip(want, got):
        assert torch.equal(w, g)


def test_sample_covers_every_chunk():
    [(r, picks)] = check.sample({"runs": 1, "draws_per_chunk": 4}, 5, 3, 8,
                                256, False)
    assert 0 <= r < 3 and len(picks) == 8 * 4 * 2
    assert set(picks // 32) == set(range(8))
    assert np.array_equal(np.sort(picks % 32 % 16)[::2],
                          np.sort(picks % 32 % 16)[1::2])


def test_temporal_sample_covers_every_chunk_and_its_ends():
    [(r, picks)] = check.sample({"runs": 1, "steps_per_chunk": 5}, 5, 3, 16,
                                65536, True)
    B = 4096
    assert set(picks // B) == set(range(16))
    assert {0, B - 1, B, 65535} <= set(picks.tolist())
    assert np.array_equal(picks, np.unique(picks)) and len(picks) <= 16 * 7


def test_reference_ar_powers_at_picks_are_the_series(spec):
    """The reference's steps at scattered picks equal the same steps of
    its series from the start."""
    w = spec.cell("tiny.tiny_temporal")
    params = harness.run_params(spec.config(w["config"]),
                                spec.traffic(w["traffic"]))
    from perfbench.reference.setup.host import HostSetup
    setup = HostSetup(params)
    every = plain.ar_powers(setup, SEED, np.arange(200))
    picks = np.array([0, 3, 63, 64, 130, 199])
    assert np.array_equal(plain.ar_powers(setup, SEED, picks), every[picks])
