"""The port's tooling on the CPU: profiler traces, the factor disk cache,
the H100 dossier twin and the example twins.

* ``utils.profiling.trace`` around a small ``Fast(..., device="cpu").run()``
  with ``annotate("chunk")`` writes a Chrome trace naming the region.
* ``utils.diskcache``: keys change with one byte, the dtype, the shape and
  a scalar; save/load round-trips atomically; LRU eviction; the switches
  (``FAST_TPU_TABLE_CACHE=0``, ``MIN_BYTES``); and the engine's factor
  build: a second ``SYNTH='pallas_colfac'`` init loads ``L`` instead of
  rebuilding it, bit for bit, and runs bit for bit; the card's float32
  build neither loads nor saves.
* ``scripts/torch_validate_hw.py``: its fade gates are
  ``scripts/validate_hw.py``'s, a failed row makes the exit code 1, the
  sections run on a small link, and ``main()`` returns 2 without a card.
* No file of the port, nor the dossier twin, the example twins or
  ``chip_smoke.py``, imports JAX, ``fast_tpu`` or ``__graft_entry__``.
* ``examples/torch_*.py``: each runs on the CPU at cut sizes and prints
  its JAX example's column headers; ``torch_example_config``'s dict is
  ``example_config``'s.
"""

import glob
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch.utils import diskcache, profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_params(**overrides):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": 256, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "DSUBAP": 0.1, "H_TURB": h,
        "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 3,
        "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def test_nothing_of_the_port_imports_jax():
    files = (glob.glob(os.path.join(REPO, "fast_tpu_torch", "**", "*.py"),
                       recursive=True)
             + glob.glob(os.path.join(REPO, "examples", "torch_*.py"))
             + [os.path.join(REPO, "scripts", "torch_validate_hw.py"),
                os.path.join(REPO, "chip_smoke.py")])
    bad = re.compile(r"^\s*(import|from)\s+(jax|fast_tpu|__graft_entry__)\b",
                     re.M)
    assert len(files) > 40
    for path in files:
        with open(path) as f:
            assert not bad.search(f.read()), path


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_trace_names_the_annotated_region(tmp_path):
    sim = fast_tpu_torch.Fast(small_params(NITER=64), device="cpu")
    with profiling.trace(tmp_path):
        with profiling.annotate("chunk"):
            res = sim.run()
    assert np.isfinite(res.power).all()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert "chunk" in {e.get("name") for e in events}


# ---------------------------------------------------------------------------
# disk cache
# ---------------------------------------------------------------------------


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """The cache on, in ``tmp_path``, taking tables of any size."""
    monkeypatch.setenv("FAST_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("FAST_TPU_TABLE_CACHE", "1")
    monkeypatch.setattr(diskcache, "MIN_BYTES", 0)
    return tmp_path


def test_key_changes_with_content_dtype_shape_and_scalars():
    a = np.arange(12, dtype=np.float64)
    k = diskcache.table_key("t", (a,), (1.0,))
    assert k.startswith("t-") and k == diskcache.table_key("t", (a.copy(),),
                                                           (1.0,))
    b = a.copy()
    b.view(np.uint8)[5] ^= 1  # one byte
    others = [diskcache.table_key("t", (b,), (1.0,)),
              diskcache.table_key("t", (a.astype(np.float32),), (1.0,)),
              diskcache.table_key("t", (a.reshape(3, 4),), (1.0,)),
              diskcache.table_key("t", (a,), (1.5,)),
              diskcache.table_key("u", (a,), (1.0,))]
    assert len({k, *others}) == 1 + len(others)


def test_save_load_round_trip_leaves_no_tmp_file(cache):
    arr = (np.arange(64) + 1j * np.arange(64)).astype(np.complex64)
    key = diskcache.table_key("torch-test", (arr,))
    assert diskcache.load(key) is None
    diskcache.save(key, arr)
    got = diskcache.load(key)
    assert got.dtype == arr.dtype and np.array_equal(got, arr)
    assert os.listdir(cache) == [key + ".npy"]


def test_corrupt_file_is_dropped(cache):
    key = diskcache.table_key("torch-test", (np.zeros(3),))
    (cache / (key + ".npy")).write_bytes(b"not a table")
    assert diskcache.load(key) is None
    assert os.listdir(cache) == []


def test_lru_eviction(cache, monkeypatch):
    arrs = [np.full(1024, i, np.float64) for i in range(3)]  # 8 kB each
    keys = [diskcache.table_key("torch-test", (a,)) for a in arrs]
    monkeypatch.setattr(diskcache, "MAX_BYTES", 2 * 8192 + 1024)
    diskcache.save(keys[0], arrs[0])
    diskcache.save(keys[1], arrs[1])
    p0, p1 = (cache / (k + ".npy") for k in keys[:2])
    os.utime(p0, (1, 1))
    os.utime(p1, (2, 2))
    assert diskcache.load(keys[0]) is not None  # touched: now the newest
    diskcache.save(keys[2], arrs[2])
    assert sorted(os.listdir(cache)) == sorted(k + ".npy"
                                               for k in (keys[0], keys[2]))


def test_switch_off_and_min_bytes(cache, monkeypatch):
    arr = np.ones(16)
    key = diskcache.table_key("torch-test", (arr,))
    monkeypatch.setenv("FAST_TPU_TABLE_CACHE", "0")
    assert not diskcache.enabled()
    diskcache.save(key, arr)
    assert os.listdir(cache) == []
    monkeypatch.setenv("FAST_TPU_TABLE_CACHE", "1")
    monkeypatch.setattr(diskcache, "MIN_BYTES", arr.nbytes + 1)
    diskcache.save(key, arr)  # under MIN_BYTES
    assert os.listdir(cache) == []
    monkeypatch.setattr(diskcache, "MIN_BYTES", 0)
    diskcache.save(key, arr)
    monkeypatch.setenv("FAST_TPU_TABLE_CACHE", "0")
    assert diskcache.load(key) is None  # present, but the cache is off


def test_default_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("FAST_TPU_CACHE_DIR", raising=False)
    assert diskcache.cache_dir() == os.path.expanduser(
        "~/.cache/fast_tpu_torch/tables")


def test_second_init_loads_the_factors(cache, monkeypatch):
    from fast_tpu_torch import synthesis
    builds, loads = [], []
    build, load = synthesis.column_factors, diskcache.load
    monkeypatch.setattr(synthesis, "column_factors",
                        lambda *a, **k: builds.append(1) or build(*a, **k))
    monkeypatch.setattr(diskcache, "load",
                        lambda key: loads.append(load(key)) or loads[-1])
    p = small_params(SYNTH="pallas_colfac")
    a = fast_tpu_torch.Fast(dict(p), device="cpu")
    assert len(builds) == 1 and loads == [None]
    (name,) = os.listdir(cache)
    assert name.startswith("torch-colfac-f64-")
    b = fast_tpu_torch.Fast(dict(p), device="cpu")
    assert len(builds) == 1 and loads[1] is not None
    assert b.tables["L"].dtype == torch.complex64
    assert torch.equal(a.tables["L"], b.tables["L"])
    assert np.array_equal(np.asarray(a.run().power),
                          np.asarray(b.run().power))


def test_card_build_skips_the_cache(cache, monkeypatch):
    """The card's float32 branch, run here on the CPU: it builds its
    factors every time and touches no cache file."""
    from fast_tpu_torch import engine, synthesis
    sim = fast_tpu_torch.Fast(small_params(SYNTH="colfac", NITER=256),
                              device="cpu")
    build = synthesis.column_factors_device
    builds, loads = [], []
    monkeypatch.setattr(
        engine.synthesis, "column_factors_device",
        lambda s, df, W, device, jitter: builds.append(jitter)
        or build(s, df, W, "cpu", jitter=jitter))
    monkeypatch.setattr(diskcache, "load",
                        lambda key: loads.append(key))
    sim.device = torch.device("cuda")  # the card's branch, run here
    W64 = synthesis.pruned_ift2_matrix(sim.Npxls, *sim.pup_crop,
                                       dtype=np.complex128)
    saved = os.listdir(cache)  # the CPU init's float64 stack
    L = sim._column_factors(W64)
    L2 = sim._column_factors(W64)
    assert builds == [synthesis.JITTER_F32] * 2 and loads == []
    assert os.listdir(cache) == saved
    assert L.dtype == np.complex64 and np.array_equal(L, L2)


# ---------------------------------------------------------------------------
# the dossier twin
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dossier():
    return _load("scripts/torch_validate_hw.py", "torch_validate_hw")


def test_fade_gates_are_validate_hws(dossier):
    ref = _load("scripts/validate_hw.py", "validate_hw")
    rng = np.random.default_rng(4)
    for n in (1000, 100_000, 2 ** 17):
        x = rng.gamma(4.0, size=n)
        assert dossier.fade_quantiles(x) == ref.fade_quantiles(x)
    for nq in (0, 8, 49.9, 50, 499, 500, 4999, 5000, 84_000):
        assert dossier.fade_tol(nq) == ref.fade_tol(nq)
    assert dossier.sizes(quick=True) == dict(n_ks=2 ** 14, n_fold=2 ** 16,
                                             n_fade=2 ** 17, n_steps=2 ** 12)
    assert dossier.sizes(full=True)["n_fade"] == 2 ** 23


def test_lag1_gates_cover_the_rows_lengths(dossier):
    """Each kernel-against-'fft' row's two-seed lag-1 gate is 5 sd of the
    difference of two values at the row's --quick and default lengths."""
    for quick in (True, False):
        n = dossier.sizes(quick=quick)["n_steps"]
        for kernel, steps in (("K4", 4 * n), ("K5", n // 2)):
            assert dossier.lag1_limit(kernel, steps) == pytest.approx(
                5 * np.sqrt(2) * dossier.LAG1_SD[kernel, steps])
    assert len(dossier.LAG1_SD) == 4


def test_a_failed_row_fails_the_dossier(dossier):
    d = dossier.Dossier("cpu")
    d.record("iid", "a", "ok", True)
    d.record("temporal", "rate", "1 steps/s", None)
    assert d.checks() == (1, 1) and d.summary(0.0) == 0
    d.record("fade", "b", "off", False)
    assert d.checks() == (1, 2) and d.summary(0.0) == 1


def test_sections_run_on_a_small_link(dossier, monkeypatch):
    """The fold and scan sections on the 64^2 link, the plain versions on
    the CPU: every row recorded; the KS row of K1 against K3 passes; each
    mean row's KS passes and it fails only on |dmean|. At n=128 the mean's
    standard error (~0.01) exceeds the |dmean| gates (0.005, 0.01), which
    are sized for 2^16 and more draws, so those rows pass or fail by seed
    scatter here. The warm-repeat row times the CPU: only its presence is
    held."""
    flagship = dossier.flagship_params
    monkeypatch.setattr(dossier, "flagship_params", lambda nlayers=4, **kw:
                        flagship(nlayers, **dict(kw, NPXLS=64, DX=0.02)))
    d = dossier.Dossier("cpu")
    d.run_sections(n_ks=128, n_fold=128, n_fade=0, n_steps=0,
                   sections=("fold", "scan"))
    names = [r[1] for r in d.results]
    assert names == ["mixed-fold vs gauss (n=128)",
                     "merged vs split layout (same RV family)",
                     "zenith 40.0", "zenith 55.0",
                     "warm repeat (device-resident tables)"]
    rows = {r[1]: r for r in d.results}
    assert rows["merged vs split layout (same RV family)"][3] is True
    for name, gate in (("mixed-fold vs gauss (n=128)", dossier.DMEAN / 2),
                       ("zenith 40.0", dossier.DMEAN),
                       ("zenith 55.0", dossier.DMEAN)):
        p, dm = map(float, re.match(r"KS p=(\S+) dmean=(\S+)$",
                                    rows[name][2]).groups())
        assert p > dossier.KS_P and rows[name][3] == (dm < gate), name
    assert rows["warm repeat (device-resident tables)"][3] is not None
    npass, total = d.checks()
    assert total == 5 and d.summary(0.0) == (0 if npass == total else 1)


def test_main_needs_a_card(dossier, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dossier.main(["--quick"]) == 2
    assert "no CUDA device" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the example twins
# ---------------------------------------------------------------------------

TWINS = {
    "link_budget_study": (dict(npxls=96, niter=256),
                          ["zenith", "mean dBm", "scint idx", "1% fade dB",
                           "r0_los cm"]),
    "long_temporal_ar": (dict(npxls=64, niter=128, nchunks=2),
                         ["grid:", "AR mode-survival alpha per layer",
                          "steps/s", "fade probability below 0.5*mean",
                          "mean fade duration"]),
    "modem_gmi_study": (dict(npxls=96, niter=200),
                        ["scheme", "EsN0", "SEP(meas)", "BER(analytic)",
                         "GMI [bit/sym]", "16-QAM"]),
    "orbit_sweep": (dict(npxls=96, niter=256),
                    ["t [s]", "elev", "range km", 'PAA "', "mean dBm",
                     "scint"]),
    "orbit_temporal_scan": (dict(npxls=96, niter=24),
                            ["t[s]  elev[deg]  mean[dBm]   SI      "
                             "P(fade<-3dB)  mean fade dur[ms]"]),
    "temporal_series": (dict(niter=200),
                        ["FAST result statistics",
                         "fade probability (<80% mean)",
                         "mean fade duration",
                         "intensity correlation time (1/e)"]),
    "example_config": (dict(NITER=20, NCHUNKS=2),
                       ["FAST result statistics"]),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_example_twin_runs_on_the_cpu(name, capsys):
    kw, headers = TWINS[name]
    twin = _load(f"examples/torch_{name}.py", f"torch_{name}")
    twin.main("cpu", **kw)
    out = capsys.readouterr().out
    for h in headers:
        assert h in out, (h, out)
    assert "nan" not in out.split("\n")[0]


def test_example_config_twin_is_example_configs():
    ref = _load("examples/example_config.py", "example_config").p
    got = _load("examples/torch_example_config.py", "torch_example_config").p
    assert list(got) == list(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    sim = fast_tpu_torch.Fast(os.path.join(REPO, "examples",
                                           "torch_example_config.py"),
                              device="cpu")
    assert sim.params["SEED"] == 1234 and sim.temporal
