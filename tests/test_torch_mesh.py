"""The multi-device layer of fast_tpu_torch (``parallel.mesh``, scans past
the (1, 1) mesh, ``parallel.dryrun``) against fast_tpu and the serial
runs, on the CPU: one spawn of 4 gloo ranks runs every case through the
dryrun twin (``dryrun.run_cases``), each rank writing its series to a
temporary directory; the JAX side runs on the 8 virtual CPU devices of
``tests/conftest.py``.

* ``sharded_moments`` of seeded numpy values against
  ``fast_tpu.parallel.sharded_moments`` on ``make_mesh(8)``: the k-th
  moments within 1e-5 of the mean of |x|^k (JAX sums in float32, so a
  relative limit on a mean near zero would test its round-off).
* ``run_sharded`` with ``'pallas_fused'`` (K2) and ``'pallas_colfac'``
  (K1, and K3 at a 136 px pupil), their plain versions here, equals
  ``Fast(NCHUNKS x 4).run()`` bit
  for bit, and a repeated call gives the same series; with ``'matmul'``
  its mean is within 5 combined standard errors of
  ``fast_tpu.parallel.run_sharded`` on 8 devices (JAX's own check,
  ``tests/test_sharding.py``). JAX's divisibility and even-batch messages
  are raised, and ``'pallas'`` (K7) is refused as the scan refuses it.
* Temporal: the screens route equals the serial run (rtol 2e-3); the
  alpha = 1 AR windows, jumped by their float64 phasor power, equal the
  serial kernel route (rtol 5e-3), also through the streamed kernel's
  plain version (16 layers); the layer-sharded boiling series equals the
  serial SYNTH='fft' route within 2e-3 and its mean is within |log
  ratio| < 0.7 of fast_tpu's layer-sharded run; an indivisible layer
  count raises "divisible".
* Scans: a (2, 2) iid scan through K2's plain version equals the (1, 1)
  scan with NCHUNKS doubled, and a (4, 1) AR scan through K6's plain
  version equals the (1, 1) scan, bit for bit; the JAX scan's messages
  for a bad mesh are raised.
* Every rank holds the same gathered series; the dryrun twin passes on 4
  ranks; a mesh larger than the world, or a card without one, raises.
* On the card: ``make_mesh()`` is an NCCL world of one rank on the card,
  and ``run_sharded`` through K2 and K4 there equals ``run()`` bit for
  bit.

The card-only cases run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_mesh.py -m cuda
"""

import threading

import numpy as np
import pytest
import torch

import fast_tpu_torch
from fast_tpu_torch import parallel
from fast_tpu_torch.parallel import dryrun

torch.set_num_threads(1)

RANKS = 4
SEED = 21


def params(nlayers=4, **overrides):
    """The flagship link at NPXLS=64, DX=0.02 (a 42 px pupil)."""
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(nlayers)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": 64, "DX": 0.02, "NITER": 1024, "NCHUNKS": 1,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.linspace(0.0, 360.0, nlayers,
                                               endpoint=False),
        "SEED": SEED, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


TEMPORAL = dict(TEMPORAL=True, DT=0.001, NCHUNKS=4)
SCREENS = dict(TEMPORAL, TEMPORAL_SYNTH="screens", NITER=160)
AR1 = dict(TEMPORAL, TEMPORAL_SYNTH="ar", TEMPORAL_ALPHA=1.0, NITER=160)
BOILING = dict(TEMPORAL, TEMPORAL_SYNTH="ar", TEMPORAL_ALPHA=0.9, NITER=160)
AR_SCAN = dict(TEMPORAL, TEMPORAL_SYNTH="ar", TEMPORAL_ALPHA=0.98,
               NITER=40)
# a 136 px pupil: 'pallas_colfac' is K3, the split layout
SPLIT = dict(NPXLS=160, DX=0.006, SYNTH="pallas_colfac", NITER=16)
ZENITHS = [30.0, 40.0, 50.0, 60.0]
VALUES = np.random.default_rng(0).normal(size=8000).astype(np.float32)
# the time-sharded cases: (layers, overrides, rtol against the serial run)
TIME_SHARDED = {"screens": (4, SCREENS, 2e-3), "ar1": (4, AR1, 5e-3),
                "ar1_16": (16, dict(AR1, NITER=40), 5e-3)}


def scan_sims(**overrides):
    return {"list": [params(ZENITH_ANGLE=z, **overrides) for z in ZENITHS]}


CASES = [
    {"name": "moments", "kind": "moments", "values": VALUES},
    {"name": "fused", "kind": "run", "repeat": 2,
     "params": params(SYNTH="pallas_fused", NITER=512)},
    {"name": "colfac", "kind": "run",
     "params": params(SYNTH="pallas_colfac", NITER=512)},
    {"name": "split", "kind": "run", "params": params(**SPLIT)},
    {"name": "matmul", "kind": "run",
     "params": params(SYNTH="matmul", NITER=3200, NCHUNKS=2, SEED=5)},
    {"name": "indivisible", "kind": "run",
     "params": params(NITER=100, NCHUNKS=10),
     "raises": ("ValueError", "NITER (100) must be divisible by "
                              "n_devices*NCHUNKS (4*10)")},
    {"name": "odd", "kind": "run", "params": params(NITER=24, NCHUNKS=2),
     "raises": ("ValueError", "per-device chunk batch must be even")},
    {"name": "k7", "kind": "run", "params": params(SYNTH="pallas", NITER=8),
     "raises": ("NotImplementedError", "'pallas' kernel is not shardable")},
] + [{"name": name, "kind": "run", "params": params(nl, **o)}
     for name, (nl, o, _) in TIME_SHARDED.items()] + [
    {"name": "layers", "kind": "run", "params": params(**BOILING)},
    {"name": "layers_6", "kind": "run", "params": params(6, **BOILING),
     "raises": ("ValueError", "layer sharding needs nlayers (6) divisible "
                              "by n_devices (4)")},
    {"name": "scan22", "kind": "scan", "shape": (2, 2), "seed": 7,
     "sims": scan_sims(SYNTH="pallas_fused", NITER=256)},
    {"name": "scan41", "kind": "scan", "shape": (4, 1), "seed": 9,
     "sims": scan_sims(**AR_SCAN)},
    {"name": "scan_mc", "kind": "scan", "shape": (2, 2),
     "sims": scan_sims(**dict(AR_SCAN, NITER=8)),
     "raises": ("ValueError", "temporal scan sharding needs an (n_scan, 1) "
                              "mesh")},
    {"name": "scan_len", "kind": "scan", "shape": (4, 1),
     "sims": {"list": [params(NITER=8)] * 3},
     "raises": ("ValueError", "len(sims) (3) must divide by the scan mesh "
                              "dimension (4)")},
    {"name": "scan_niter", "kind": "scan", "shape": (1, 4),
     "sims": {"list": [params(NITER=12, NCHUNKS=2)]},
     "raises": ("ValueError", "NITER (12) must be divisible by n_mc*NCHUNKS "
                              "(4*2)")},
] + dryrun.dryrun_cases(RANKS)


def serial(nlayers=4, **overrides):
    return np.asarray(fast_tpu_torch.Fast(params(nlayers, **overrides),
                                          device="cpu").run().power)


def one_device_scan(sims, seed):
    with parallel.make_scan_mesh(1, 1, ["cpu"]) as mesh:
        return [np.asarray(r.power) for r in parallel.run_scan_sharded(
            [fast_tpu_torch.Fast(p, device="cpu") for p in sims["list"]],
            mesh, seed=seed)]


def references():
    """The serial runs, the (1, 1) scans and the JAX package's sharded runs
    the ranks' series are held against."""
    import fast_tpu
    from fast_tpu import parallel as jpar
    ref = {
        "fused": serial(SYNTH="pallas_fused", NITER=512, NCHUNKS=RANKS),
        "colfac": serial(SYNTH="pallas_colfac", NITER=512, NCHUNKS=RANKS),
        "split": serial(**dict(SPLIT, NCHUNKS=RANKS)),
        "layers": serial(**dict(BOILING, SYNTH="fft")),
        "scan22": one_device_scan(
            scan_sims(SYNTH="pallas_fused", NITER=256, NCHUNKS=2), 7),
        "scan41": one_device_scan(scan_sims(**AR_SCAN), 9),
        "moments_jax": np.asarray(jpar.sharded_moments(
            VALUES, mesh=jpar.make_mesh(8))),
        "matmul_jax": np.asarray(jpar.run_sharded(
            fast_tpu.Fast(params(SYNTH="matmul", NITER=3200, NCHUNKS=2,
                                 SEED=5)), mesh=jpar.make_mesh(8)).power),
        "layers_jax": np.asarray(jpar.run_sharded(
            fast_tpu.Fast(params(**BOILING)), mesh=jpar.make_mesh(4)).power),
    }
    for name, (nl, o, _) in TIME_SHARDED.items():
        ref[name] = serial(nl, **o)
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on 4 spawned gloo ranks (each rank's report and arrays)
    and, computed meanwhile in this process, the references."""
    outdir = tmp_path_factory.mktemp("mesh")
    spawned = {}

    def ranks():
        try:
            spawned["reports"] = dryrun.spawn(
                dryrun.run_cases, RANKS, CASES, str(outdir), timeout=300)
        except RuntimeError as e:
            spawned["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        ref = references()
    finally:
        thread.join()
    if "error" in spawned:
        raise spawned["error"]
    return spawned["reports"], dryrun.load_arrays(outdir, RANKS), ref


def sharded(world, name):
    return world[1][0][f"{name}.0"]


def test_every_rank_holds_the_same_series(world):
    reports, arrays, _ = world
    assert [r["device"] for r in reports] == ["cpu"] * RANKS
    for a in arrays[1:]:
        assert a.keys() == arrays[0].keys()
        for k, v in arrays[0].items():
            np.testing.assert_array_equal(a[k], v)


def test_sharded_moments_match_jax(world):
    got, ref = world[1][0]["moments"], world[2]["moments_jax"]
    x = VALUES.astype(np.float64)
    scale = np.array([np.mean(np.abs(x) ** k) for k in (1, 2, 3, 4)])
    assert got.dtype == np.float64
    assert (np.abs(got - ref) <= 1e-5 * scale).all(), (got, ref)
    exact = np.array([np.mean(x ** k) for k in (1, 2, 3, 4)])
    np.testing.assert_allclose(got, exact, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", ["fused", "colfac", "split"])
def test_kernel_routes_equal_the_serial_run(world, name):
    """A 4-rank run through K2 ('pallas_fused'), K1 or, at a 136 px pupil,
    K3 ('pallas_colfac'), their plain versions here, is
    ``Fast(NCHUNKS=4 * NCHUNKS).run()`` bit
    for bit: the same Philox streams (the global chunk index) and the same
    log-amplitude window on every rank; a repeated call repeats it."""
    ref = world[2][name]
    np.testing.assert_array_equal(sharded(world, name), ref)
    if name == "fused":
        np.testing.assert_array_equal(world[1][0]["fused.1"], ref)


def test_matmul_route_agrees_with_jax(world):
    got, ref = sharded(world, "matmul"), world[2]["matmul_jax"]
    assert got.shape == ref.shape == (3200,) and np.isfinite(got).all()
    se = np.hypot(got.std() / np.sqrt(got.size), ref.std() / np.sqrt(ref.size))
    assert abs(got.mean() - ref.mean()) < 5 * se


def test_jax_messages_are_raised(world):
    raised = world[0][0]["raised"]
    assert set(raised) == {c["name"] for c in CASES if "raises" in c}
    for c in CASES:
        if "raises" in c:
            assert c["raises"][1] in raised[c["name"]]


@pytest.mark.parametrize("name", list(TIME_SHARDED))
def test_time_sharded_series_equal_the_serial_run(world, name):
    """JAX's limits (``tests/test_sharding.py``): the screens route samples
    the same screens at the same absolute steps; the alpha = 1 AR windows
    (16 layers: the streamed kernel's plain version) start from the jumped
    state, float32 round-off apart."""
    got, ref = sharded(world, name), world[2][name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TIME_SHARDED[name][2],
                               atol=1e-9)


def test_layer_sharded_boiling_series(world):
    """Each rank evolves its layer with the serial run's noise rows, so the
    series equals the serial SYNTH='fft' route within the AR routes'
    2e-3; its mean is within JAX's |log ratio| < 0.7 of fast_tpu's
    layer-sharded run (other random streams)."""
    got, ref = sharded(world, "layers"), world[2]["layers"]
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=1e-9)
    x = got / got.mean() - 1
    assert (x[:-1] * x[1:]).mean() / (x * x).mean() > 0.5
    assert abs(np.log(world[2]["layers_jax"].mean() / got.mean())) < 0.7


@pytest.mark.parametrize("name", ["scan22", "scan41"])
def test_scans_past_one_device_equal_the_one_device_scan(world, name):
    """A (2, 2) iid scan through K2's plain version against the (1, 1)
    scan with NCHUNKS doubled; a (4, 1) AR scan through K6's plain version
    (one call a rank, its series offset in the Philox rows) against the
    (1, 1) scan's one call."""
    ref = world[2][name]
    for i in range(len(ZENITHS)):
        np.testing.assert_array_equal(world[1][0][f"{name}.{i}"], ref[i])
    assert not np.array_equal(ref[0], ref[1])


def test_dryrun_twin_on_four_ranks(world):
    dryrun.check_dryrun(world[1], RANKS)
    for name in ("iid", "scan", "ar", "boiling"):
        assert name in world[0][0]["seconds"]


def test_meshes_need_their_world_and_a_card():
    with pytest.raises(ValueError, match="needs a world of 2"):
        parallel.make_scan_mesh(2, 1, ["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()
    with parallel.make_mesh(1, devices=["cpu"]) as mesh:
        assert mesh.axis_names == ("mc",) and mesh.backend == "gloo"
        assert mesh.devices.shape == (1,)
        assert mesh.devices[0] == torch.device("cpu")
    assert not torch.distributed.is_initialized()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [dict(NITER=8192, NCHUNKS=2),
                                       dict(AR1, NITER=512)],
                         ids=["K2", "K4"])
def test_world_of_one_on_card_is_the_serial_run(cuda_device, overrides):
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops import synth_detect as sd
    counter = sd.synth_detect if "TEMPORAL" not in overrides \
        else af.ar_flow_fused
    sim = fast_tpu_torch.Fast(params(**overrides), device=cuda_device)
    ref = np.asarray(sim.run().power)
    with parallel.make_mesh() as mesh:
        assert mesh.backend == "nccl"
        assert mesh.devices[0].type == "cuda"
        counter.LAUNCHES = 0
        got = np.asarray(parallel.run_sharded(sim, mesh).power)
        assert counter.LAUNCHES > 0
        m = parallel.sharded_moments(got, mesh)
    np.testing.assert_array_equal(got, ref)
    x = got.astype(np.float64)
    np.testing.assert_allclose(m, [np.mean(x ** k) for k in (1, 2, 3, 4)],
                               rtol=1e-12)
    assert not torch.distributed.is_initialized()
