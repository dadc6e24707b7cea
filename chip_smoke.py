"""Smoke run of fast_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
   fails without a CUDA device;
2. build the synth-detect kernel (K2) from fast_tpu_torch/csrc/;
3. K2 against its plain torch version on the card, 'mixed' and 'gauss'
   noise, from the same Philox bits: at the flagship shapes (N=256, P=82)
   over 4100 draws, which takes two launches, the second from draw 4096;
   and at the default config's (N=102, P=102). Then the same comparison
   with the plain version's products at TF32, a lower-precision control
   that the limit must reject; and the device sincos against float64;
4. the slice: ``Fast(flagship, device="cuda").run()`` at NITER=262144,
   NCHUNKS=16, which must go through K2 (launch count) and give finite
   output that agrees in distribution with the plain SYNTH='matmul' path
   on the same card; then the default config, NITER=65536, through K2 and
   through 'matmul';
5. warm realizations per second of both paths, and of K2 with 'gauss'.

The last two lines are one JSON object of per-kernel numbers and one of
the run's device. The flagship config is the 256^2 AO-corrected 0.8 m
uplink at 1550 nm through a 4-layer HV57/Bufton profile.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

NITER = 262144
NCHUNKS = 16
NDRAWS = 4100         # complex draws of the kernel-against-plain check: two
                      # launches of at most 4096 draws
NTIME = 4096          # complex draws of a timed call: one launch
KERNEL_REL = 4e-6     # kernel vs plain, times the largest |sum|: fp32
                      # products and sums in another order differ by a few
                      # ulp of the sums; TF32 products differ by far more
MEAN_SIGMAS = 5.0     # kernel path vs plain path, combined standard errors
SI_REL = 0.05         # scintillation index, relative


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def flagship(**overrides):
    from fast_tpu_torch import conf, turbulence_models
    h, cn2, w = turbulence_models.HV57_Bufton_profile(4)
    p = dict(conf.DEFAULTS)
    p.update({
        "NPXLS": 256, "DX": 0.01, "NITER": NITER, "NCHUNKS": NCHUNKS,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 1, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn()`` over ``reps`` warm calls."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_env():
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)
    # full fp32 in every plain matrix product (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from fast_tpu_torch.ops import synth_detect as sd
    t0 = time.perf_counter()
    info = sd.build()
    print(f"build: synth_detect.cu in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {info.seconds:.1f} s) -> {info.path.name}")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")


def check_kernel(T, noise, ndraws, label):
    """K2 against its plain version on the tables ``T``; returns max |d|."""
    from fast_tpu_torch.ops import synth_detect as sd
    mix = T["mix"] if noise == "mixed" else None
    args = (0x5EED_1234_ABCD, T["s_t"], T["wr"], T["wi"], T["pm_t"], ndraws)
    before = sd.synth_detect.LAUNCHES
    ck = sd.synth_detect(*args, mix=mix, stream=3)
    cp = sd.synth_detect_reference(*args, mix=mix, stream=3)
    torch.cuda.synchronize()
    launches = sd.synth_detect.LAUNCHES - before
    sd.synth_detect.LAUNCHES = before  # the main path's count excludes these
    if not bool(torch.isfinite(ck).all()):
        fail(f"K2 ({noise}, {label}) gave non-finite sums")
    err = float((ck - cp).abs().max())
    limit = KERNEL_REL * float(cp.abs().max())
    print(f"K2 {noise} {label}, {ndraws} draws in {launches} launches: "
          f"max |kernel - plain| = {err:.3e} (limit {limit:.3e}; "
          f"max |sum| {float(cp.abs().max()):.3e})")
    if not err <= limit:
        fail(f"K2 ({noise}, {label}) disagrees with its plain version")
    return err, cp


def phase_kernels(sim, sim_default):
    from fast_tpu_torch.ops import synth_detect as sd
    T = sim.tables
    res = {"max_abs_err": 0.0}
    for noise in ("mixed", "gauss"):
        err, cp = check_kernel(T, noise, NDRAWS, "flagship 256^2, P=82")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        err = check_kernel(sim_default.tables, noise, 512,
                           "default config 102^2, P=102")[0]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        # control: the plain version with its products at TF32
        mix = T["mix"] if noise == "mixed" else None
        args = (0x5EED_1234_ABCD, T["s_t"], T["wr"], T["wi"], T["pm_t"], 512)
        torch.backends.cuda.matmul.allow_tf32 = True
        ct = sd.synth_detect_reference(*args, mix=mix, stream=3)
        torch.backends.cuda.matmul.allow_tf32 = False
        c32 = cp.reshape(2, NDRAWS, 2)[:, :512].reshape(-1, 2)
        terr = float((ct - c32).abs().max())
        limit = KERNEL_REL * float(c32.abs().max())
        print(f"control: plain {noise} with TF32 products vs fp32, 512 "
              f"draws: max |d| = {terr:.3e}, {terr / limit:.1f}x the limit")

        args = (0x5EED_1234_ABCD, T["s_t"], T["wr"], T["wi"], T["pm_t"], NTIME)
        before = sd.synth_detect.LAUNCHES
        ms = cuda_ms(lambda: sd.synth_detect(*args, mix=mix), 10)
        plain_ms = cuda_ms(lambda: sd.synth_detect_reference(*args, mix=mix),
                           3)
        sd.synth_detect.LAUNCHES = before
        print(f"K2 {noise}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain "
              f"per {NTIME} complex draws at 256^2")
        sfx = "" if noise == "mixed" else "_gauss"
        res["ms" + sfx] = ms
        res["plain_ms" + sfx] = plain_ms
    g = torch.Generator(device="cuda").manual_seed(7)
    worst = 0.0
    for scale in (1.0, 30.0, 1000.0, 4096.0):
        phi = (torch.rand(1 << 20, device="cuda", generator=g) * 2 - 1) * scale
        s, c = sd.device_sincos(phi)
        p64 = phi.double()
        worst = max(worst, float((s.double() - p64.sin()).abs().max()),
                    float((c.double() - p64.cos()).abs().max()))
    print(f"device sincos: max |err| vs float64 over |phi| <= 4096: "
          f"{worst:.3e} (bound 2e-7)")
    if not worst < 2e-7:
        fail("device sincos exceeds 2e-7")
    return res


def timed_run(sim):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def default_config(**overrides):
    from fast_tpu_torch import conf
    p = dict(conf.DEFAULTS)
    p.update({"NITER": 65536, "NCHUNKS": 4, "SEED": 2, "LOGLEVEL": "WARNING"})
    p.update(overrides)
    return p


def agree(r_k, r_p, what):
    """Mean within MEAN_SIGMAS combined standard errors, scintillation
    index within SI_REL; prints both."""
    for name, r in (("K2", r_k), ("matmul", r_p)):
        if r.ndim != 1 or not np.isfinite(r).all():
            fail(f"{what}: {name} path output is not finite of shape (n,)")
    se = np.hypot(r_k.std() / np.sqrt(r_k.size), r_p.std() / np.sqrt(r_p.size))
    dmean = abs(r_k.mean() - r_p.mean())
    si_k, si_p = r_k.var() / r_k.mean() ** 2, r_p.var() / r_p.mean() ** 2
    print(f"{what}: mean normalised power K2 {r_k.mean():.6f}, matmul "
          f"{r_p.mean():.6f} ({dmean / se:.2f} combined SE); scintillation "
          f"index K2 {si_k:.5f}, matmul {si_p:.5f}")
    if not dmean <= MEAN_SIGMAS * se:
        fail(f"{what}: mean power of the K2 path disagrees with matmul")
    if not abs(si_k - si_p) <= SI_REL * si_p:
        fail(f"{what}: scintillation index of the K2 path disagrees")


def phase_slice(card):
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import synth_detect as sd
    sim_k = Fast(flagship(), device="cuda")
    sim_d = Fast(default_config(), device="cuda")
    for sim in (sim_k, sim_d):
        if sim._synth != "pallas_fused":
            fail(f"SYNTH='auto' resolved to {sim._synth!r}, not pallas_fused")
    kernels = phase_kernels(sim_k, sim_d)

    sd.synth_detect.LAUNCHES = 0
    res_k, t_k = timed_run(sim_k)
    launches = sd.synth_detect.LAUNCHES
    r_k = np.asarray(res_k._r, np.float64)
    print(f"slice: K2 path, {NITER} realizations in {t_k:.3f} s (first run), "
          f"{launches} K2 launches")
    if launches == 0:
        fail("Fast.run() did not launch the synth-detect kernel")
    if r_k.shape != (NITER,) or not np.isfinite(r_k).all():
        fail("K2 path output is not finite of shape (NITER,)")

    sim_p = Fast(flagship(SYNTH="matmul"), device="cuda")
    res_p = timed_run(sim_p)[0]
    agree(r_k, np.asarray(res_p._r, np.float64), "slice")
    print(f"slice: avg power {res_k.avg_power_dBm:.4f} dBm; phs_var "
          f"{sim_k.phs_var:.4f} rad^2")

    # the default config: a grid side that is no multiple of 64
    before = sd.synth_detect.LAUNCHES
    res_d = sim_d.run()
    if sd.synth_detect.LAUNCHES == before:
        fail("the default config's run did not launch the kernel")
    sd.synth_detect.LAUNCHES = before
    res_dp = Fast(default_config(SYNTH="matmul"), device="cuda").run()
    agree(np.asarray(res_d._r, np.float64), np.asarray(res_dp._r, np.float64),
          f"default config {sim_d.Npxls}^2, P={sim_d.Npxls_pup}")

    # warm rates, interleaved: kernel, plain, plain, kernel
    times = {"pallas_fused": [], "matmul": []}
    for sim in (sim_k, sim_p, sim_p, sim_k):
        times[sim._synth].append(timed_run(sim)[1])
    sim_g = Fast(flagship(MC_NOISE="gauss"), device="cuda")
    timed_run(sim_g)
    times["pallas_fused_gauss"] = [timed_run(sim_g)[1] for _ in range(2)]
    rates = {k: [NITER / t for t in v] for k, v in times.items()}
    for k, v in rates.items():
        print(f"rate: SYNTH={k}: " + ", ".join(f"{r:.0f}" for r in v)
              + f" realizations/s (warm run() of {NITER}; {card})")
    return kernels, launches, rates


def main():
    card = phase_env()
    phase_build()
    kernels, launches, rates = phase_slice(card)
    line = {"kernels": [{
        "name": "synth_detect", "route": "cuda",
        "source": "fast_tpu_torch/csrc/synth_detect.cu",
        "replaces": "fast_tpu/ops/pallas_synth.py:289",
        "launches": launches, **kernels, "timed_draws": NTIME,
        "run_rates": {k: max(v) for k, v in rates.items()},
    }], "card": card}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
