"""Smoke run of fast_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
   fails without a CUDA device;
2. build the synth-detect kernel K2 (``csrc/synth_detect.cu``) and the
   colfac-detect kernel K1 (``csrc/colfac_detect.cu``), one ``nvcc`` each,
   started together; print ptxas registers, spills and shared memory of
   each pass at the flagships' padded pupil (P=96);
3. K2 against its plain torch version on the card, 'mixed' and 'gauss'
   noise, from the same Philox bits: at the 256^2 flagship shapes (N=256,
   P=82) over 4100 draws, which takes two launches, the second from draw
   4096; and at the default config's (N=102, P=102). Then the same
   comparison with the plain version's products at TF32, a
   lower-precision control that the limit must reject; K2 with
   subharmonic screens over 4100 draws; and the device sincos against
   float64;
4. K1 against its plain version at the 512^2 flagship shapes (N=512,
   P=82), 'mixed' and 'gauss', over 4100 draws (two launches), with the
   TF32 control;
5. the 256^2 slice: ``Fast(flagship(), device="cuda").run()`` at
   NITER=262144, NCHUNKS=16, which must go through K2 (launch count) and
   agree in distribution with the plain SYNTH='matmul' path on the same
   card; then the default config, NITER=65536, through K2 and 'matmul';
6. the 512^2 slice: ``Fast(flagship(NPXLS=512), device="cuda")``, where
   SYNTH='auto' must pick K1; its run at NITER=262144 must launch K1 and
   not K2, and agree with 'matmul' (NCHUNKS=64, for memory);
7. subharmonics: SUBHARM=True at 256^2 through K2 and at 512^2
   (NITER=65536) through K1, each against 'matmul' with SUBHARM=True;
8. times: each kernel's ms per 4096 draws beside its bound and its plain
   version's; the factor build at 512^2; warm ``run()`` rates at 256^2
   (K2, 'matmul', K2 'gauss', K1 pinned) and at 512^2 (K1, 'colfac',
   'matmul', K2 pinned at NITER=65536); then one warm run of the K2, K1,
   'colfac' and 'matmul' paths under ``torch.profiler``.

The last lines are the card, one JSON object of per-kernel numbers and
one of the run's device. The flagship config is the AO-corrected 0.8 m
uplink at 1550 nm through a 4-layer HV57/Bufton profile, at DX=0.01 m:
a 256^2 grid (``__graft_entry__.py``) and the same link at 512^2.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

NITER = 262144
NCHUNKS = 16
NITER_SMALL = 65536   # realizations of the slower or secondary runs
NDRAWS = 4100         # complex draws of a kernel-against-plain check: two
                      # launches of at most 4096 draws
NTIME = 4096          # complex draws of a timed call: one launch
KERNEL_REL = 4e-6     # kernel vs plain, times the largest |sum|: fp32
                      # products and sums in another order differ by a few
                      # ulp of the sums; TF32 products differ by far more
MEAN_SIGMAS = 5.0     # kernel path vs plain path, combined standard errors
SI_REL = 0.05         # scintillation index, relative
SEED = 0x5EED_1234_ABCD
DEVICE = "cuda"
PJ = 6                # the flagships' pupil, 82 px, padded to 16 * PJ = 96
# the H100 SXM's published rates (NVIDIA data sheet, at 700 W): float32
# outside the tensor cores, and device memory
PEAK_FP32 = 67e12     # FLOP/s
PEAK_BYTES = 3.35e12  # B/s


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


def default_config(**overrides):
    from fast_tpu_torch import conf
    p = dict(conf.DEFAULTS)
    p.update({"NITER": NITER_SMALL, "NCHUNKS": 4, "SEED": 2,
              "LOGLEVEL": "WARNING"})
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


def timed_run(sim):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def launches_of(fn, counter):
    """Run ``fn()`` with ``counter.LAUNCHES`` set to 0 first; returns
    ``(fn(), launches)``."""
    counter.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, counter.LAUNCHES


def k2_bound(N, P, nbatch, mixed):
    """K2's least time in ms for ``nbatch`` draws at an (N, N) grid and a
    P px pupil: 4N^3 mixing FLOPs ('mixed'), 8N^2 P for G' and 8P^2 N for
    H per draw at the fp32 rate, or its tables in and sums out at the
    memory rate, whichever is longer."""
    flops = nbatch * ((4 * N ** 3 if mixed else 0) + 8 * N * N * P
                      + 8 * P * P * N)
    nbytes = 4 * (N * N * (2 if mixed else 1) + 2 * P * N + P * P
                  + 4 * nbatch)
    return _bound(flops, nbytes)


def k1_bound(N, P, nbatch, mixed):
    """K1's least time in ms: per draw and column a (1 x K) @ (K x 2P)
    factor product (K = 2 * 128 noise rows for 'mixed', 2P for 'gauss')
    and 8P^2 N for the column contraction, at the fp32 rate; or its
    factor table, W and pm in and sums out at the memory rate."""
    K = 2 * (128 if mixed else P)
    flops = nbatch * (N * 2 * K * 2 * P + 8 * P * P * N)
    nbytes = 4 * (N * K * 2 * P + 2 * P * N + P * P + 4 * nbatch)
    return _bound(flops, nbytes)


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


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


_PASS = re.compile(r"(synth_pass1|colfac_pass1|detect_pass)I(?:Lb([01])E)?"
                   rf"Li{PJ}E(?:Li([12])E)?E")


def phase_build():
    from fast_tpu_torch.ops import _build
    t0 = time.perf_counter()
    infos = _build.build_all(["synth_detect", "colfac_detect"])
    print(f"build: both kernels in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k}.cu nvcc {v.seconds:.1f} s"
                      for k, v in infos.items()) + ")")
    for name, info in infos.items():
        fn = None
        for line in info.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = _PASS.search(m.group(1))
                continue
            if fn and ("Used" in line or "spill" in line):
                mode = {"1": " mixed", "0": " gauss", None: ""}[fn.group(2)]
                rows = f" rows={fn.group(3)}" if fn.group(3) else ""
                print(f"  ptxas {name}: {fn.group(1)} P={16 * PJ}{mode}"
                      f"{rows}: {line.split(':', 1)[-1].strip()}")


def check(kernel, fn, ref_fn, args, kw, label):
    """A kernel against its plain version on the same inputs; returns
    (max |d|, the plain version's sums)."""
    before = fn.LAUNCHES
    ck = fn(*args, **kw)
    cp = ref_fn(*args, **kw)
    torch.cuda.synchronize()
    launches = fn.LAUNCHES - before
    fn.LAUNCHES = before  # the main path's count excludes these
    if not bool(torch.isfinite(ck).all()):
        fail(f"{kernel} ({label}) gave non-finite sums")
    err = float((ck - cp).abs().max())
    limit = KERNEL_REL * float(cp.abs().max())
    print(f"{kernel} {label}, {args[-1]} draws in {launches} launches: "
          f"max |kernel - plain| = {err:.3e} (limit {limit:.3e}; "
          f"max |sum| {float(cp.abs().max()):.3e})")
    if not err <= limit:
        fail(f"{kernel} ({label}) disagrees with its plain version")
    return err, cp


def tf32_control(kernel, ref_fn, args, kw, c32, label):
    """The plain version with its products at TF32 against the fp32 one
    on the first 512 draws; prints how far over the limit it lands."""
    n = min(512, args[-1])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ct = ref_fn(*args[:-1], n, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    c32 = c32.reshape(2, -1, 2)[:, :n].reshape(-1, 2)
    terr = float((ct - c32).abs().max())
    limit = KERNEL_REL * float(c32.abs().max())
    print(f"control: plain {kernel} {label} with TF32 products vs fp32, {n} "
          f"draws: max |d| = {terr:.3e}, {terr / limit:.1f}x the limit")
    if not terr > limit:
        fail(f"the limit does not reject TF32 products ({kernel} {label})")


def time_kernel(fn, ref_fn, args, kw):
    """(kernel ms, plain ms) per NTIME draws; the launches do not count."""
    args = args[:-1] + (NTIME,)
    before = fn.LAUNCHES
    ms = cuda_ms(lambda: fn(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: ref_fn(*args, **kw), 3)
    fn.LAUNCHES = before
    return ms, plain_ms


def phase_k2(sim, sim_default):
    from fast_tpu_torch.ops import synth_detect as sd
    T = sim.tables
    N, P = sim.Npxls, sim.Npxls_pup
    res = {"max_abs_err": 0.0}
    for noise in ("mixed", "gauss"):
        kw = {"mix": T["mix"] if noise == "mixed" else None}
        args = (SEED, T["s_t"], T["wr"], T["wi"], T["pm_t"], NDRAWS)
        err, cp = check("K2", sd.synth_detect, sd.synth_detect_reference,
                        args, kw, f"{noise} flagship 256^2, P={P}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        Td = sim_default.tables
        kwd = {"mix": Td["mix"] if noise == "mixed" else None}
        err = check("K2", sd.synth_detect, sd.synth_detect_reference,
                    (SEED, Td["s_t"], Td["wr"], Td["wi"], Td["pm_t"], 512),
                    kwd, f"{noise} default config 102^2, P=102")[0]
        res["max_abs_err"] = max(res["max_abs_err"], err)
        tf32_control("K2", sd.synth_detect_reference, args, kw, cp, noise)

        ms, plain_ms = time_kernel(sd.synth_detect,
                                   sd.synth_detect_reference, args, kw)
        bound_ms, bound_by, flops = k2_bound(N, P, NTIME, noise == "mixed")
        print(f"K2 {noise}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
              f"bound {bound_ms:.3f} ms ({flops / NTIME / 1e6:.1f} MFLOP "
              f"per draw; {bound_ms / ms:.1%} of it) per {NTIME} complex "
              f"draws at 256^2")
        sfx = "" if noise == "mixed" else "_gauss"
        res.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "bound_ms" + sfx: bound_ms, "bound_by" + sfx: bound_by})

    # subharmonic screens of ~1 rad rms, two launches: the second takes
    # its screens from draw 4096
    g = torch.Generator(device=DEVICE).manual_seed(11)
    sh = torch.complex(*torch.randn((2, NDRAWS, P, P), device=DEVICE,
                                    generator=g))
    sh_t = sd.pack_subharm(sh, T["wr"].shape[0])
    err = check("K2", sd.synth_detect, sd.synth_detect_reference,
                (SEED, T["s_t"], T["wr"], T["wi"], T["pm_t"], NDRAWS),
                {"mix": T["mix"], "sh_t": sh_t},
                "mixed with subharmonic screens, 256^2")[0]
    res["max_abs_err_sh"] = err

    g = torch.Generator(device=DEVICE).manual_seed(7)
    worst = 0.0
    for scale in (1.0, 30.0, 1000.0, 4096.0):
        phi = torch.rand(1 << 20, device=DEVICE, generator=g) * 2 - 1
        phi = phi * scale
        s, c = sd.device_sincos(phi)
        p64 = phi.double()
        worst = max(worst, float((s.double() - p64.sin()).abs().max()),
                    float((c.double() - p64.cos()).abs().max()))
    print(f"device sincos: max |err| vs float64 over |phi| <= 4096: "
          f"{worst:.3e} (bound 2e-7)")
    if not worst < 2e-7:
        fail("device sincos exceeds 2e-7")
    return res


def phase_k1(sim):
    from fast_tpu_torch.ops import colfac_detect as cd
    T = sim.tables
    N, P = sim.Npxls, sim.Npxls_pup
    res = {"max_abs_err": 0.0}
    for noise in ("mixed", "gauss"):
        mixed = noise == "mixed"
        S = T["S_colfac"] if mixed else cd.pack_tables(T["L"], mixed=False)
        args = (SEED, S, T["wr"], T["wi"], T["pm_t"], NDRAWS)
        kw = {"mixed": mixed, "stream": 3}
        err, cp = check("K1", cd.colfac_detect, cd.colfac_detect_reference,
                        args, kw, f"{noise} flagship 512^2, P={P}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        tf32_control("K1", cd.colfac_detect_reference, args, kw, cp, noise)

        ms, plain_ms = time_kernel(cd.colfac_detect,
                                   cd.colfac_detect_reference, args, kw)
        bound_ms, bound_by, flops = k1_bound(N, P, NTIME, mixed)
        print(f"K1 {noise}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
              f"bound {bound_ms:.3f} ms ({flops / NTIME / 1e6:.1f} MFLOP "
              f"per draw; {bound_ms / ms:.1%} of it) per {NTIME} complex "
              f"draws at 512^2")
        sfx = "" if mixed else "_gauss"
        res.update({"ms" + sfx: ms, "plain_ms" + sfx: plain_ms,
                    "bound_ms" + sfx: bound_ms, "bound_by" + sfx: bound_by})
    return res


def agree(r_k, r_p, what, name="kernel"):
    """Mean within MEAN_SIGMAS combined standard errors, scintillation
    index within SI_REL; prints both."""
    for who, r in ((name, r_k), ("matmul", r_p)):
        if r.ndim != 1 or not np.isfinite(r).all():
            fail(f"{what}: {who} path output is not finite of shape (n,)")
    se = np.hypot(r_k.std() / np.sqrt(r_k.size), r_p.std() / np.sqrt(r_p.size))
    dmean = abs(r_k.mean() - r_p.mean())
    si_k, si_p = r_k.var() / r_k.mean() ** 2, r_p.var() / r_p.mean() ** 2
    print(f"{what}: mean normalised power {name} {r_k.mean():.6f}, matmul "
          f"{r_p.mean():.6f} ({dmean / se:.2f} combined SE); scintillation "
          f"index {name} {si_k:.5f}, matmul {si_p:.5f}")
    if not dmean <= MEAN_SIGMAS * se:
        fail(f"{what}: mean power of the {name} path disagrees with matmul")
    if not abs(si_k - si_p) <= SI_REL * si_p:
        fail(f"{what}: scintillation index of the {name} path disagrees")


def series(res):
    return np.asarray(res._r, np.float64)


def slice_run(sim, kernel, counter, other, label):
    """The main path of one slice: ``sim.run()`` with both kernels' counts
    at 0; fails unless it launched ``kernel`` and not ``other``. Returns
    (series, launches, seconds)."""
    other.LAUNCHES = 0
    (res, secs), launches = launches_of(lambda: timed_run(sim), counter)
    r = series(res)
    print(f"{label}: {sim.Niter} realizations in {secs:.3f} s (first run), "
          f"{launches} {kernel} launches, {other.LAUNCHES} of the other "
          f"kernel; avg power {res.avg_power_dBm:.4f} dBm, phs_var "
          f"{sim.phs_var:.4f} rad^2")
    if launches == 0:
        fail(f"{label}: Fast.run() did not launch {kernel}")
    if other.LAUNCHES:
        fail(f"{label}: Fast.run() launched the other kernel")
    if r.shape != (sim.Niter,) or not np.isfinite(r).all():
        fail(f"{label}: output is not finite of shape (NITER,)")
    return r, launches, secs


def rates(runs, card, where):
    """Warm ``run()`` rates of the named sims, two each, in the given
    order; prints and returns {name: [r/s, ...]}."""
    out = {}
    for name, sim in runs:
        out.setdefault(name, []).append(sim.Niter / timed_run(sim)[1])
    for name, v in out.items():
        print(f"rate {where}: {name}: " + ", ".join(f"{r:.0f}" for r in v)
              + f" realizations/s (warm run() of {dict(runs)[name].Niter};"
              f" {card})")
    return out


def phase_slices(card):
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    K1, K2 = cd.colfac_detect, sd.synth_detect

    sim_k = Fast(flagship(), device=DEVICE)
    sim_d = Fast(default_config(), device=DEVICE)
    for sim in (sim_k, sim_d):
        if sim._synth != "pallas_fused":
            fail(f"SYNTH='auto' resolved to {sim._synth!r}, not pallas_fused")
    t0 = time.perf_counter()
    sim_c = Fast(flagship(NPXLS=512), device=DEVICE)
    init_512 = time.perf_counter() - t0
    if sim_c._synth != "pallas_colfac":
        fail(f"SYNTH='auto' at 512^2 resolved to {sim_c._synth!r}")
    print(f"512^2 flagship: Fast() in {init_512:.2f} s, column factors "
          f"{sim_c.timings['column_factors']:.3f} s (first, float32 on the "
          f"card), P={sim_c.Npxls_pup}")
    k2 = phase_k2(sim_k, sim_d)
    k1 = phase_k1(sim_c)

    # 256^2: the K2 path
    r_k, k2["launches"], _ = slice_run(sim_k, "K2", K2, K1, "slice 256^2")
    sim_p = Fast(flagship(SYNTH="matmul"), device=DEVICE)
    agree(r_k, series(timed_run(sim_p)[0]), "slice 256^2", "K2")
    r_d = slice_run(sim_d, "K2", K2, K1, "default config")[0]
    agree(r_d, series(Fast(default_config(SYNTH="matmul"),
                           device=DEVICE).run()),
          f"default config {sim_d.Npxls}^2, P={sim_d.Npxls_pup}", "K2")

    # 512^2: the K1 path
    r_c, k1["launches"], _ = slice_run(sim_c, "K1", K1, K2, "slice 512^2")
    sim_cm = Fast(flagship(NPXLS=512, SYNTH="matmul", NCHUNKS=64),
                  device=DEVICE)
    agree(r_c, series(timed_run(sim_cm)[0]), "slice 512^2", "K1")

    # subharmonics through both kernels
    for npx, kernel, ctr, other, niter in ((256, "K2", K2, K1, NITER),
                                           (512, "K1", K1, K2, NITER_SMALL)):
        kw = dict(NPXLS=npx, SUBHARM=True, NITER=niter, SEED=5)
        sim_s = Fast(flagship(**kw), device=DEVICE)
        r_s = slice_run(sim_s, kernel, ctr, other,
                        f"SUBHARM {npx}^2")[0]
        r_sm = series(Fast(flagship(SYNTH="matmul", **kw),
                           device=DEVICE).run())
        agree(r_s, r_sm, f"SUBHARM {npx}^2", kernel)

    # warm rates, interleaved; launches here do not count
    sim_g = Fast(flagship(MC_NOISE="gauss"), device=DEVICE)
    sim_k1 = Fast(flagship(SYNTH="pallas_colfac"), device=DEVICE)
    for sim in (sim_g, sim_k1):
        timed_run(sim)
    rates_256 = rates([("K2", sim_k), ("matmul", sim_p),
                       ("K1 pinned", sim_k1), ("K2 gauss", sim_g),
                       ("K2 gauss", sim_g), ("K1 pinned", sim_k1),
                       ("matmul", sim_p), ("K2", sim_k)], card, "256^2")
    sim_cc = Fast(flagship(NPXLS=512, SYNTH="colfac"), device=DEVICE)
    print(f"512^2 column factors, second build: "
          f"{sim_cc.timings['column_factors']:.3f} s (float32 on the card)")
    sim_c2 = Fast(flagship(NPXLS=512, SYNTH="pallas_fused",
                           NITER=NITER_SMALL), device=DEVICE)
    for sim in (sim_cc, sim_c2):
        timed_run(sim)
    rates_512 = rates([("K1", sim_c), ("colfac", sim_cc), ("matmul", sim_cm),
                       ("K2 pinned", sim_c2), ("K2 pinned", sim_c2),
                       ("matmul", sim_cm), ("colfac", sim_cc), ("K1", sim_c)],
                      card, "512^2")
    profile([("K2 256^2", sim_k), ("K1 512^2", sim_c),
             ("colfac 512^2", sim_cc), ("matmul 512^2", sim_cm)])
    K1.LAUNCHES = K2.LAUNCHES = 0
    return k2, k1, rates_256, rates_512


def _short(name):
    m = re.search(r"(synth_pass1|colfac_pass1|detect_pass)", name)
    return m.group(1) if m else name[:48]


def profile(runs):
    """One warm ``run()`` of each named sim under ``torch.profiler``:
    wall, device busy share, peak device memory and the largest device
    items by name."""
    from fast_tpu_torch.utils.profiling import device_breakdown
    for name, sim in runs:
        torch.cuda.reset_peak_memory_stats()
        wall, busy, per = device_breakdown(sim.run)
        peak = torch.cuda.max_memory_allocated() / 1e9
        top = "; ".join(f"{_short(k)} {v * 1e3:.1f} ms ({v / busy:.1%})"
                        for k, v in list(per.items())[:4])
        print(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy * 1e3:.1f} ms ({busy / wall:.1%}), peak {peak:.2f} GB;"
              f" {top}")


def kernel_entry(name, source, replaces, res, shape, run_rates):
    """One kernel's entry of the result line: the contract's keys, then
    the 'gauss' numbers and the run rates."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": res["launches"],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None,
            "shape": shape, "timed_draws": NTIME,
            **{k: v for k, v in res.items() if k.endswith(("_gauss", "_sh"))},
            "run_rates": {k: max(v) for k, v in run_rates.items()}}


def main():
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    k2, k1, rates_256, rates_512 = phase_slices(card)
    line = {"kernels": [
        kernel_entry("synth_detect", "fast_tpu_torch/csrc/synth_detect.cu",
                     "fast_tpu/ops/pallas_synth.py:289", k2,
                     "256^2, P=82, mixed", rates_256),
        kernel_entry("colfac_detect", "fast_tpu_torch/csrc/colfac_detect.cu",
                     "fast_tpu/ops/pallas_synth.py:724", k1,
                     "512^2, P=82, mixed", rates_512),
    ], "seconds": time.perf_counter() - t_start}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
