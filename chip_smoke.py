"""Smoke run of fast_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. environment: torch and CUDA versions, the card's name and power limit;
   fails without a CUDA device;
2. build the synth-detect kernel K2 (``csrc/synth_detect.cu``), the
   colfac-detect kernel K1 (``csrc/colfac_detect.cu``) and the AR flow
   kernels K4 and K5 (``csrc/ar_flow.cu``), one ``nvcc`` each, started
   together; print ptxas registers, spills and shared memory of each pass
   at the flagships' padded pupil (P=96);
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
8. K4 (``ar_flow_fused``) against its plain version at the temporal
   flagship's shapes (N=256, 4 layers, P=82) from the same initial state
   and the same Philox bits: pure frozen flow, 'uniform' and 'gauss'
   boiling, over 4100 steps (two launches: the carried state and the
   absolute-step counter), the final state bit for bit and the couplings
   within the limit, with the TF32 control; K5 (``ar_flow_streamed``) the
   same on the 16-layer 512^2 link over 260 steps in launches of 256, and
   K5 against K4 on the 4-layer flagship;
9. the temporal slice: ``Fast(flagship(TEMPORAL=True, TEMPORAL_SYNTH='ar',
   DT=0.001, NITER=65536, NCHUNKS=16), device="cuda").run()`` must launch
   K4 and no other kernel, return finite power with a lag-1
   autocorrelation over 0.9, and agree in its marginal with the iid
   'matmul' run (mean within 5 standard errors at the series' effective
   sample count, KS test on the series thinned beyond its integrated
   autocorrelation time); the 16-layer 512^2 link through K5 at
   NITER=8192; the 'ar' kernel route against the SYNTH='fft' route from
   one seed; one 'screens' run;
10. times: each kernel's ms per 4096 draws or steps beside its bound and
   its plain version's; the factor build at 512^2; warm ``run()`` rates at
   256^2 (K2, 'matmul', K2 'gauss', K1 pinned), at 512^2 (K1, 'colfac',
   'matmul' and K2 pinned at fewer realizations) and of the temporal
   routes (K4, 'fft', K5); then one warm run of the K2, K1, 'colfac',
   'matmul', K4 and K5 paths under ``torch.profiler``.

The last lines are the card, one JSON object of per-kernel numbers and
one of the run's device. The flagship config is the AO-corrected 0.8 m
uplink at 1550 nm through a 4-layer HV57/Bufton profile, at DX=0.01 m:
a 256^2 grid (``__graft_entry__.py``) and the same link at 512^2; the
temporal mode runs it at DT = 1 ms, and through a 16-layer profile at
512^2.
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
NITER_K2_512 = 32768  # K2 pinned at 512^2, the slowest yardstick
NSTEPS = 4100         # steps of a K4-against-plain check: two launches of
                      # at most 4096 steps
NSTEPS_K5 = 260       # steps of a K5 check at 16 layers x 512^2, in
MAX_STEPS_K5 = 256    # launches of at most 256 steps (its plain version
                      # draws 4.2 M Philox words per step)
NITER_T = 65536       # steps of the temporal slice (NCHUNKS=16)
NITER_T16 = 8192      # steps of the 16-layer 512^2 temporal run
NITER_FFT = 8192      # steps of the timed SYNTH='fft' temporal run
ACF_MIN = 0.9         # lag-1 autocorrelation of a temporal power series
KS_PVALUE = 1e-3      # thinned temporal series against the iid draws
FFT_RTOL = 2e-3       # 'ar' kernel route against the SYNTH='fft' route
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


def flagship(nlayers=4, **overrides):
    from fast_tpu_torch import conf, turbulence_models
    h, cn2, w = turbulence_models.HV57_Bufton_profile(nlayers)
    p = dict(conf.DEFAULTS)
    p.update({
        "NPXLS": 256, "DX": 0.01, "NITER": NITER, "NCHUNKS": NCHUNKS,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.arange(nlayers) * (360.0 / nlayers),
        "SEED": 1, "LOGLEVEL": "WARNING",
    })
    p.update(overrides)
    return p


def temporal(nlayers=4, **overrides):
    """The flagship link as a time series at DT = 1 ms on the AR route."""
    kw = dict(TEMPORAL=True, TEMPORAL_SYNTH="ar", DT=0.001, NITER=NITER_T,
              NCHUNKS=16)
    kw.update(overrides)
    return flagship(nlayers, **kw)


def default_config(**overrides):
    from fast_tpu_torch import conf
    p = dict(conf.DEFAULTS)
    p.update({"NITER": NITER_SMALL, "NCHUNKS": 4, "SEED": 2,
              "LOGLEVEL": "WARNING"})
    p.update(overrides)
    return p


def cuda_ms(fn, reps, warm=True):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after one
    more to warm up unless the caller has run it before."""
    if warm:
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


def ar_bound(L, N, P, nsteps, boiling):
    """K4's and K5's least time in ms for ``nsteps`` steps of L layers at
    an (N, N) grid and a P px pupil: per step 8PN^2 FLOPs for G' and
    4P^2 N for the real screen, plus 8LN^2 in the recurrence and layer sum
    and 8LN^2 more with boiling (the noise's scale and its scaled add),
    at the fp32 rate; or state, phasors and noise scale in, state and
    couplings out at the memory rate."""
    flops = nsteps * (8 * P * N * N + 4 * P * P * N
                      + (16 if boiling else 8) * L * N * N)
    nbytes = 4 * ((7 if boiling else 6) * L * N * N + 2 * P * N + P * P
                  + 2 * nsteps)
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
# the AR passes: the update at 4 layers a thread (K4 at the flagship, and
# K5's layer block) per noise kind, the two products at the padded pupil
_AR_PASS = re.compile(rf"(ar_update)ILi4ELi([012])EE|(ar_dft|ar_detect)"
                      rf"ILi{PJ}EE")


def phase_build():
    from fast_tpu_torch.ops import _build
    t0 = time.perf_counter()
    infos = _build.build_all(["synth_detect", "colfac_detect", "ar_flow"])
    print(f"build: three libraries in {time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k}.cu nvcc {v.seconds:.1f} s"
                      for k, v in infos.items()) + ")")
    for name, info in infos.items():
        fn = ar = None
        for line in info.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = _PASS.search(m.group(1))
                ar = _AR_PASS.search(m.group(1))
                continue
            if ar and ("Used" in line or "spill" in line):
                kind = ("" if ar.group(3) else " 4 layers "
                        + ("frozen", "uniform", "gauss")[int(ar.group(2))])
                print(f"  ptxas {name}: {ar.group(1) or ar.group(3)}"
                      f"{kind or f' P={16 * PJ}'}: "
                      f"{line.split(':', 1)[-1].strip()}")
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


def ar_inputs(sim, noise):
    """One AR series' arguments from a temporal sim's tables: the initial
    state drawn with numpy from SEED and coloured by sqrt(PSD) df, the
    phasor and noise scale (pure frozen flow: the unit phasor and none),
    W and pupil * mode."""
    T = sim.tables
    rng = np.random.default_rng(SEED & 0xFFFFFFFF)
    z = rng.standard_normal((2,) + tuple(T["sqrt_psd_df"].shape),
                            dtype=np.float32)
    z = torch.from_numpy(z).to(DEVICE)
    a0 = torch.complex(z[0], z[1]) * T["sqrt_psd_df"]
    if noise is None:
        return a0, T["step_phasor"], None, T["W"], T["pm"]
    return a0, T["ph"], T["ns"], T["W"], T["pm"]


def check_ar(kernel, fn, inputs, nsteps, kw, label):
    """An AR kernel against the plain version on the same inputs: the
    final state bit for bit, the couplings within the limit. Returns (max
    |d| of the couplings, the plain version's couplings)."""
    from fast_tpu_torch.ops import ar_flow as af
    before = fn.LAUNCHES
    ck, ak = fn(SEED, *inputs, nsteps, **kw)
    cp, ap = af.ar_flow_reference(SEED, *inputs, nsteps,
                                  noise=kw.get("noise", "uniform"))
    torch.cuda.synchronize()
    launches = fn.LAUNCHES - before
    fn.LAUNCHES = before  # the main path's count excludes these
    if not bool(torch.isfinite(ck).all()):
        fail(f"{kernel} ({label}) gave non-finite sums")
    serr = float((ak - ap).abs().max())
    err = float((ck - cp).abs().max())
    limit = KERNEL_REL * float(cp.abs().max())
    print(f"{kernel} {label}, {nsteps} steps in {launches} launches: max "
          f"|kernel - plain| = {err:.3e} in the couplings (limit "
          f"{limit:.3e}; max |sum| {float(cp.abs().max()):.3e}), {serr:.3e} "
          f"in the final state (limit 0; max |a| "
          f"{float(ap.abs().max()):.3e})")
    if serr != 0.0:
        fail(f"{kernel} ({label}): the final state differs from the plain "
             f"version's")
    if not err <= limit:
        fail(f"{kernel} ({label}) disagrees with its plain version")
    return err, cp


def ar_tf32_control(kernel, inputs, noise, c32, label):
    """The plain version with its products at TF32 against the fp32 one
    on the first 512 steps; must land outside the limit."""
    from fast_tpu_torch.ops import ar_flow as af
    n = min(512, c32.shape[0])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ct = af.ar_flow_reference(SEED, *inputs, n,
                                  noise=noise or "uniform")[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    terr = float((ct - c32[:n]).abs().max())
    limit = KERNEL_REL * float(c32[:n].abs().max())
    print(f"control: plain {kernel} {label} with TF32 products vs fp32, {n} "
          f"steps: max |d| = {terr:.3e}, {terr / limit:.1f}x the limit")
    if not terr > limit:
        fail(f"the limit does not reject TF32 products ({kernel} {label})")


def time_ar(fn, inputs, nsteps, kw, reps):
    """(kernel ms, plain ms) per ``nsteps`` steps; the launches do not
    count."""
    from fast_tpu_torch.ops import ar_flow as af
    before = fn.LAUNCHES
    ms = cuda_ms(lambda: fn(SEED, *inputs, nsteps, **kw), reps)
    plain_ms = cuda_ms(lambda: af.ar_flow_reference(
        SEED, *inputs, nsteps, noise=kw.get("noise", "uniform")), 1,
        warm=False)  # the checks before ran it
    fn.LAUNCHES = before
    return ms, plain_ms


def phase_ar(sim_t, sim_t16):
    """K4 at the temporal flagship's shapes and K5 at the 16-layer 512^2
    link's, each against the plain version, and K5 against K4."""
    from fast_tpu_torch.ops import ar_flow as af
    k4, k5 = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    L, N, P = len(sim_t.h), sim_t.Npxls, sim_t.Npxls_pup
    for noise in (None, "uniform", "gauss"):
        label = f"{noise or 'frozen flow'} {N}^2, {L} layers, P={P}"
        inputs = ar_inputs(sim_t, noise)
        kw = {"noise": noise} if noise else {}
        err, cp = check_ar("K4", af.ar_flow_fused, inputs, NSTEPS, kw, label)
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        ar_tf32_control("K4", inputs, noise, cp, noise or "frozen flow")
        # K5's layer blocks (one layer, then three and one) against K4
        cf = af.ar_flow_fused(SEED, *inputs, 600, **kw)
        for lb in (1, 3):
            cs = af.ar_flow_streamed(SEED, *inputs, 600, lb_layers=lb, **kw)
            d = float((cs[0] - cf[0]).abs().max())
            ds = float((cs[1] - cf[1]).abs().max())
            print(f"K5 in blocks of {lb} against K4, {label}, 600 steps: max "
                  f"|d| = {d:.3e} in the couplings, {ds:.3e} in the state "
                  f"(limit 0 for both: the same sums in the same order)")
            if d != 0.0 or ds != 0.0:
                fail(f"K5 (blocks of {lb}) differs from K4 ({label})")
        af.ar_flow_fused.LAUNCHES = af.ar_flow_streamed.LAUNCHES = 0
    inputs = ar_inputs(sim_t, "uniform")
    k4["ms"], k4["plain_ms"] = time_ar(af.ar_flow_fused, inputs, NTIME,
                                       {"noise": "uniform"}, 5)
    k4["bound_ms"], k4["bound_by"], flops = ar_bound(L, N, P, NTIME, True)
    print(f"K4 uniform: {k4['ms']:.3f} ms kernel ({1e3 * k4['ms'] / NTIME:.3f}"
          f" us per step), {k4['plain_ms']:.3f} ms plain (the plain scan: "
          f"{1e3 * NTIME / k4['plain_ms']:.0f} steps/s), bound "
          f"{k4['bound_ms']:.3f} ms ({flops / NTIME / 1e6:.1f} MFLOP per "
          f"step; {k4['bound_ms'] / k4['ms']:.1%} of it) per {NTIME} steps "
          f"at {N}^2, {L} layers; A and G' through device memory: "
          f"{8 * N * (N + 16 * PJ) * 2 / 1e6:.2f} MB per step")
    for noise in (None, "gauss"):
        ms = cuda_ms(lambda: af.ar_flow_fused(
            SEED, *ar_inputs(sim_t, noise), NTIME,
            **({"noise": noise} if noise else {})), 5)
        k4["ms_" + (noise or "frozen")] = ms
        print(f"K4 {noise or 'frozen flow'}: {ms:.3f} ms per {NTIME} steps")
    af.ar_flow_fused.LAUNCHES = 0

    L, N, P = len(sim_t16.h), sim_t16.Npxls, sim_t16.Npxls_pup
    for noise in (None, "uniform", "gauss"):
        label = f"{noise or 'frozen flow'} {N}^2, {L} layers, P={P}"
        inputs = ar_inputs(sim_t16, noise)
        kw = {"max_steps": MAX_STEPS_K5}
        if noise:
            kw["noise"] = noise
        err, cp = check_ar("K5", af.ar_flow_streamed, inputs, NSTEPS_K5, kw,
                           label)
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        if noise == "uniform":  # the products are the same in every case
            ar_tf32_control("K5", inputs, noise, cp, noise)
    inputs = ar_inputs(sim_t16, "uniform")
    k5["ms"], k5["plain_ms"] = time_ar(af.ar_flow_streamed, inputs,
                                       MAX_STEPS_K5, {"noise": "uniform"}, 3)
    k5["bound_ms"], k5["bound_by"], flops = ar_bound(L, N, P, MAX_STEPS_K5,
                                                     True)
    k5["ms_4096"] = cuda_ms(lambda: af.ar_flow_streamed(
        SEED, *inputs, NTIME, noise="uniform"), 1)
    print(f"K5 uniform: {k5['ms']:.3f} ms kernel "
          f"({1e3 * k5['ms'] / MAX_STEPS_K5:.3f} us per step; "
          f"{k5['ms_4096']:.3f} ms per {NTIME} steps), {k5['plain_ms']:.3f} "
          f"ms plain, bound {k5['bound_ms']:.3f} ms "
          f"({flops / MAX_STEPS_K5 / 1e6:.1f} MFLOP per step; "
          f"{k5['bound_ms'] / k5['ms']:.1%} of it) per {MAX_STEPS_K5} steps "
          f"at {N}^2, {L} layers")
    af.ar_flow_streamed.LAUNCHES = 0
    return k4, k5


def acf_time(x):
    """Integrated autocorrelation time of a series in steps, 1 + 2 sum of
    the autocorrelation up to the first lag M with M >= 5 tau(M) (Sokal's
    window), and the lag-1 autocorrelation."""
    x = x - x.mean()
    n = x.size
    f = np.fft.rfft(x, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n] / np.arange(n, 0, -1)
    acf = acf / acf[0]
    tau = 1.0 + 2.0 * np.cumsum(acf[1:])
    lags = np.arange(1, n)
    ok = lags >= 5 * tau
    m = int(np.argmax(ok)) if ok.any() else n - 2
    return float(max(tau[m], 1.0)), float(acf[1])


def temporal_run(sim, kernel, counter, others, label):
    """The main path of a temporal slice: ``sim.run()`` with every
    kernel's count at 0; fails unless it launched ``kernel`` and no other,
    and returned a finite, correlated series. Returns (series, launches,
    integrated autocorrelation time)."""
    for o in others:
        o.LAUNCHES = 0
    (res, secs), launches = launches_of(lambda: timed_run(sim), counter)
    r = series(res)
    other = sum(o.LAUNCHES for o in others)
    if r.shape != (sim.Niter,) or not np.isfinite(r).all():
        fail(f"{label}: output is not finite of shape (NITER,)")
    tau, lag1 = acf_time(r)
    print(f"{label}: {sim.Niter} steps in {secs:.3f} s (first run), "
          f"{launches} {kernel} launches, {other} of the other kernels; avg "
          f"power {res.avg_power_dBm:.4f} dBm; lag-1 autocorrelation "
          f"{lag1:.5f}, integrated autocorrelation time {tau:.1f} steps")
    if kernel and launches == 0:
        fail(f"{label}: Fast.run() did not launch {kernel}")
    if other:
        fail(f"{label}: Fast.run() launched another kernel")
    if not lag1 > ACF_MIN:
        fail(f"{label}: lag-1 autocorrelation {lag1:.4f} is not over "
             f"{ACF_MIN}")
    return r, launches, tau


def phase_temporal(ctx):
    """The temporal slices through K4 and K5, the kernel route against
    the exact route, and a frozen-flow 'screens' run."""
    from scipy.stats import ks_2samp
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    K1, K2 = cd.colfac_detect, sd.synth_detect
    K4, K5 = af.ar_flow_fused, af.ar_flow_streamed

    sim_t = Fast(temporal(), device=DEVICE)
    t0 = time.perf_counter()
    sim_t16 = Fast(temporal(16, NPXLS=512, NITER=NITER_T16, NCHUNKS=2),
                   device=DEVICE)
    print(f"16-layer 512^2 temporal link: Fast() in "
          f"{time.perf_counter() - t0:.2f} s")
    for sim, route in ((sim_t, K4), (sim_t16, K5)):
        if sim._ar_route != "kernel" or af.select(len(sim.h)) is not route:
            fail(f"the {len(sim.h)}-layer temporal run is not on "
                 f"{route.__name__}")
        print(f"temporal {sim.Npxls}^2, {len(sim.h)} layers: alpha per layer "
              + " ".join(f"{a:.6f}" for a in sim._ar_alpha))
        if not (sim._ar_alpha < 1).any():
            fail("TEMPORAL_ALPHA='auto' gave no boiling at this length")
    k4, k5 = phase_ar(sim_t, sim_t16)

    r_t, k4["launches"], tau = temporal_run(
        sim_t, "K4", K4, (K1, K2, K5), "temporal slice 256^2")
    r_iid = ctx["r_iid"]
    n_eff = r_t.size / tau
    se = np.hypot(r_t.std() / np.sqrt(n_eff),
                  r_iid.std() / np.sqrt(r_iid.size))
    dmean = abs(r_t.mean() - r_iid.mean())
    thin = r_t[::int(np.ceil(2 * tau))]
    pval = float(ks_2samp(thin, r_iid).pvalue)
    print(f"temporal slice 256^2 against the iid matmul run: mean normalised "
          f"power {r_t.mean():.6f} against {r_iid.mean():.6f} "
          f"({dmean / se:.2f} SE at {n_eff:.0f} effective samples); KS on "
          f"{thin.size} samples thinned by {int(np.ceil(2 * tau))}: "
          f"p = {pval:.4f}")
    if not dmean <= MEAN_SIGMAS * se:
        fail("temporal slice: the mean power disagrees with the iid run")
    if not pval > KS_PVALUE:
        fail("temporal slice: the marginal disagrees with the iid run (KS)")
    _, k5["launches"], _ = temporal_run(
        sim_t16, "K5", K5, (K1, K2, K4), "temporal 512^2, 16 layers")

    # the kernel route against the exact route from one seed, with boiling
    kw = dict(NITER=512, NCHUNKS=2, TEMPORAL_ALPHA=0.98, SEED=9)
    r_k = series(Fast(temporal(**kw), device=DEVICE).run())
    r_f = series(Fast(temporal(SYNTH="fft", **kw), device=DEVICE).run())
    d = float(np.abs(r_k / r_f - 1).max())
    print(f"'ar' kernel route against the SYNTH='fft' route, 512 steps from "
          f"one seed: max relative difference {d:.3e} (limit {FFT_RTOL})")
    if not d <= FFT_RTOL:
        fail("the 'ar' kernel route disagrees with the SYNTH='fft' route")
    sim_s = Fast(temporal(TEMPORAL_SYNTH="screens", NPXLS="auto", NITER=1024,
                          NCHUNKS=4), device=DEVICE)
    temporal_run(sim_s, "", K4, (K1, K2, K4, K5),
                 f"'screens' run on the grown {sim_s.Npxls}^2 grid")
    sim_tf = Fast(temporal(SYNTH="fft", NITER=NITER_FFT, NCHUNKS=16),
                  device=DEVICE)
    return k4, k5, (sim_t, sim_t16, sim_tf)


def rates(runs, card, where, unit="realizations"):
    """Warm ``run()`` rates of the named sims, two each, in the given
    order; prints and returns {name: [per second, ...]}."""
    out = {}
    for name, sim in runs:
        out.setdefault(name, []).append(sim.Niter / timed_run(sim)[1])
    for name, v in out.items():
        print(f"rate {where}: {name}: " + ", ".join(f"{r:.0f}" for r in v)
              + f" {unit}/s (warm run() of {dict(runs)[name].Niter};"
              f" {card})")
    return out


def phase_slices():
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
    r_p = series(timed_run(sim_p)[0])
    agree(r_k, r_p, "slice 256^2", "K2")
    r_d = slice_run(sim_d, "K2", K2, K1, "default config")[0]
    agree(r_d, series(Fast(default_config(SYNTH="matmul"),
                           device=DEVICE).run()),
          f"default config {sim_d.Npxls}^2, P={sim_d.Npxls_pup}", "K2")

    # 512^2: the K1 path
    r_c, k1["launches"], _ = slice_run(sim_c, "K1", K1, K2, "slice 512^2")
    sim_cm = Fast(flagship(NPXLS=512, SYNTH="matmul", NITER=NITER_SMALL,
                           NCHUNKS=16), device=DEVICE)
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

    return dict(k2=k2, k1=k1, sim_k=sim_k, sim_p=sim_p, sim_c=sim_c,
                sim_cm=sim_cm, r_iid=r_p)


def phase_times(card, ctx, tsims):
    """Warm ``run()`` rates, interleaved, and the profiles; launches here
    do not count."""
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    sim_k, sim_p = ctx["sim_k"], ctx["sim_p"]
    sim_c, sim_cm = ctx["sim_c"], ctx["sim_cm"]
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
                           NITER=NITER_K2_512), device=DEVICE)
    for sim in (sim_cc, sim_c2):
        timed_run(sim)
    rates_512 = rates([("K1", sim_c), ("colfac", sim_cc), ("matmul", sim_cm),
                       ("K2 pinned", sim_c2), ("K2 pinned", sim_c2),
                       ("matmul", sim_cm), ("colfac", sim_cc), ("K1", sim_c)],
                      card, "512^2")
    sim_t, sim_t16, sim_tf = tsims
    timed_run(sim_tf)
    rates_t = rates([("K4", sim_t), ("fft route", sim_tf), ("K5", sim_t16),
                     ("K5", sim_t16), ("fft route", sim_tf), ("K4", sim_t)],
                    card, "temporal", "steps")
    profile([("K2 256^2", sim_k), ("K1 512^2", sim_c),
             ("colfac 512^2", sim_cc), ("matmul 512^2", sim_cm),
             ("K4 temporal 256^2", sim_t),
             ("K5 temporal 512^2, 16 layers", sim_t16)])
    for fn in (cd.colfac_detect, sd.synth_detect, af.ar_flow_fused,
               af.ar_flow_streamed):
        fn.LAUNCHES = 0
    return rates_256, rates_512, rates_t


def _short(name):
    m = re.search(r"(synth_pass1|colfac_pass1|detect_pass|ar_update|ar_dft|"
                  r"ar_detect)", name)
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


def kernel_entry(name, source, replaces, res, shape, run_rates, timed):
    """One kernel's entry of the result line: the contract's keys, then
    what else was measured and the run rates. No single PyTorch call
    computes any of these functions, so there is no library time."""
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **{k: res[k] for k in keys},
            "library_ms": None, "shape": shape, **timed,
            **{k: v for k, v in res.items() if k not in keys},
            "run_rates": {k: max(v) for k, v in run_rates.items()}}


def main():
    t_start = time.perf_counter()
    card = phase_env()
    phase_build()
    ctx = phase_slices()
    k4, k5, tsims = phase_temporal(ctx)
    rates_256, rates_512, rates_t = phase_times(card, ctx, tsims)
    line = {"kernels": [
        kernel_entry("synth_detect", "fast_tpu_torch/csrc/synth_detect.cu",
                     "fast_tpu/ops/pallas_synth.py:289", ctx["k2"],
                     "256^2, P=82, mixed", rates_256, {"timed_draws": NTIME}),
        kernel_entry("colfac_detect", "fast_tpu_torch/csrc/colfac_detect.cu",
                     "fast_tpu/ops/pallas_synth.py:724", ctx["k1"],
                     "512^2, P=82, mixed", rates_512, {"timed_draws": NTIME}),
        kernel_entry("ar_flow_fused", "fast_tpu_torch/csrc/ar_flow.cu",
                     "fast_tpu/ops/pallas_synth.py:996", k4,
                     "256^2, 4 layers, P=82, uniform", rates_t,
                     {"timed_steps": NTIME}),
        kernel_entry("ar_flow_streamed", "fast_tpu_torch/csrc/ar_flow.cu",
                     "fast_tpu/ops/pallas_synth.py:1736", k5,
                     "512^2, 16 layers, P=82, uniform", rates_t,
                     {"timed_steps": MAX_STEPS_K5}),
    ], "seconds": time.perf_counter() - t_start}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
