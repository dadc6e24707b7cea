"""Times of K2's and K7's pass 1 and of the whole kernels, on one card,
for one or more checkouts of fast_tpu_torch, in turns.

    python scripts/torch_pass1_ab.py                     # this checkout
    python scripts/torch_pass1_ab.py OLD . . OLD         # A/B, in turns
    python scripts/torch_pass1_ab.py --precision default OLD . . OLD

Each argument is the root of a checkout (a directory holding
``fast_tpu_torch/``); each is measured in a process of its own, in the
order given, so that two versions compare on one card within one call.
The shapes are chip_smoke.py's: the 256^2 flagship's (P=82, padded to 96)
per 4096 draws, and the 1024^2 link with a 4 m pupil (P=402, padded to
416) per launch of 630 draws; inputs from a numpy seed, screens of about
1.5 rad rms. Prints one line per measurement and the card's name and
power limit. The kernels take ``--precision`` ('highest', 3xTF32, unless
given; 'default' is one TF32 pass, what the engine runs). Then the warm
``run()`` rate through ``SYNTH='auto'`` (K2) of chip_smoke.py's 256^2
flagship (262,144 realizations, NCHUNKS=16) and of its 1024^2 link with a
4 m telescope (16,384 realizations, NCHUNKS=4), the mean of two runs
after a warm one. Last, whether pass 1's G' at 256^2 with 'mixed' noise,
4096 draws from each of three seeds, is the same bit for bit in every
checkout (a SHA-256 of its bytes).
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

# (label, N, lo, hi, draws a timed call)
SHAPES = [("256^2, P=82", 256, 87, 169, 4096),
          ("1024^2, P=402", 1024, 311, 713, 630)]
# (label, overrides of the flagship's parameters) of the timed runs
RUNS = [("256^2 flagship", {}),
        ("1024^2, 4 m pupil", dict(NPXLS=1024, D_GROUND=4.0, DSUBAP=0.5,
                                   NITER=16384, NCHUNKS=4, SEED=3))]


def flagship(**overrides):
    """chip_smoke.py's 256^2 flagship link: 4 HV57 layers, AO, 55 deg."""
    from fast_tpu_torch import conf, turbulence_models
    h, cn2, w = turbulence_models.HV57_Bufton_profile(4)
    p = dict(conf.DEFAULTS)
    p.update({
        "NPXLS": 256, "DX": 0.01, "NITER": 262144, "NCHUNKS": 16,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": 55, "AO_MODE": "AO", "DSUBAP": 0.1, "TLOOP": 0.001,
        "TEXP": 0.001, "ALIAS": True, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.arange(4) * 90.0, "SEED": 1,
        "LOGLEVEL": "WARNING"})
    p.update(overrides)
    return p


def measure(root, precision):
    """Times in this process of the checkout at ``root``, the kernels at
    ``precision``; then the digests of G' (``"bits"``)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from fast_tpu_torch.ops import synth_detect as sd
    from fast_tpu_torch.synthesis import pruned_ift2_matrix

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def cuda_ms(fn, reps):
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

    out = []
    for label, N, lo, hi, nb in SHAPES:
        rng = np.random.default_rng(5)
        sqrt_ps = (rng.random((N, N)) + 0.2).astype(np.float32)
        df = 1.5 / float(np.sqrt((sqrt_ps.astype(np.float64) ** 2).sum()))
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        pm = rng.random((hi - lo, hi - lo)).astype(np.float32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        s_t = t(sqrt_ps.T * np.float32(df))
        wr, wi, pm_t = sd.pad_pupil(t(W.real), t(W.imag), t(pm.T))
        mix = t(sd.mixing_matrix(N))
        P = wr.shape[0]
        reps = 10 if N <= 256 else 3
        for noise in ("mixed", "gauss"):
            m = mix if noise == "mixed" else None
            # product FLOPs: 4N^3 mixing ('mixed'), 8N^2 P for G'
            flops = nb * ((4 * N ** 3 if m is not None else 0)
                          + 8 * N * N * P)
            ms1 = cuda_ms(lambda: sd.synth_pass1(1, s_t, wr, wi, nb, mix=m,
                                                 precision=precision),
                          reps)
            ms2 = cuda_ms(lambda: sd.synth_detect(1, s_t, wr, wi, pm_t, nb,
                                                  mix=m,
                                                  precision=precision),
                          reps)
            out.append({"shape": label, "what": f"K2 {noise}", "draws": nb,
                        "pass1_ms": ms1, "pass1_tflops": flops / ms1 / 1e9,
                        "kernel_ms": ms2})
        ms7 = cuda_ms(lambda: sd.synth_screens(1, s_t, wr, wi, nb,
                                               npup=hi - lo,
                                               precision=precision), reps)
        out.append({"shape": label, "what": "K7", "draws": nb,
                    "kernel_ms": ms7})
        if N == 256:
            bits = []
            for seed in (1, 2, 3):
                gr, gi = sd.synth_pass1(seed, s_t, wr, wi, nb, mix=mix,
                                        precision=precision)
                h = hashlib.sha256(gr.cpu().numpy().tobytes())
                h.update(gi.cpu().numpy().tobytes())
                bits.append(h.hexdigest()[:16])
                del gr, gi
            out.append({"bits": bits})
        del s_t, wr, wi, pm_t, mix
        torch.cuda.empty_cache()
    import time
    from fast_tpu_torch import Fast
    for label, kw in RUNS:
        sim = Fast(flagship(**kw), device="cuda")
        sim.run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            sim.run()
        torch.cuda.synchronize()
        rate = 2 * sim.params["NITER"] / (time.perf_counter() - t0)
        out.append({"run": label, "synth": sim._synth, "rate": rate})
        del sim
        torch.cuda.empty_cache()
    return out


def main():
    if len(sys.argv) > 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2], sys.argv[3])))
        return
    args = sys.argv[1:]
    precision = "highest"
    if args[:1] == ["--precision"]:
        precision, args = args[1], args[2:]
    roots = args or ["."]
    digests = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", root,
                               precision], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"measuring {root} failed")
        for r in json.loads(proc.stdout.strip().splitlines()[-1]):
            if "bits" in r:
                digests.setdefault(tuple(r["bits"]), []).append(root)
                print(f"{root}: G' 256^2 'mixed' {precision}, seeds 1-3: "
                      f"{' '.join(r['bits'])}")
                continue
            if "run" in r:
                print(f"{root}: run() {r['run']} through 'auto' "
                      f"({r['synth']}): {r['rate']:,.0f} realizations/s "
                      f"({card})")
                continue
            p1 = (f"pass 1 {r['pass1_ms']:.3f} ms "
                  f"({r['pass1_tflops']:.1f} TFLOP/s), "
                  if "pass1_ms" in r else "")
            print(f"{root}: {r['what']} {r['shape']}, {r['draws']} draws: "
                  f"{p1}kernel {r['kernel_ms']:.3f} ms ({card})")
    print(f"G' bit for bit in every checkout: {len(digests) == 1}")
    print(card)


if __name__ == "__main__":
    main()
