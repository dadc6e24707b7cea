"""Times of K2's and K7's pass 1 and of the whole kernels, on one card,
for one or more checkouts of fast_tpu_torch, in turns.

    python scripts/torch_pass1_ab.py                     # this checkout
    python scripts/torch_pass1_ab.py OLD . . OLD         # A/B, in turns

Each argument is the root of a checkout (a directory holding
``fast_tpu_torch/``); each is measured in a process of its own, in the
order given, so that two versions compare on one card within one call.
The shapes are chip_smoke.py's: the 256^2 flagship's (P=82, padded to 96)
per 4096 draws, and the 1024^2 link with a 4 m pupil (P=402, padded to
416) per launch of 630 draws; inputs from a numpy seed, screens of about
1.5 rad rms. Prints one line per measurement and the card's name and
power limit.
"""

import json
import os
import subprocess
import sys

import numpy as np

# (label, N, lo, hi, draws a timed call)
SHAPES = [("256^2, P=82", 256, 87, 169, 4096),
          ("1024^2, P=402", 1024, 311, 713, 630)]


def measure(root):
    """Times in this process of the checkout at ``root``."""
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
            ms1 = cuda_ms(lambda: sd.synth_pass1(1, s_t, wr, wi, nb, mix=m),
                          reps)
            ms2 = cuda_ms(lambda: sd.synth_detect(1, s_t, wr, wi, pm_t, nb,
                                                  mix=m), reps)
            out.append({"shape": label, "what": f"K2 {noise}", "draws": nb,
                        "pass1_ms": ms1, "pass1_tflops": flops / ms1 / 1e9,
                        "kernel_ms": ms2})
        ms7 = cuda_ms(lambda: sd.synth_screens(1, s_t, wr, wi, nb,
                                               npup=hi - lo), reps)
        out.append({"shape": label, "what": "K7", "draws": nb,
                    "kernel_ms": ms7})
        del s_t, wr, wi, pm_t, mix
        torch.cuda.empty_cache()
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])))
        return
    roots = sys.argv[1:] or ["."]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"measuring {root} failed")
        for r in json.loads(proc.stdout.strip().splitlines()[-1]):
            p1 = (f"pass 1 {r['pass1_ms']:.3f} ms "
                  f"({r['pass1_tflops']:.1f} TFLOP/s), "
                  if "pass1_ms" in r else "")
            print(f"{root}: {r['what']} {r['shape']}, {r['draws']} draws: "
                  f"{p1}kernel {r['kernel_ms']:.3f} ms ({card})")
    print(card)


if __name__ == "__main__":
    main()
