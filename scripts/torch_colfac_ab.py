"""Times of the iid kernels K1, K3 and K2 and of their passes, on one card,
for one or more checkouts of fast_tpu_torch, in turns.

    python scripts/torch_colfac_ab.py                     # this checkout
    python scripts/torch_colfac_ab.py OLD . . OLD         # A/B, in turns

Each argument is the root of a checkout (a directory holding
``fast_tpu_torch/``); each is measured in a process of its own, in the
order given, so that two versions compare on one card within one call.
The shapes are chip_smoke.py's: K1 at the 512^2 flagship's (P=82, padded
to 96) per launch of 4096 draws and K3 at the 1024^2 link with a 4 m pupil
(P=402, padded to 416) per launch of 630 draws, 'mixed' and 'gauss'
noise; K2 ('mixed') at the 256^2 flagship's per 4096 draws and at the
1024^2 link's per 630. Factor tables and the PSD are random, from a seed
on the card (the kernels' time does not depend on their values), scaled
so that the screens have about a radian rms; a checkout whose kernels
read a laid-out table (``colfac_detect.lay_tables``) gets it laid out
once, before the clock, as its engine keeps it. Each kernel is timed
whole with CUDA events (``cuda_ms`` of scripts/torch_variants.py), then
run once under ``torch.profiler``, which gives its passes' device time
(pass 1: ``colfac_pass1``, ``split_pass1`` or ``synth_pass1``; the detect
pass: ``detect_pass`` and ``sum_tiles``), the same way for every
checkout: older ones have no entry for a pass alone. Rates count the
pupil's own px (82, 402), as chip_smoke.py's bounds do.

Then the two runs through these kernels, as chip_smoke.py makes them:
the 512^2 flagship through 'auto' (K1, 262,144 realizations) and the
1024^2 link with the 4 m telescope through pinned 'pallas_colfac' (K3,
8,192): ``Fast()``'s set-up seconds (``timings["device_constants"]``, the
tables), two warm ``run()`` rates and the peak device memory of the init
and the runs. Prints one line per measurement and the card's name and
power limit.
"""

import json
import os
import subprocess
import sys

# torch_variants puts this checkout's root on the path; a measured
# checkout goes before it
from torch_variants import card, cuda_ms

SEED = 0x5EED_1234_ABCD


def measure(root):
    """Times in this process of the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    from fast_tpu_torch.synthesis import pruned_ift2_matrix
    from fast_tpu_torch.utils.profiling import device_breakdown

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def tables(N, lo, hi):
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        pm = np.random.default_rng(5).random((hi - lo, hi - lo))
        return sd.pad_pupil(
            torch.from_numpy(np.ascontiguousarray(W.real)).to(dev),
            torch.from_numpy(np.ascontiguousarray(W.imag)).to(dev),
            torch.from_numpy(np.ascontiguousarray(pm.T, np.float32)).to(dev))

    def randn(shape, rms):
        return torch.randn(shape, device=dev, generator=gen) * rms

    out = []

    def run(label, kernel, call, reps, N, npup, nb, pass1_flops):
        ms = cuda_ms(call, reps)
        _, busy, per = device_breakdown(call)
        p1 = 1e3 * sum(v for k, v in per.items() if "pass1" in k)
        det = 1e3 * sum(v for k, v in per.items()
                        if "detect_pass" in k or "sum_tiles" in k)
        out.append({"what": label, "kernel": kernel, "draws": nb,
                    "kernel_ms": ms, "device_ms": 1e3 * busy,
                    "pass1_ms": p1, "detect_ms": det,
                    "pass1_tflops": pass1_flops / p1 / 1e9,
                    "detect_tflops": nb * 8 * npup ** 2 * N / det / 1e9})

    def laid(tab, split):
        # the table as the checkout's engine keeps it on the card
        if not hasattr(cd, "lay_tables"):
            return tab
        return cd.lay_tables_split(tab) if split else cd.lay_tables(tab)

    # K1, 512^2: a draw's factor product is N (1 x K) @ (K x 2 npup), K =
    # 256 rows ('mixed') or 2P ('gauss')
    N, lo, hi, nb = 512, 215, 297, 4096
    wr, wi, pm = tables(N, lo, hi)
    P = wr.shape[0]
    for mixed, K in ((True, 256), (False, 2 * P)):
        S = laid(randn((N, K, P, 2), 1.5 / (N * K) ** 0.5), False)
        run(f"K1 512^2, P=82, {('gauss', 'mixed')[mixed]}", "K1",
            lambda: cd.colfac_detect(SEED, S, wr, wi, pm, nb, mixed=mixed),
            5, N, hi - lo, nb, nb * N * 2 * K * 2 * (hi - lo))
        del S
    # K3, 1024^2 / 402 px: a draw's factor product is N complex (1 x Kq) @
    # (Kq x npup), as the real (1 x 2 Kq) @ (2 Kq x 2 npup); Kq = 512 lanes
    # ('mixed') or P ('gauss')
    N, lo, hi, nb = 1024, 311, 713, 630
    wr, wi, pm = tables(N, lo, hi)
    P = wr.shape[0]
    for mixed, Kq in ((True, 512), (False, P)):
        T = laid(randn((N, Kq, P, 2), 1.5 / (2 * N * Kq) ** 0.5), True)
        run(f"K3 1024^2, P=402, {('gauss', 'mixed')[mixed]}", "K3",
            lambda: cd.colfac_detect_split(SEED, T, wr, wi, pm, nb,
                                           mixed=mixed, LW=512),
            3, N, hi - lo, nb, nb * N * 2 * 2 * Kq * 2 * (hi - lo))
        del T
        torch.cuda.empty_cache()
    # K2: pass 1 is the 4 N^3 mixing product and 8 N^2 P for G'
    for N, lo, hi, nb, reps in ((256, 87, 169, 4096, 5),
                                (1024, 311, 713, 630, 3)):
        wr, wi, pm = tables(N, lo, hi)
        s_t = randn((N, N), 1.5 / N).abs().contiguous()
        mix = torch.from_numpy(sd.mixing_matrix(N).copy()).to(dev)
        run(f"K2 {N}^2, P={hi - lo}", "K2",
            lambda: sd.synth_detect(SEED, s_t, wr, wi, pm, nb, mix=mix),
            reps, N, hi - lo, nb,
            nb * (4 * N ** 3 + 8 * N * N * (hi - lo)))
    del s_t, mix, wr, wi, pm
    torch.cuda.empty_cache()

    # the runs: set-up, warm rates, peak memory
    import time
    import chip_smoke
    from fast_tpu_torch import Fast
    os.environ["FAST_TPU_TABLE_CACHE"] = "0"
    for label, params in (
            ("512^2 flagship, 'auto' (K1)",
             chip_smoke.flagship(NPXLS=512)),
            ("1024^2 / 4 m, pinned 'pallas_colfac' (K3)",
             chip_smoke.flagship(**chip_smoke.WIDE, NCHUNKS=4, SEED=3,
                                 SYNTH="pallas_colfac", NITER=8192))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim = Fast(params, device="cuda")
        init_s = time.perf_counter() - t0
        rates = []
        for _ in range(3):  # one cold, two warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            rates.append(sim.Niter / (time.perf_counter() - t0))
        out.append({"what": label, "run": True, "synth": sim._synth,
                    "init_s": init_s,
                    "tables_s": sim.timings.get("device_constants"),
                    "rates": rates[1:],
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        del sim
    return out


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])))
        return
    roots = sys.argv[1:] or ["."]
    where = card()
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"measuring {root} failed")
        for r in json.loads(proc.stdout.strip().splitlines()[-1]):
            if r.get("run"):
                print(f"{root}: {r['what']}: {r['synth']}, Fast() "
                      f"{r['init_s']:.2f} s (tables {r['tables_s']:.3f} s), "
                      f"warm run() " + ", ".join(f"{x:.0f}" for x in
                                                 r["rates"])
                      + f" r/s, peak {r['peak_gb']:.2f} GB ({where})",
                      flush=True)
                continue
            print(f"{root}: {r['what']}, {r['draws']} draws: kernel "
                  f"{r['kernel_ms']:.3f} ms; profiled device "
                  f"{r['device_ms']:.3f} ms: pass 1 {r['pass1_ms']:.3f} ms "
                  f"({r['pass1_tflops']:.1f} TFLOP/s), detect pass "
                  f"{r['detect_ms']:.3f} ms ({r['detect_tflops']:.1f} "
                  f"TFLOP/s) ({where})", flush=True)
    print(where)


if __name__ == "__main__":
    main()
