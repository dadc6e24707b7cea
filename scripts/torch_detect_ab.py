"""Times of the iid kernels' second pass (the detect pass of K1, K2 and K3,
K7's screens pass), of the four kernels whole and of their runs, on one
card, for one or more checkouts of fast_tpu_torch, in turns.

    python scripts/torch_detect_ab.py                     # this checkout
    python scripts/torch_detect_ab.py OLD . . OLD         # A/B, in turns

Each argument is the root of a checkout (a directory holding
``fast_tpu_torch/``); each is measured in a process of its own, in the
order given, so that two versions compare on one card within one call.
A checkout whose wrappers take the laid W table (``synth_detect.laid_w``)
gets it laid out once, before the clock, as its engine keeps it.

* The detect pass alone (``colfac_detect.detect_pass``, CUDA events) on a
  random G' with screens of about 1.5 rad rms: at 256^2 and 512^2 with
  the flagships' 82 px pupil (96 padded) per 4096 draws, at 1024^2 with
  the 4 m link's 402 px (416 padded) per 630.
* K7's screens pass alone at 1024^2, 402 px, per 630 draws: the
  ``screens_pass`` kernel's device time under ``torch.profiler`` in one
  K7 launch (the same way for every checkout: older ones have no entry
  for the pass alone).
* Each kernel whole (CUDA events): K2 'mixed' at 256^2 (4096 draws), K1
  'mixed' at 512^2 (4096), K3 'mixed' and K7 at 1024^2 (630), on random
  tables from a seed (the kernels' time does not depend on their values).
* The runs through these kernels, as chip_smoke.py makes them: the 256^2
  flagship through 'auto' (K2) and the 512^2 one through 'auto' (K1),
  262,144 realizations each; the 1024^2 link with the 4 m telescope
  through pinned 'pallas_colfac' (K3) and 'pallas' (K7), 8,192 each:
  ``Fast()``'s table seconds, two warm ``run()`` rates and the peak device
  memory of the init and the runs.

Rates count the pupil's own px (82, 402), as chip_smoke.py's bounds do.
Prints one line per measurement with the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import time

# torch_variants puts this checkout's root on the path; a measured
# checkout goes before it
from torch_variants import card, cuda_ms

SEED = 0x5EED_1234_ABCD


def measure(root):
    """Times in this process of the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    from fast_tpu_torch.ops import _build
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops import synth_detect as sd
    from fast_tpu_torch.synthesis import pruned_ift2_matrix
    from fast_tpu_torch.utils.profiling import device_breakdown

    _build.build_all(["synth_detect", "colfac_detect", "colfac_split"])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []

    def tables(N, lo, hi):
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        pm = np.random.default_rng(5).random((hi - lo, hi - lo))
        wr, wi, pm_t = sd.pad_pupil(
            torch.from_numpy(np.ascontiguousarray(W.real)).to(dev),
            torch.from_numpy(np.ascontiguousarray(W.imag)).to(dev),
            torch.from_numpy(np.ascontiguousarray(pm.T, np.float32)).to(dev))
        # the laid W table, as the checkout's engine keeps it
        lw = ({"laid": sd.laid_w(wr, wi, torch.from_numpy(
            sd.mixing_matrix(N).copy()).to(dev))}
              if hasattr(sd, "laid_w") else {})
        return wr, wi, pm_t, lw

    def randn(shape, rms):
        return torch.randn(shape, device=dev, generator=gen) * rms

    # the detect pass alone: 8 npup^2 N FLOP a draw
    for N, lo, hi, nb, reps in ((256, 87, 169, 4096, 10),
                                (512, 215, 297, 4096, 10),
                                (1024, 311, 713, 630, 3)):
        wr, wi, pm_t, lw = tables(N, lo, hi)
        P = wr.shape[0]
        g = randn((2, nb, N, P), 1.5 / (N ** 0.5 * float(
            torch.complex(wr, wi).abs().max())))
        ms = cuda_ms(lambda: cd.detect_pass(g[0], g[1], wr, wi, pm_t, **lw),
                     reps)
        out.append({"what": f"detect pass {N}^2, P={hi - lo}", "draws": nb,
                    "ms": ms,
                    "tflops": nb * 8 * (hi - lo) ** 2 * N / ms / 1e9})
        del g
        torch.cuda.empty_cache()

    def whole(label, call, reps, npup, N, nb):
        ms = cuda_ms(call, reps)
        _, busy, per = device_breakdown(call)
        second = 1e3 * sum(v for k, v in per.items()
                           if "detect_pass" in k or "sum_tiles" in k
                           or "screens_pass" in k)
        out.append({"what": label, "draws": nb, "kernel_ms": ms,
                    "device_ms": 1e3 * busy, "second_ms": second,
                    "second_tflops": nb * 8 * npup ** 2 * N / second / 1e9})

    # K2 at 256^2, K1 at 512^2 ('mixed')
    N, lo, hi, nb = 256, 87, 169, 4096
    wr, wi, pm_t, lw = tables(N, lo, hi)
    s_t = randn((N, N), 1.5 / N).abs().contiguous()
    mix = torch.from_numpy(sd.mixing_matrix(N).copy()).to(dev)
    whole("K2 256^2, P=82, mixed", lambda: sd.synth_detect(
        SEED, s_t, wr, wi, pm_t, nb, mix=mix, **lw), 5, hi - lo, N, nb)
    N, lo, hi, nb = 512, 215, 297, 4096
    wr, wi, pm_t, lw = tables(N, lo, hi)
    P = wr.shape[0]
    S = randn((N, 256, P, 2), 1.5 / (N * 256) ** 0.5)
    S = cd.lay_tables(S) if hasattr(cd, "lay_tables") else S
    whole("K1 512^2, P=82, mixed", lambda: cd.colfac_detect(
        SEED, S, wr, wi, pm_t, nb, mixed=True, **lw), 5, hi - lo, N, nb)
    del S
    # K3 and K7 at 1024^2 / 402 px
    N, lo, hi, nb = 1024, 311, 713, 630
    wr, wi, pm_t, lw = tables(N, lo, hi)
    P = wr.shape[0]
    T = randn((N, 512, P, 2), 1.5 / (2 * N * 512) ** 0.5)
    T = cd.lay_tables_split(T) if hasattr(cd, "lay_tables_split") else T
    whole("K3 1024^2, P=402, mixed", lambda: cd.colfac_detect_split(
        SEED, T, wr, wi, pm_t, nb, mixed=True, LW=512, **lw), 3, hi - lo, N,
        nb)
    del T
    torch.cuda.empty_cache()
    s_t = randn((N, N), 1.5 / N).abs().contiguous()
    whole("K7 1024^2, P=402", lambda: sd.synth_screens(
        SEED, s_t, wr, wi, nb, npup=hi - lo, **lw), 3, hi - lo, N, nb)
    del s_t
    torch.cuda.empty_cache()

    # the runs: set-up, warm rates, peak memory
    import chip_smoke
    from fast_tpu_torch import Fast
    os.environ["FAST_TPU_TABLE_CACHE"] = "0"
    wide = dict(**chip_smoke.WIDE, NCHUNKS=4, SEED=3, NITER=8192)
    for label, params in (
            ("256^2 flagship, 'auto' (K2)", chip_smoke.flagship()),
            ("512^2 flagship, 'auto' (K1)", chip_smoke.flagship(NPXLS=512)),
            ("1024^2 / 4 m, pinned 'pallas_colfac' (K3)",
             chip_smoke.flagship(**wide, SYNTH="pallas_colfac")),
            ("1024^2 / 4 m, 'pallas' (K7)",
             chip_smoke.flagship(**wide, SYNTH="pallas"))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = Fast(params, device="cuda")
        rates = []
        for _ in range(3):  # one cold, two warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            rates.append(sim.Niter / (time.perf_counter() - t0))
        out.append({"what": label, "run": True, "synth": sim._synth,
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
                print(f"{root}: {r['what']}: {r['synth']}, tables "
                      f"{r['tables_s']:.3f} s, warm run() "
                      + ", ".join(f"{x:.0f}" for x in r["rates"])
                      + f" r/s, peak {r['peak_gb']:.2f} GB ({where})",
                      flush=True)
            elif "kernel_ms" in r:
                print(f"{root}: {r['what']}, {r['draws']} draws: kernel "
                      f"{r['kernel_ms']:.3f} ms; profiled device "
                      f"{r['device_ms']:.3f} ms, second pass "
                      f"{r['second_ms']:.3f} ms ({r['second_tflops']:.1f} "
                      f"TFLOP/s) ({where})", flush=True)
            else:
                print(f"{root}: {r['what']}, {r['draws']} draws: {r['ms']:.3f}"
                      f" ms ({r['tflops']:.1f} TFLOP/s) ({where})",
                      flush=True)
    print(where)


if __name__ == "__main__":
    main()
