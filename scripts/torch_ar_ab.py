"""Times of the AR kernels K4, K5 and K6 and of their first DFT product
(``ar_dft``), on one card, for one or more checkouts of fast_tpu_torch,
in turns.

    python scripts/torch_ar_ab.py                     # this checkout
    python scripts/torch_ar_ab.py OLD . . OLD         # A/B, in turns

Each argument is the root of a checkout (a directory holding
``fast_tpu_torch/``); each is measured in a process of its own, in the
order given, so that two versions compare on one card within one call.
The shapes are chip_smoke.py's: K4 at the temporal flagship's (256^2, 4
layers, P=82 padded to 96) per 4096 steps, K6 at the temporal orbit
pass's (16 series of it) per 256 steps, K5 at the 16-layer 512^2 link's
per 256 steps and K4 at the 1024^2 link's 402 px pupil (padded to 416)
per 256 steps; 'uniform' boiling, inputs from a numpy seed; at every
``PRECISION`` of the products the checkout takes (``precision=``: one
TF32 pass at 'default', 3xTF32 at 'highest'; a checkout without it runs
3xTF32, reported as 'highest'). Each kernel is timed whole with CUDA
events, then run once under ``torch.profiler``,
which gives its passes' device time (``ar_dft`` is read this way in every
checkout: older ones have no entry for it alone); its rate counts the
pupil's own px (82, 402), not the padded tile. A checkout whose wrappers
take the laid W table (``laid=``) is given it, as the engine gives it.
Prints one line per measurement and the card's name and power limit.
"""

import inspect
import json
import os
import subprocess
import sys

import numpy as np

# (label, wrapper, series, N, pupil rows lo..hi, layers, steps a call)
CASES = [("K4 256^2, 4 layers, P=82", "ar_flow_fused", 1, 256, 87, 169, 4,
          4096),
         ("K6 16 x 256^2, 4 layers, P=82", "ar_flow_fused_batch", 16, 256,
          87, 169, 4, 256),
         ("K5 512^2, 16 layers, P=82", "ar_flow_streamed", 1, 512, 215, 297,
          16, 256),
         ("K4 1024^2, 4 layers, P=402", "ar_flow_fused", 1, 1024, 311, 713,
          4, 256)]
PASSES = ("ar_dft", "ar_update", "ar_detect")


def measure(root):
    """Times in this process of the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from fast_tpu_torch.ops import ar_flow as af
    from fast_tpu_torch.synthesis import pruned_ift2_matrix
    from fast_tpu_torch.utils.profiling import device_breakdown

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
    for label, entry, B, N, lo, hi, L, nsteps in CASES:
        rng = np.random.default_rng(5)
        shape = (B, L, N, N)
        a0 = (0.5 / N) * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
        ph = 0.99 * np.exp(1j * rng.uniform(-3, 3, shape))
        ns = (0.07 / N) * rng.random(shape)
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        pm = rng.random((B, hi - lo, hi - lo))
        args = [torch.from_numpy(x.astype(np.complex64 if np.iscomplexobj(x)
                                          else np.float32)).to(dev)
                for x in (a0, ph, ns, W, pm)]
        if B == 1:  # one series: no series axis
            args = [x if x.ndim == 2 else x[0] for x in args]
        fn = getattr(af, entry)
        params = inspect.signature(fn).parameters
        for prec in (("highest", "default") if "precision" in params
                     else ("highest",)):
            # the laid W table, as the engine passes it, where the
            # checkout's wrappers take one
            kw = {"precision": prec} if "precision" in params else {}
            if "laid" in params:
                from fast_tpu_torch.ops.synth_detect import laid_w, pad_pupil
                wr, wi, _ = pad_pupil(args[3].real.contiguous(),
                                      args[3].imag.contiguous(), None)
                kw["laid"] = laid_w(wr, wi, **kw) if kw else laid_w(wr, wi)

            def call():
                return fn(1, *args, nsteps, noise="uniform", **kw)

            ms = cuda_ms(call, 5 if N <= 512 else 3)
            _, busy, per = device_breakdown(call)
            parts = {p: 1e3 * sum(v for k, v in per.items() if p in k)
                     for p in PASSES}
            # the work counts the pupil's own hi - lo px: W's padded rows
            # are zeros and add nothing to G'
            flops = 8 * (hi - lo) * N * N * nsteps * B
            out.append({"what": f"{label}, {prec}", "steps": nsteps,
                        "kernel_ms": ms, "device_ms": 1e3 * busy,
                        **{f"{p}_ms": v for p, v in parts.items()},
                        "ar_dft_tflops": flops / parts["ar_dft"] / 1e9})
        del args
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
            print(f"{root}: {r['what']}, {r['steps']} steps: kernel "
                  f"{r['kernel_ms']:.3f} ms; profiled device "
                  f"{r['device_ms']:.3f} ms: ar_dft {r['ar_dft_ms']:.3f} ms "
                  f"({r['ar_dft_tflops']:.1f} TFLOP/s), ar_update "
                  f"{r['ar_update_ms']:.3f}, ar_detect "
                  f"{r['ar_detect_ms']:.3f} ({card})")
    print(card)


if __name__ == "__main__":
    main()
