"""What bounds pass 1 of K1 and K3 on the card: each pass timed beside
variants of itself with one part of its work taken out.

    python scripts/torch_colfac_variants.py [variant ...]

Pass 1 of K1 (csrc/colfac_detect.cu) and of K3 (csrc/colfac_split.cu)
runs on wgmma.cuh's fold groups, so its variants are
``torch_variants.wgmma_variants``'s (base, one_mma, no_mma, no_split,
no_philox, half_copy), and K3's also

  no_share   each block draws its own noise: clusters of one block, where
             the pupil's slices otherwise draw each tile once between them
  overlap    the next noise tile drawn while this one's products run with
             either noise (the kernel does so for 'mixed' only)

The detect pass that ends both (csrc/detect.cuh) has its own variants:
scripts/torch_detect_variants.py. Each variant is built by nvcc with the
package's flags (the harness of scripts/torch_variants.py) into
build/colfac_variants/ and timed through the pass's own C entry
(``fast_colfac_pass1``, ``fast_split_pass1``) at chip_smoke.py's shapes:
K1 at 512^2, P=82 (padded to 96), 4096 draws; K3 at 1024^2, P=402
(padded to 416), 630 draws; 'mixed' and 'gauss' noise, on random tables
laid out as the kernels read them. The variants compute wrong numbers on
purpose; only their times mean anything.

Prints ptxas's registers and spills of each variant's instantiation on
the main path and the instantiations whose wgmma ptxas serialized (its
C7511-C7519 warnings), then one line per pass, shape and noise with the
card's name and power limit; rates count the pupil's own px (82, 402).
"""

import ctypes
import os
import sys

import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import (build, card, cuda_ms, ptxas, replace_once,
                            serialized, wgmma_variants)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops.synth_detect import padded_pupil

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "colfac_variants")


def k3_variants():
    out = wgmma_variants("colfac_split")
    out["no_share"] = {"k.cu": replace_once(
        out["base"]["k.cu"], r"nz <= kMaxCluster \? nz : 1", "1",
        "no_share")}
    out["overlap"] = {"k.cu": replace_once(
        out["base"]["k.cu"], r"constexpr bool kOverlap = kMixed;",
        "constexpr bool kOverlap = true;", "overlap")}
    return out


def main():
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    groups = [
        ("K1 pass 1", "colfac_pass1", ["1, 6", "0, 6"], "fast_colfac_pass1",
         [u, u, u, i, i, p, p, p, i, i, i, i, p],
         wgmma_variants("colfac_detect")),
        ("K3 pass 1", "split_pass1", ["1, 3, 16", "0, 3, 16"],
         "fast_split_pass1", [u, u, u, i, i, p, p, p, i, i, i, i, i, p],
         k3_variants()),
    ]
    want = set(sys.argv[1:])
    built = {}
    for label, kernel, keys, entry, argtypes, todo in groups:
        if want:
            todo = {k: v for k, v in todo.items() if k in want | {"base"}}
        fns = build(os.path.join(OUT, kernel), todo, _build._NVCC_FLAGS,
                    entry, argtypes)
        for name, (_, log) in fns.items():
            regs, warned = ptxas(log, kernel), serialized(log, kernel)
            for k in keys:
                print(f"ptxas {name}: {kernel} {k}: {regs.get(k)}"
                      + (f"; wgmma serialized ({', '.join(warned[k])})"
                         if k in warned else ""))
            print(f"ptxas {name}: {kernel} instantiations with wgmma "
                  f"serialized: {sorted(warned) or 'none'}")
        built[label] = {name: fn for name, (fn, _) in fns.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    where = card()
    cs = torch.cuda.current_stream().cuda_stream


    def line(label, shape, flops, calls, reps):
        res = []
        for name, call in calls.items():
            ms = cuda_ms(call, reps)
            res.append(f"{name} {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s)")
        print(f"{label} {shape}, ms: " + ", ".join(res) + f" ({where})",
              flush=True)

    for label, N, lo, hi, nb, reps in (("K1 pass 1", 512, 215, 297, 4096, 10),
                                       ("K3 pass 1", 1024, 311, 713, 630, 3)):
        P = padded_pupil(hi - lo)
        g = torch.empty((2, nb, N, P), device=dev)
        for mixed in (1, 0):
            # K1: 256 rows ('mixed') or 2P; K3: 512 lanes or P
            K = (256 if mixed else 2 * P) if label == "K1 pass 1" else (
                512 if mixed else P)
            raw = torch.randn((N, K, P, 2), device=dev, generator=gen) * 1e-3
            tab = (cd.lay_tables(raw) if label == "K1 pass 1"
                   else cd.lay_tables_split(raw)).data
            del raw

            def call(fn):
                def go():
                    args = ((N, P, K, mixed) if label == "K1 pass 1"
                            else (N, P, K, 512, mixed))
                    err = fn(1, 2, 0, 0, nb, tab.data_ptr(), g[0].data_ptr(),
                             g[1].data_ptr(), *args, cs)
                    if err:
                        raise RuntimeError(f"{label}: CUDA error {err}")
                return go
            # pass 1 as the real (1 x K') @ (K' x 2 npup) product per
            # column, K' = K1's rows, K3's complex lanes as real ones
            rows = K if label == "K1 pass 1" else 2 * K
            line(f"{label} {('gauss', 'mixed')[mixed]}",
                 f"{N}^2, P={hi - lo}, {nb} draws",
                 nb * N * 2 * rows * 2 * (hi - lo),
                 {n: call(fn) for n, fn in built[label].items()}, reps)
            del tab
        del g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
