"""What bounds the passes of K1 and K3 on the card: each pass timed beside
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

The detect pass of detect.cuh (shared by K1, K2 and K3) keeps its two:
base and one_mma (each output block's products of a step at one TF32
pass, a_hi b_hi only). Each variant is built by nvcc with the package's
flags (the harness of scripts/torch_variants.py) into
build/colfac_variants/ and timed through the pass's own C entry
(``fast_colfac_pass1``, ``fast_split_pass1``, ``fast_detect_pass``) at
chip_smoke.py's shapes: K1 at 512^2, P=82 (padded to 96), 4096 draws; K3
and the tiled detect pass at 1024^2, P=402 (padded to 416), 630 draws; the
detect pass also at K1's shape; pass 1 with 'mixed' and 'gauss' noise, on
random tables laid out as the kernels read them. The variants compute
wrong numbers on purpose; only their times mean anything.

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
from torch_variants import (build, card, cuda_ms, ptxas, read_sources,
                            read_source, replace_once, serialized,
                            wgmma_variants)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops import colfac_detect as cd
from fast_tpu_torch.ops.synth_detect import pad_pupil
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "colfac_variants")
DET_ONE = [(r"mma_tf32_new\(d, arl, brh\[j\]\);(\s*mma_tf32\(d, \w+, "
            r"\w+\[j\]\);){5}", "mma_tf32_new(d, arh, brh[j]);\n"
            "          mma_tf32(d, nh, bih[j]);"),
           (r"mma_tf32_new\(d, arl, bih\[j\]\);(\s*mma_tf32\(d, \w+, "
            r"\w+\[j\]\);){5}", "mma_tf32_new(d, arh, bih[j]);\n"
            "          mma_tf32(d, aih, brh[j]);")]


def patched(src, pairs, what):
    for pattern, new in pairs:
        src = replace_once(src, pattern, new, what)
    return src


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
    k1, tf32x3 = read_sources("colfac_detect")
    det = read_source("detect.cuh")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    groups = [
        ("K1 pass 1", "colfac_pass1", ["1, 6", "0, 6"], "fast_colfac_pass1",
         [u, u, u, i, i, p, p, p, i, i, i, i, p],
         wgmma_variants("colfac_detect")),
        ("K3 pass 1", "split_pass1", ["1, 3, 16", "0, 3, 16"],
         "fast_split_pass1", [u, u, u, i, i, p, p, p, i, i, i, i, i, p],
         k3_variants()),
        ("detect pass", "detect_pass", ["6, 1", "7, 0"], "fast_detect_pass",
         [i, p, p, p, p, p, p, p, p, i, i, p],
         {"base": (k1, tf32x3, det),
          "one_mma": (k1, tf32x3, patched(det, DET_ONE, "one_mma"))}),
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

    def tables(N, lo, hi):
        W = pruned_ift2_matrix(N, lo, hi, dtype="complex64")
        wr, wi, _ = pad_pupil(torch.from_numpy(W.real.copy()).to(dev),
                              torch.from_numpy(W.imag.copy()).to(dev), None)
        P = wr.shape[0]
        pm = torch.rand((P, P), device=dev, generator=gen)
        return wr, wi, pm, P

    def line(label, shape, flops, calls, reps):
        res = []
        for name, call in calls.items():
            ms = cuda_ms(call, reps)
            res.append(f"{name} {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s)")
        print(f"{label} {shape}, ms: " + ", ".join(res) + f" ({where})",
              flush=True)

    for label, N, lo, hi, nb, reps in (("K1 pass 1", 512, 215, 297, 4096, 10),
                                       ("K3 pass 1", 1024, 311, 713, 630, 3)):
        wr, wi, pm, P = tables(N, lo, hi)
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
        g.normal_(generator=gen)
        g.mul_(1.5 / (N ** 0.5 * float(torch.complex(wr, wi).abs().max())))
        out = torch.empty((nb, 4), device=dev)
        part = torch.empty((nb, (-(-P // 128)) ** 2, 4), device=dev)

        def det(fn):
            def go():
                err = fn(nb, wr.data_ptr(), wi.data_ptr(), g[0].data_ptr(),
                         g[1].data_ptr(), pm.data_ptr(), None,
                         part.data_ptr(), out.data_ptr(), N, P, cs)
                if err:
                    raise RuntimeError(f"detect pass: CUDA error {err}")
            return go
        line("detect pass", f"{N}^2, P={hi - lo}, {nb} draws",
             nb * 8 * (hi - lo) ** 2 * N,
             {n: det(fn) for n, fn in built["detect pass"].items()}, reps)
        del g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
