"""What bounds the second pass of the iid kernels on the card: the detect
pass (K1, K2, K3) and K7's screens pass, each timed beside variants of
itself with one part of its work taken out.

    python scripts/torch_detect_variants.py [--detect | --screens] [variant ...]

Both passes are H^T = G'^T W^T on wgmma.cuh's fold groups
(csrc/detect.cuh), so their variants are
``torch_variants.wgmma_variants``'s (but no_philox: the pass draws no
noise) and four of their own:

  base         the pass as it is
  one_mma      one TF32 wgmma a step instead of three (a_hi b_hi only)
  no_mma       no wgmma: each fold group's products replaced by a few
               instructions on the same A fragments (the operands still
               land in shared memory): the time without the tensor cores
  no_split     hi = x, lo = 0 for A (G'), whose split is the pass's own
  half_copy    each bulk copy of a W step moves half its bytes: the time
               with half the W traffic from L2 into shared memory
  no_epilogue  the detect pass sums H^T as it is, no sincos and no pm_t;
               the screens pass stores only the first column of each pair
  stages4      a ring of 4 W steps at every slice width (8 up to 128 px)
  one_atile    one A tile in flight, not two or three: its copy no longer
               overlaps the products of the tile before
  no_persist   a block of the grid for each block of work, not one
               persistent block a SM: no block's loads overlap the
               epilogue of the one before

Each variant is built by nvcc with the package's flags (the harness of
scripts/torch_variants.py) into build/detect_variants/ and timed through
the pass's own C entry (``fast_detect_pass`` of csrc/colfac_detect.cu,
``fast_screens_pass`` of csrc/synth_detect.cu; ``--detect`` or
``--screens`` times that pass alone) on random G' of the main
paths' shapes: the detect pass at 256^2 and 512^2 with the flagships'
82 px pupil (96 padded) per 4096 draws and at 1024^2 with the 4 m link's
402 px (416 padded, two slices of 208) per 630; the screens pass at
1024^2, 402 px, per 630. The variants compute wrong numbers on purpose;
only their times mean anything. Prints ptxas's registers and spills of
each variant at the two slice widths (PB = 96, 208) and the instantiations
whose wgmma ptxas serialized, then one line per pass and shape with the
card's name and power limit; rates count the pupil's own px (82, 402).
"""

import ctypes
import os
import sys

import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import (build, card, cuda_ms, ptxas, read_source,
                            replace_once, serialized, wgmma_variants)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops import synth_detect as sd
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "detect_variants")


def variants(name):
    """{variant: {file: text}} of csrc/<name>.cu's second pass."""
    out = wgmma_variants(name)
    del out["no_philox"]
    det = read_source("detect.cuh")
    out["no_epilogue"] = {"k.cu": out["base"]["k.cu"], "detect.cuh": (
        replace_once(replace_once(
            det, r"float s, c;\s*sincos_cw\(v, &s, &c\);\s*"
            r"const float w = pm\[idx\];\s*acc\[0\] = fmaf\(w, c, acc\[0\]\);"
            r"\s*acc\[1\] = fmaf\(w, s, acc\[1\]\);",
            "acc[0] += v;\n      acc[1] += idx;", "no_epilogue"),
            r"if \(even\) \{\s*\*reinterpret_cast<float2\*>\(o\) = "
            r"make_float2\(v0, v1\);\s*\} else \{\s*o\[0\] = v0;\s*"
            r"if \(p1 \+ 1 < npup\) o\[1\] = v1;\s*\}",
            "o[0] = v0 + v1;", "no_epilogue"))}
    out["stages4"] = {"k.cu": out["base"]["k.cu"], "detect.cuh": replace_once(
        det, r"return PB <= 128 \? 8 : 4;", "return 4;", "stages4")}
    out["one_atile"] = {"k.cu": out["base"]["k.cu"],
                        "detect.cuh": replace_once(
                            det, r"return PB <= 128 \? 2 : 3;",
                            "return 1;", "one_atile")}
    out["no_persist"] = {"k.cu": out["base"]["k.cu"],
                         "detect.cuh": replace_once(
                             det, r"return dim3\(nblk < sms \? nblk : sms\);",
                             "return dim3(nblk);", "no_persist")}
    return out


def main():
    want = {a for a in sys.argv[1:] if not a.startswith("--")}
    only = {a[2:] for a in sys.argv[1:] if a.startswith("--")}
    p, i = ctypes.c_void_p, ctypes.c_int
    groups = [g for g in (
        ("detect pass", "colfac_detect", "detect_pass", "fast_detect_pass",
         [i, p, p, p, p, p, p, p, i, i, p]),
        ("screens pass", "synth_detect", "screens_pass", "fast_screens_pass",
         [i, p, p, p, p, p, i, i, i, p]))
        if not only or g[0].split()[0] in only]
    built = {}
    for label, src, kernel, entry, argtypes in groups:
        todo = variants(src)
        if want:
            todo = {k: v for k, v in todo.items() if k in want | {"base"}}
        fns = build(os.path.join(OUT, kernel), todo, _build._NVCC_FLAGS,
                    entry, argtypes)
        for name, (_, log) in fns.items():
            regs, warned = ptxas(log, kernel), serialized(log, kernel)
            for k in ("1, 32", "3, 16"):
                print(f"ptxas {name}: {kernel} PB={64 * int(k[0]) + int(k[3:])}"
                      f": {regs.get(k)}"
                      + (f"; wgmma serialized ({', '.join(warned[k])})"
                         if k in warned else ""))
            print(f"ptxas {name}: {kernel} instantiations with wgmma "
                  f"serialized: {sorted(warned) or 'none'}")
        built[label] = {name: fn for name, (fn, _) in fns.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    where = card()
    cs = torch.cuda.current_stream().cuda_stream
    shapes = (("detect pass", 256, 87, 169, 4096, 10),
              ("detect pass", 512, 215, 297, 4096, 10),
              ("detect pass", 1024, 311, 713, 630, 3),
              ("screens pass", 1024, 311, 713, 630, 3))
    for label, N, lo, hi, nb, reps in shapes:
        if label not in built:
            continue
        W = pruned_ift2_matrix(N, lo, hi, dtype="complex64")
        wr, wi, _ = sd.pad_pupil(torch.from_numpy(W.real.copy()).to(dev),
                                 torch.from_numpy(W.imag.copy()).to(dev),
                                 None)
        P, npup = wr.shape[0], hi - lo
        wpack = sd.laid_w(wr, wi).wpack
        pm = torch.rand((P, P), device=dev, generator=gen)
        g = torch.randn((2, nb, N, P), device=dev, generator=gen)
        g.mul_(1.5 / (N ** 0.5 * float(torch.complex(wr, wi).abs().max())))
        if label == "detect pass":
            out = torch.empty((nb, 4), device=dev)
            part = torch.empty((nb, sd.detect_parts(P), 4), device=dev)
            args = (pm.data_ptr(), None, part.data_ptr(), out.data_ptr(),
                    N, P, cs)
        else:
            scr = torch.empty((2, nb, npup, npup), device=dev)
            args = (scr[0].data_ptr(), scr[1].data_ptr(), N, P, npup, cs)

        def call(fn):
            def go():
                err = fn(nb, wpack.data_ptr(), g[0].data_ptr(),
                         g[1].data_ptr(), *args)
                if err:
                    raise RuntimeError(f"{label}: CUDA error {err}")
            return go
        flops = nb * 8 * npup ** 2 * N
        res = []
        for name, fn in built[label].items():
            ms = cuda_ms(call(fn), reps)
            res.append(f"{name} {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s)")
        print(f"{label} {N}^2, P={npup}, {nb} draws, ms: " + ", ".join(res)
              + f" ({where})", flush=True)
        del g, args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
