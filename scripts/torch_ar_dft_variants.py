"""What bounds the AR kernels' two products on the card: the first DFT
product (``ar_dft``) and the real-only detect pass (``ar_detect``), both
the second pass of csrc/detect.cuh, each timed beside variants of itself
with one part of its work taken out or its design changed.

    python scripts/torch_ar_dft_variants.py [variant ...]

Each variant is csrc/ar_flow.cu (with the headers) with one piece of code
replaced, built by nvcc (the package's flags for ar_flow.cu, -fmad=false
included; the harness of scripts/torch_variants.py) into
build/ar_dft_variants/ and timed through its ``fast_ar_dft`` and
``fast_ar_detect`` entries at the main paths' shapes, each over a tile
(ops/ar_flow.tile_steps) of (step, series) pairs and over a quarter of
one: 256^2, P=82 (padded to 96) over 1024 and 256, 512^2, P=82 over 256
and 64, 1024^2, P=402 (padded to 416, two W slices of 208) over 64 and
16. The variants compute wrong numbers on purpose; only their times mean
anything:

  base       the passes as they are
  one_mma    one TF32 wgmma a step instead of three (a_hi b_hi only)
  no_mma     no wgmma: each fold group's products replaced by a few
             instructions on the same A fragments: the time without the
             tensor cores' work
  no_split   hi = x, lo = 0 for the A operands (B is split before)
  half_copy  each bulk copy of a W step moves half its bytes
  det_both   (ar_detect only) the detect as the full two-screen pass: one
             row group a block of work, warpgroup 1 forming Im H^T, which
             is dropped
  det_idle   (ar_detect only) one row group a block of work, warpgroup 1
             idle (it takes and releases the W steps and A tiles)
  fmad       the base built without -fmad=false (the iid sources' flags)

Prints ptxas's registers and spills of each variant's ar_dft and
ar_detect at the two slice widths (PB = 96, 208) and the instantiations
whose wgmma ptxas serialized (C7511), then one line per pass and shape
with the yardstick (one complex64 torch.matmul of G' = A^T W^T for
ar_dft; the two real torch.matmul of Re(W G') for ar_detect; TF32 off)
and the card's name and power limit. Rates count the pupil's own px (82,
402), not the padded tile.
"""

import ctypes
import os
import sys

import numpy as np
import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import (build, card, cuda_ms, ptxas, read_source,
                            replace_once, serialized, wgmma_variants)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops.synth_detect import detect_parts, laid_w, pad_pupil
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "ar_dft_variants")
FLAGS = _build._NVCC_FLAGS + _build._EXTRA_FLAGS["ar_flow"]
# (N, pupil rows lo..hi, pairs): a tile of ops/ar_flow.tile_steps, and a
# quarter of one
SHAPES = [(256, 87, 169, 1024), (256, 87, 169, 256), (512, 215, 297, 256),
          (512, 215, 297, 64), (1024, 311, 713, 64), (1024, 311, 713, 16)]
IDLE = """
      if (kRG == 1 && wg == 1) {
        for (int q = 0; q < 8; ++q) {
          ring.take(it + q);
          ring.release(it + q);
        }
      } else {
        tile_products<NCH, TAIL, kPasses>(
            gb, gt, KTile<AS>{as + s * ATile + roff}, ring, it, part, r, t,
            [](int) {});
      }"""
PRODUCTS = (r"\n      tile_products<NCH, TAIL, kPasses>\(\s*gb, gt, KTile<AS>"
            r"\{as \+ s \* ATile \+ roff\}, ring, it, part, r, t,\s*"
            r"\[\]\(int\) \{\}\);")


def one_row_group(src, what):
    """ar_flow.cu with ar_detect on one row group a block of work, the
    warpgroup 1's epilogue returning at once."""
    src = replace_once(src, r"second_pass<NCH, TAIL, 2, kPasses>",
                       "second_pass<NCH, TAIL, 1, kPasses>", what)
    src = replace_once(src, r"(    const int R = r0 \+ \(\(tid >> 5\) & 3\) "
                       r"\* 16;  // the warp's rows\n)",
                       "    if (tid >= 128) return;\n"
                       "    const int R = r0 + ((tid >> 5) & 3) * 16;\n",
                       what)
    src = replace_once(src, r"second_pass_grid\(P, nj, w\.nz, 2\)",
                       "second_pass_grid(P, nj, w.nz)", what)
    src = replace_once(src, r"detect_smem\(PB, 2, kPasses\)",
                       "detect_smem(PB, 1, kPasses)", what)
    return src


def variants():
    """{variant: {file: text}} of csrc/ar_flow.cu's two products."""
    out = wgmma_variants("ar_flow")
    del out["no_philox"]
    src, det = out["base"]["k.cu"], read_source("detect.cuh")
    out["det_both"] = {"k.cu": one_row_group(src, "det_both")}
    out["det_idle"] = {"k.cu": one_row_group(src, "det_idle"),
                       "detect.cuh": replace_once(det, PRODUCTS, IDLE,
                                                  "det_idle")}
    return out


def main():
    want = set(sys.argv[1:])
    todo = variants()
    if want:
        todo = {k: v for k, v in todo.items() if k in want | {"base"}}
    p, i = ctypes.c_void_p, ctypes.c_int
    built = {}
    for flags, names in ((FLAGS, todo),
                         (_build._NVCC_FLAGS, {"fmad": todo["base"]}
                          if not want or "fmad" in want else {})):
        if names:
            for name, (fn, log) in build(OUT, names, flags, "fast_ar_dft",
                                         [i] + [p] * 5 + [i, i, i, p]).items():
                lib = ctypes.CDLL(os.path.join(OUT, name, "k.so"))
                det = lib.fast_ar_detect
                det.argtypes = [i, i] + [p] * 6 + [i, i, i, p]
                built[name] = (fn, det, log)
    for name, (_, _, log) in built.items():
        for kernel in ("ar_dft", "ar_detect"):
            regs, warned = ptxas(log, kernel, 3), serialized(log, kernel, 3)
            for k in ("1, 32", "3, 16"):
                print(f"ptxas {name}: {kernel} PB="
                      f"{64 * int(k[0]) + int(k[3:])}: {regs.get(k)}"
                      + (f"; wgmma serialized ({', '.join(warned[k])})"
                         if k in warned else ""))
            print(f"ptxas {name}: {kernel} instantiations with wgmma "
                  f"serialized: {sorted(warned) or 'none'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs = torch.cuda.current_stream().cuda_stream
    where = card()
    for N, lo, hi, nj in SHAPES:
        rng = np.random.default_rng(5)
        a = torch.from_numpy((rng.normal(size=(2, nj, N, N)) * 0.5 / N)
                             .astype(np.float32)).to(dev)
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        wr, wi, _ = pad_pupil(
            torch.from_numpy(np.ascontiguousarray(W.real)).to(dev),
            torch.from_numpy(np.ascontiguousarray(W.imag)).to(dev), None)
        P, npup = wr.shape[0], hi - lo
        wpack = laid_w(wr, wi).wpack
        g = torch.empty((2, nj, N, P), device=dev)
        pm_t = torch.rand((1, P, P), device=dev)
        part = torch.empty((nj, detect_parts(P), 2), device=dev)
        out = torch.empty((nj, 2), device=dev)
        Ac = torch.complex(a[0], a[1]).transpose(-2, -1)
        Wt = torch.complex(wr, wi).T.contiguous()
        Gc = Ac @ Wt
        gr, gi = Gc.real.contiguous(), Gc.imag.contiguous()
        # the work counts the pupil's own px: W's padded rows are zeros
        flops = {"ar_dft": 8 * npup * N * N * nj,
                 "ar_detect": 4 * npup * npup * N * nj}
        yard = {"ar_dft": cuda_ms(lambda: Ac @ Wt, 5),
                "ar_detect": cuda_ms(lambda: wr @ gr - wi @ gi, 5)}
        for kernel in ("ar_dft", "ar_detect"):
            res = []
            for name, (dft, det, _) in built.items():
                if kernel == "ar_dft" and name.startswith("det_"):
                    continue

                def call(dft=dft, det=det):
                    if kernel == "ar_dft":
                        err = dft(nj, wpack.data_ptr(), a[0].data_ptr(),
                                  a[1].data_ptr(), g[0].data_ptr(),
                                  g[1].data_ptr(), N, P, 3, cs)
                    else:
                        err = det(nj, 1, wpack.data_ptr(), gr.data_ptr(),
                                  gi.data_ptr(), pm_t.data_ptr(),
                                  part.data_ptr(), out.data_ptr(), N, P, 3,
                                  cs)
                    if err:
                        raise RuntimeError(f"{kernel} {name}: CUDA error "
                                           f"{err}")
                ms = cuda_ms(call, 20 if N <= 512 else 5)
                res.append(f"{name} {ms:.4f} "
                           f"({flops[kernel] / ms / 1e9:.1f} TFLOP/s)")
            print(f"{kernel} {N}^2, P={npup}, {nj} pairs, ms: "
                  + ", ".join(res) + f"; yardstick {yard[kernel]:.4f} "
                  f"({where})", flush=True)
        del a, g, Ac, Gc, gr, gi
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
