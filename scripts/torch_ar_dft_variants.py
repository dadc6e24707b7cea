"""What bounds the AR kernels' first DFT product (``ar_dft``) on the card:
the stage timed beside variants of itself with one part of its work taken
out.

    python scripts/torch_ar_dft_variants.py [variant ...]

Each variant is csrc/ar_flow.cu (with csrc/tf32x3.cuh) with one piece of
code replaced, built by nvcc (the package's flags for ar_flow.cu; the
harness of scripts/torch_variants.py) into build/ar_dft_variants/ and
timed through its ``fast_ar_dft`` entry (the
W split, then ``ar_dft``) at chip_smoke.py's shapes: 256^2, P=82 (padded
to 96) over one tile of 256 (step, series) pairs, and 1024^2, P=402
(padded to 416) over one of 16. The variants compute wrong numbers on
purpose; only their times mean anything:

  base       the stage as it is
  one_mma    the two a_hi b_hi products of an output tile and step
             instead of six (no lo parts): one TF32 pass
  no_mma     each output tile's six products replaced by eight FFMA on
             the same operands: the time without the tensor cores' work
  no_split   hi = x, lo = 0: the six products without the split
  w_once     one pair of W fragment loads a step for every tile, instead
             of one a tile: the time without most shared loads of W

Prints ptxas's registers and spills for each variant's two ar_dft
instantiations on the main path (PJ=6 at 256^2 and 512^2, PJ=7 in groups
at 1024^2), then one line per shape with the card's name and power limit;
the rates count the pupil's own px (82, 402), not the padded tile.
"""

import ctypes
import os
import re
import sys

import numpy as np
import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import (build, card, cuda_ms, find_once, ptxas,
                            read_sources, replace_body, replace_once)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops.synth_detect import pad_pupil
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "ar_dft_variants")
FLAGS = _build._NVCC_FLAGS + _build._EXTRA_FLAGS["ar_flow"]
# the products of one output tile and step, as ar_dft has them
PRODUCTS = (r"        float d\[4\];\n        mma_tf32_new.*?"
            r"acc\[1\]\[nt\]\[v\] \+= d\[v\];")
# the two W fragment loads of a tile and step, and the loop over the tiles
W_LOADS = (r"(        const uint4 r4 = [^;]*;\n"
           r"        const uint4 i4 = [^;]*;\n)")
TILE_LOOP = "#pragma unroll\n      for (int nt = 0; nt < NT; ++nt) {"


def _fma(out, pairs):
    """Eight FFMA on the operands of the six products, into acc[out]."""
    return "".join(
        f"\n        acc[{out}][nt][{v}] = fmaf(__uint_as_float({a}[{v}]), "
        f"__uint_as_float({b}[{v % 2}]), acc[{out}][nt][{v}]);"
        for a, b in pairs for v in range(4))


def variants(src, tf32x3):
    """{name: (ar_flow.cu source, tf32x3.cuh source)}."""
    one = ("        float d[4];\n"
           "        mma_tf32_new(d, ah[0], rh);\n"
           "        mma_tf32(d, nh, ih);\n"
           "#pragma unroll\n"
           "        for (int v = 0; v < 4; ++v) acc[0][nt][v] += d[v];\n"
           "        mma_tf32_new(d, ah[0], ih);\n"
           "        mma_tf32(d, ah[1], rh);\n"
           "#pragma unroll\n"
           "        for (int v = 0; v < 4; ++v) acc[1][nt][v] += d[v];")
    fma = (_fma(0, (("ah[0]", "rh"), ("nl", "il")))
           + _fma(1, (("ah[1]", "rl"), ("al[0]", "ih"))))
    loads = find_once(W_LOADS, src, "w_once").group(1)
    w_once = replace_once(
        replace_once(src, W_LOADS, "", "w_once"), re.escape(TILE_LOOP),
        loads.replace("(nt * KS + ks)", "ks") + TILE_LOOP, "w_once")
    return {
        "base": (src, tf32x3),
        "one_mma": (replace_once(src, PRODUCTS, one, "one_mma"), tf32x3),
        "no_mma": (replace_once(src, PRODUCTS, fma, "no_mma"), tf32x3),
        "no_split": (src, replace_body(
            tf32x3, "split", "\n  hi = __float_as_uint(x);\n  lo = 0u;",
            "no_split")),
        "w_once": (w_once, tf32x3),
    }


def main():
    todo = variants(*read_sources("ar_flow"))
    if sys.argv[1:]:
        todo = {k: v for k, v in todo.items() if k in sys.argv[1:]}
    p, i = ctypes.c_void_p, ctypes.c_int
    built = build(OUT, todo, FLAGS, "fast_ar_dft", [i] + [p] * 7 + [i, i, p])
    # ptxas of the instantiations the main path runs: PJ = 6, one group (P
    # = 96 at 256^2 and 512^2), and PJ = 7 in groups (P = 416 at 1024^2)
    for name, (_, log) in built.items():
        regs = ptxas(log, "ar_dft")
        for key, what in (("6, 1", "PJ=6"), ("7, 0", "PJ=7 in groups")):
            print(f"ptxas {name}: ar_dft {what}: {regs.get(key)}")
    dev = torch.device("cuda")
    where = card()
    for N, lo, hi, nj in ((256, 87, 169, 256), (1024, 311, 713, 16)):
        rng = np.random.default_rng(5)
        a = torch.from_numpy((rng.normal(size=(2, nj, N, N)) * 0.5 / N)
                             .astype(np.float32)).to(dev)
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        wr, wi, _ = pad_pupil(
            torch.from_numpy(np.ascontiguousarray(W.real)).to(dev),
            torch.from_numpy(np.ascontiguousarray(W.imag)).to(dev), None)
        P = wr.shape[0]
        ws = torch.empty((P, -(-N // 32) * 32, 4), dtype=torch.int32,
                         device=dev)
        g = torch.empty((2, nj, N, P), device=dev)
        # the work counts the pupil's own hi - lo px: W's padded rows are
        # zeros and add nothing to G'
        flops = 8 * (hi - lo) * N * N * nj
        res = []
        for name, (fn, _) in built.items():
            def call():
                err = fn(nj, wr.data_ptr(), wi.data_ptr(), a[0].data_ptr(),
                         a[1].data_ptr(), ws.data_ptr(), g[0].data_ptr(),
                         g[1].data_ptr(), N, P,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = cuda_ms(call, 20 if N <= 256 else 5)
            res.append(f"{name} {ms:.3f} ({flops / ms / 1e9:.1f} TFLOP/s)")
        print(f"ar_dft {N}^2, P={hi - lo}, {nj} pairs, ms: " + ", ".join(res)
              + f" ({where})", flush=True)


if __name__ == "__main__":
    main()
