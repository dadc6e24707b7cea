"""What bounds pass 1 of K2 and K7 on the card: the kernel timed beside
variants of itself with one part of its work taken out.

    python scripts/torch_pass1_variants.py [variant ...]

Each variant is csrc/synth_detect.cu with one function body replaced,
built by nvcc (the package's flags) into build/pass1_variants/ and timed
through its ``fast_synth_pass1`` entry at chip_smoke.py's shapes (256^2,
P=82 over 4096 draws; 1024^2, P=402 over 630). The variants compute wrong
numbers on purpose; only their times mean anything:

  base       the kernel as it is
  one_mma    one TF32 product a step instead of three (and no lo parts)
  no_mma     each 3xTF32 step replaced by four FFMA on the same operands:
             the time without the tensor cores' work
  no_split   hi = x, lo = 0: the three products without the split
  no_philox  a two-multiply hash in place of Philox4x32-10

Prints one line per shape and noise, with the card's name and power limit.
"""

import ctypes
import os
import sys

import numpy as np
import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import (build, card, cuda_ms, read_sources,
                            replace_body, replace_once)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops import synth_detect as sd
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "pass1_variants")
HASH = """
__device__ __forceinline__ fast::U4 hash_bits(uint32_t c0, uint32_t c1,
                                              uint32_t, uint32_t,
                                              uint32_t k0, uint32_t) {
  const uint32_t h = (c0 * 0x9E3779B9u) ^ (c1 * 0x85EBCA6Bu) ^ k0;
  return {h, h * 0xC2B2AE35u, 0u, 0u};
}
#define philox4x32_10 hash_bits
"""


def variants(src, tf32x3):
    """{name: (kernel source, tf32x3.cuh source)}."""
    fma = "".join(
        f"\n  big[{v}] = fmaf(__uint_as_float(ah[{v}] ^ al[{v}]), "
        f"__uint_as_float(bh[{v % 2}] ^ bl[{v % 2}]), big[{v}]);"
        for v in range(4))
    return {
        "base": (src, tf32x3),
        "one_mma": (replace_body(
            src, "mma3", "\n  float d[4];\n  mma_tf32_new(d, ah, bh);"
            "\n  for (int v = 0; v < 4; ++v) big[v] += d[v];", "one_mma"),
            tf32x3),
        "no_mma": (replace_body(src, "mma3", fma, "no_mma"), tf32x3),
        "no_split": (src, replace_body(
            tf32x3, "split", "\n  hi = __float_as_uint(x);\n  lo = 0u;",
            "no_split")),
        "no_philox": (replace_once(src, r'#include "detect\.cuh"\n',
                                   '#include "detect.cuh"\n' + HASH,
                                   "no_philox"), tf32x3),
    }


def main():
    todo = variants(*read_sources("synth_detect"))
    if sys.argv[1:]:
        todo = {k: v for k, v in todo.items() if k in sys.argv[1:]}
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    libs = {name: fn for name, (fn, _) in build(
        OUT, todo, _build._NVCC_FLAGS, "fast_synth_pass1",
        [u, u, u, i, i, p, p, p, p, p, p, i, i, i, p]).items()}
    dev = torch.device("cuda")
    where = card()
    for N, lo, hi, nb in ((256, 87, 169, 4096), (1024, 311, 713, 630)):
        rng = np.random.default_rng(5)
        s_t = torch.from_numpy((rng.random((N, N)) * 1e-2).astype(
            np.float32)).to(dev)
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        wr, wi, _ = sd.pad_pupil(
            torch.from_numpy(np.ascontiguousarray(W.real)).to(dev),
            torch.from_numpy(np.ascontiguousarray(W.imag)).to(dev), None)
        mix = torch.from_numpy(sd.mixing_matrix(N).copy()).to(dev)
        P = wr.shape[0]
        g = torch.empty((2, nb, N, P), device=dev)
        for noise in ("mixed", "gauss"):
            m = mix if noise == "mixed" else None
            rows = sd._rows_per_thread(N, P, m is not None)
            res = []
            for name, fn in libs.items():
                def call():
                    err = fn(
                        1, 2, 0, 0, nb, s_t.data_ptr(), wr.data_ptr(),
                        wi.data_ptr(), None if m is None else m.data_ptr(),
                        g[0].data_ptr(), g[1].data_ptr(), N, P, rows,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                res.append(f"{name} {cuda_ms(call, 5 if N <= 256 else 2):.3f}")
            print(f"pass 1 {noise} {N}^2, P={hi - lo}, {nb} draws, ms: "
                  + ", ".join(res) + f" ({where})", flush=True)


if __name__ == "__main__":
    main()
