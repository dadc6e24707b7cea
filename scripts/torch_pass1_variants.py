"""What bounds pass 1 of K2 and K7 on the card: the kernel timed beside
variants of itself with one part of its work taken out.

    python scripts/torch_pass1_variants.py [variant ...]

Each variant is csrc/synth_detect.cu with one piece of its pass 1 (or of
the wgmma.cuh and tf32x3.cuh it includes) replaced
(``torch_variants.wgmma_variants``), built by nvcc (the package's flags)
into build/pass1_variants/ and timed
through its ``fast_synth_pass1`` entry at chip_smoke.py's shapes (256^2,
P=82 over 4096 draws; 1024^2, P=402 over 630). The variants compute wrong
numbers on purpose; only their times mean anything:

  base       the kernel as it is
  one_mma    one TF32 wgmma a step instead of three (a_hi b_hi only)
  no_mma     no wgmma: each fold group's products replaced by a few
             instructions on the same A fragments (the tables still land
             in shared memory): the time without the tensor cores' work
  no_split   hi = x, lo = 0 for A: the three products without the split
  no_philox  a two-multiply hash in place of Philox4x32-10
  half_copy  each bulk copy of a B stage moves half its bytes: the time
             with half the traffic from L2 into shared memory

Prints ptxas's registers and spills of each variant's pass 1 at the two
shapes' pupil slices (PB = 96 and 208) and one line per shape and noise,
with the card's name and power limit.
"""

import ctypes
import os
import sys

import numpy as np
import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import build, card, cuda_ms, ptxas, wgmma_variants
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops import synth_detect as sd
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "pass1_variants")


def main():
    todo = wgmma_variants("synth_detect")
    if sys.argv[1:]:
        todo = {k: v for k, v in todo.items() if k in sys.argv[1:]}
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    built = build(OUT, todo, _build._NVCC_FLAGS, "fast_synth_pass1",
                  [u, u, u, i, i, p, p, p, p, p, i, i, i, p])
    for name, (_, log) in built.items():
        regs = ptxas(log, "synth_pass1", 3)
        for mixed in (1, 0):
            for nch, tail in ((1, 32), (3, 16)):
                # 'mixed' over two slices of 208 px runs as pairs
                k = f"{mixed}, {int(mixed and nch == 3)}, {nch}, {tail}"
                print(f"ptxas {name}: synth_pass1 "
                      f"{('gauss', 'mixed')[mixed]} PB={64 * nch + tail}: "
                      f"{regs.get(k)}")
    libs = {name: fn for name, (fn, _) in built.items()}
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
            wpack, mpack = sd.pass1_tables(wr, wi,
                                           mix if noise == "mixed" else None)
            res = []
            for name, fn in libs.items():
                def call():
                    err = fn(
                        1, 2, 0, 0, nb, s_t.data_ptr(), wpack.data_ptr(),
                        None if mpack is None else mpack.data_ptr(),
                        g[0].data_ptr(), g[1].data_ptr(), N, P, 3,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                res.append(f"{name} {cuda_ms(call, 5 if N <= 256 else 2):.3f}")
            print(f"pass 1 {noise} {N}^2, P={hi - lo}, {nb} draws, ms: "
                  + ", ".join(res) + f" ({where})", flush=True)


if __name__ == "__main__":
    main()
