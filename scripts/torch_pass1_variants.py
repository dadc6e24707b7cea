"""What bounds pass 1 of K2 and K7 on the card: the kernel timed beside
variants of itself with one part of its work taken out.

    python scripts/torch_pass1_variants.py [--cell] [variant ...]

Each variant is csrc/synth_detect.cu with one piece of its pass 1 (or of
the wgmma.cuh and tf32x3.cuh it includes) replaced
(``torch_variants.wgmma_variants``), built by nvcc (the package's flags)
into build/pass1_variants/ and timed
through its ``fast_synth_pass1`` entry: first the instantiation that the
benchmark's ``flagship256.iid`` runs (256^2, P=82, 'mixed', one TF32
pass, PRECISION 'default': ``synth_pass1_ahead`` where
``ops/synth_detect.pass1_route`` says 'ahead'), then, unless ``--cell``,
3xTF32 at chip_smoke.py's shapes (256^2, P=82 over 4096 draws; 1024^2,
P=402 over 630) with either noise. The variants compute wrong numbers on
purpose; only their times mean anything:

  base       the kernel as it is
  one_mma    one TF32 wgmma a step instead of three (a_hi b_hi only; at
             one pass the same as base)
  no_mma     no wgmma: each fold group's products replaced by a few
             instructions on the same A fragments (the tables still land
             in shared memory): the time without the tensor cores' work
  no_split   hi = x, lo = 0 for A: the three products without the split
             (at one pass the same as base)
  no_philox  a two-multiply hash in place of Philox4x32-10
  half_copy  each bulk copy of a B stage moves half its bytes: the time
             with half the traffic from L2 into shared memory

Prints ptxas's registers and spills of each variant's pass 1 at the
shapes' pupil slices (PB = 96 and 208; the one-pass 'mixed' kernel at 96)
and one line per shape, noise and pass count, with the card's name and
power limit. Copied into another checkout's scripts/ with
torch_variants.py, it times that checkout's kernel.
"""

import ctypes
import os
import re
import sys

import numpy as np
import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import (build, card, cuda_ms, ptxas, serialized,
                            wgmma_variants)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops import synth_detect as sd
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "pass1_variants")


def main():
    args = sys.argv[1:]
    cell = "--cell" in args
    todo = wgmma_variants("synth_detect")
    names = [a for a in args if a != "--cell"]
    if names:
        todo = {k: v for k, v in todo.items() if k in names}
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    built = build(OUT, todo, _build._NVCC_FLAGS, "fast_synth_pass1",
                  [u, u, u, i, i, p, p, p, p, p, i, i, i, p])
    for name, (_, log) in built.items():
        ahead = ptxas(log, "synth_pass1_ahead")
        spills = {k: re.search(r"(\d+) bytes spill stores", v).group(1)
                  for k, v in ahead.items() if "spill stores" in v}
        print(f"ptxas {name}: synth_pass1_ahead PB=96: {ahead.get('1, 32')}"
              f"; spill stores by (NCH, TAIL): {spills} "
              f"serialized {serialized(log, 'synth_pass1_ahead')}; "
              f"synth_pass1 mixed PB=96 one pass: "
              f"{ptxas(log, 'synth_pass1', 1).get('1, 0, 1, 32')}")
        for mixed in (1, 0):
            for nch, tail in ((1, 32), (3, 16)):
                # 'mixed' over two slices of 208 px runs as pairs
                k = f"{mixed}, {int(mixed and nch == 3)}, {nch}, {tail}"
                print(f"ptxas {name}: synth_pass1 "
                      f"{('gauss', 'mixed')[mixed]} PB={64 * nch + tail}: "
                      f"{ptxas(log, 'synth_pass1', 3).get(k)}")
    libs = {name: fn for name, (fn, _) in built.items()}
    dev = torch.device("cuda")
    where = card()
    # (N, lo, hi, draws, noises, TF32 passes)
    runs = [(256, 87, 169, 4096, ("mixed",), 1)]
    if not cell:
        runs += [(256, 87, 169, 4096, ("mixed", "gauss"), 3),
                 (1024, 311, 713, 630, ("mixed", "gauss"), 3)]
    for N, lo, hi, nb, noises, npass in runs:
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
        for noise in noises:
            wpack, mpack = sd.pass1_tables(
                wr, wi, mix if noise == "mixed" else None, passes=npass)
            route = getattr(sd, "pass1_route", lambda *a: "inline")(
                N, P, noise == "mixed", npass)
            res = []
            for name, fn in libs.items():
                def call():
                    err = fn(
                        1, 2, 0, 0, nb, s_t.data_ptr(), wpack.data_ptr(),
                        None if mpack is None else mpack.data_ptr(),
                        g[0].data_ptr(), g[1].data_ptr(), N, P, npass,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                res.append(f"{name} {cuda_ms(call, 5 if N <= 256 else 2):.3f}")
            print(f"pass 1 {noise} {N}^2, P={hi - lo}, {nb} draws, "
                  f"{npass} pass{'es' if npass > 1 else ''} ({route}), ms: "
                  + ", ".join(res) + f" ({where})", flush=True)

if __name__ == "__main__":
    main()
