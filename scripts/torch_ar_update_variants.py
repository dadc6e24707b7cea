"""What bounds the AR kernels' update pass (``ar_update`` of
csrc/ar_flow.cu: the recurrence, the boiling noise and the layer sum) on
the card: the pass timed beside variants of itself, the card's Philox
rate, and the integer multiplies of one Philox call.

    python scripts/torch_ar_update_variants.py [variant ...]

Variants (csrc/ar_flow.cu with one piece replaced, built by nvcc with the
package's flags for ar_flow.cu, the harness of scripts/torch_variants.py,
into build/ar_update_variants/); all but base compute other bits on
purpose, only their times mean anything:

  base       the pass as it is: one Philox4x32-10 call serves a pair of
             steps (words 0, 1 the even step's, 2, 3 the odd one's)
  per_step   one Philox call every step, two of its words used: the
             noise's cost before the pairing
  min3       the pass with registers capped for 3 blocks of 256 threads
             a SM (__launch_bounds__(256, 3)): more warps to hide
             latency at 8 layers a thread
  no_philox  a two-multiply hash of the counter in place of Philox4x32-10

Each is run through its ``fast_ar_flow`` entry once under
``torch.profiler`` at scripts/torch_ar_ab.py's shapes with 'uniform'
boiling (K4 256^2 and 4 layers, K6 16 series of it, also at tiles of 16
and 64 steps, K5 512^2 and 16 layers in blocks of 4 and 8, K4 1024^2
and 4 layers; 256 steps each) and ``ar_update``'s device time is read
beside the whole call's, with the Philox calls a second
it made (per_step: one per (step, series, layer, mode); base: half). A
micro-kernel of chained Philox calls gives the card's rate; cuobjdump
counts the integer multiplies (IMAD and IMUL, not IMAD.MOV) that nvcc
emits for one call. Prints ptxas's registers and spills of ar_update at
4 and 8 layers a thread, then one line per shape, with the card's name
and power limit.
"""

import collections
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import (HASH, build, card, cuda_ms, ptxas, read_source,
                            replace_once)
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops import ar_flow as af
from fast_tpu_torch.ops.synth_detect import detect_parts, laid_w
from fast_tpu_torch.synthesis import pruned_ift2_matrix
from fast_tpu_torch.utils.profiling import device_breakdown

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "ar_update_variants")
FLAGS = _build._NVCC_FLAGS + _build._EXTRA_FLAGS["ar_flow"]
# (label, series, N, pupil rows lo..hi, layers, layers a thread, steps a
# tile, None for ops/ar_flow.tile_steps's)
SHAPES = [("K4 256^2, 4 layers", 1, 256, 87, 169, 4, 4, None),
          ("K6 16 x 256^2, 4 layers", 16, 256, 87, 169, 4, 4, None),
          ("K6 16 x 256^2, 4 layers, tile 16", 16, 256, 87, 169, 4, 4, 16),
          ("K6 16 x 256^2, 4 layers, tile 64", 16, 256, 87, 169, 4, 4, 64),
          ("K5 512^2, 16 layers, lb 4", 1, 512, 215, 297, 16, 4, None),
          ("K5 512^2, 16 layers, lb 8", 1, 512, 215, 297, 16, 8, None),
          ("K4 1024^2, 4 layers", 1, 1024, 311, 713, 4, 4, None)]
NSTEPS = 256

# chained Philox calls, one chain a thread: the card's rate of calls
RATE = r'''
#include "common.cuh"
namespace {
__global__ void philox_chain(uint32_t* out, int iters, uint32_t k0,
                             uint32_t k1) {
  const uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  fast::U4 v = {e, 7u, 0u, 2u};
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i) {
    v = fast::philox4x32_10(v.x ^ e, v.y, static_cast<uint32_t>(i), 2u, k0,
                            k1);
    acc ^= v.z + v.w;
  }
  out[e] = acc ^ v.x ^ v.y;
}
}  // namespace
extern "C" int fast_philox_rate(uint32_t* out, int n, int iters,
                                void* stream) {
  philox_chain<<<n / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters, 0x12345678u, 0x9abcdefu);
  return static_cast<int>(cudaGetLastError());
}
// one call, for counting its instructions
extern "C" __global__ void philox_one(const uint4* in, uint4* out,
                                      uint32_t k0, uint32_t k1) {
  const uint4 c = in[threadIdx.x];
  const fast::U4 v = fast::philox4x32_10(c.x, c.y, c.z, c.w, k0, k1);
  out[threadIdx.x] = make_uint4(v.x, v.y, v.z, v.w);
}
'''


def variants():
    """{name: {file: text}} of csrc/ar_flow.cu's update pass."""
    src = read_source("ar_flow.cu")
    return {
        "base": {"k.cu": src},
        "per_step": {"k.cu": replace_once(
            src, r"const bool draw = !odd \|\| t == 0;",
            "const bool draw = true;", "per_step")},
        "min3": {"k.cu": replace_once(
            src, r"__global__ void __launch_bounds__\(kThreads\)\n"
            r"    ar_update\(", "__global__ void __launch_bounds__(kThreads, "
            "3)\n    ar_update(", "min3")},
        "no_philox": {"k.cu": replace_once(
            src, r'#include "detect\.cuh"\n', '#include "detect.cuh"\n'
            + HASH, "no_philox")},
    }


def multiplies_per_call(lib_dir):
    """{opcode: count} of the integer multiplies in the SASS of one
    Philox call (the philox_one kernel of RATE), by cuobjdump."""
    cubin = os.path.join(lib_dir, "one.cubin")
    nvcc = _build._nvcc()
    subprocess.run([nvcc, "-cubin", "-gencode", "arch=compute_90a,"
                    "code=sm_90a", "-O3", "-I", lib_dir, "-o", cubin,
                    os.path.join(lib_dir, "k.cu")], check=True)
    dump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([dump, "-sass", "-fun", "philox_one", cubin],
                          capture_output=True, text=True, check=True).stdout
    ops = collections.Counter()
    for line in sass.splitlines():
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if m and (m.group(1).startswith("IMAD") or
                  m.group(1).startswith("IMUL")) \
                and not m.group(1).startswith("IMAD.MOV"):
            ops[m.group(1)] += 1
    return dict(ops)


def main():
    want = set(sys.argv[1:])
    todo = variants()
    if want:
        todo = {k: v for k, v in todo.items() if k in want | {"base"}}
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    built = build(OUT, todo, FLAGS, "fast_ar_flow",
                  [u, u, u] + [i] * 7 + [p] * 13 + [i, i, i, p])
    for name, (_, log) in built.items():
        regs = ptxas(log, "ar_update")
        for key in ("4, 1", "8, 1", "8, 2"):
            print(f"ptxas {name}: ar_update<{key}>: {regs.get(key)}")
    rate = build(os.path.join(OUT, "rate"), {"one": {"k.cu": RATE}},
                 _build._NVCC_FLAGS, "fast_philox_rate", [p, i, i, p])
    rate_fn = rate["one"][0]
    mults = multiplies_per_call(os.path.join(OUT, "rate", "one"))
    per_call = sum(mults.values())
    where = card()
    dev = torch.device("cuda")
    cs = torch.cuda.current_stream().cuda_stream
    n, iters = 132 * 2048 * 4, 256
    buf = torch.empty(n, dtype=torch.int32, device=dev)

    def chain():
        err = rate_fn(buf.data_ptr(), n, iters, cs)
        if err:
            raise RuntimeError(f"philox_rate: CUDA error {err}")
    ms = cuda_ms(chain, 10)
    calls_s = n * iters / ms * 1e3
    print(f"Philox4x32-10: {per_call} integer multiplies a call {mults}; "
          f"chained calls {calls_s:.4g}/s ({calls_s * per_call:.4g} "
          f"multiplies/s) ({where})", flush=True)

    k0, k1 = 1, 0
    for label, B, N, lo, hi, L, lb, tile in SHAPES:
        rng = np.random.default_rng(5)
        shape = (B, L, N, N)
        a0 = (0.5 / N) * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
        ph = 0.99 * np.exp(1j * rng.uniform(-3, 3, shape))
        ns = (0.07 / N) * rng.random(shape)
        W = pruned_ift2_matrix(N, lo, hi, dtype=np.complex64)
        pm = rng.random((B, hi - lo, hi - lo))
        t = [torch.from_numpy(x.astype(np.complex64 if np.iscomplexobj(x)
                                       else np.float32)).to(dev)
             for x in (a0, ph, ns, W, pm)]
        st, ph2, ns32, wr, wi, pm_t = af._pack(*t, batch=True)
        P = wr.shape[0]
        wpack = laid_w(wr, wi).wpack
        tile = min(NSTEPS, tile or af.tile_steps(N, P, B))
        a = torch.empty((2, tile * B, N, N), device=dev)
        g = torch.empty((2, tile * B, N, P), device=dev)
        part = torch.empty((tile * B, detect_parts(P), 2), device=dev)
        out = torch.empty((NSTEPS, B, 2), device=dev)
        calls = {"per_step": B * L * N * N * NSTEPS}
        res = []
        for name, (fn, _) in built.items():
            def call():
                err = fn(k0, k1, 0, NSTEPS, tile, B, 0, L, lb, 1,
                         st[0].data_ptr(), st[1].data_ptr(),
                         ph2[0].data_ptr(), ph2[1].data_ptr(),
                         ns32.data_ptr(), wpack.data_ptr(), pm_t.data_ptr(),
                         a[0].data_ptr(), a[1].data_ptr(), g[0].data_ptr(),
                         g[1].data_ptr(), part.data_ptr(), out.data_ptr(),
                         N, P, 3, cs)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            _, busy, per = device_breakdown(call)
            upd = sum(v for k, v in per.items() if "ar_update" in k)
            n_calls = calls.get(name, calls["per_step"] // 2)
            txt = f"{name} {1e3 * upd:.3f} ms of {1e3 * busy:.3f}"
            if name != "no_philox":
                txt += f" ({n_calls / upd:.3g} calls/s)"
            res.append(txt)
        print(f"ar_update {label}, {NSTEPS} steps, tile {tile}: "
              + ", ".join(res) + f" ({where})", flush=True)
        del a, g, st
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
