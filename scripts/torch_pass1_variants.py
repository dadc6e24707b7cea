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
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from fast_tpu_torch.ops import _build  # noqa: E402
from fast_tpu_torch.ops import synth_detect as sd  # noqa: E402
from fast_tpu_torch.synthesis import pruned_ift2_matrix  # noqa: E402

CSRC = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
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


def variants(src):
    def body(name, new):
        m = re.search(r"(__device__ __forceinline__ void " + name
                      + r"\(.*?\{)(.*?)(\n\})", src, re.S)
        return src[:m.start(2)] + new + src[m.end(2):]
    fma = "".join(
        f"\n  big[{v}] = fmaf(__uint_as_float(ah[{v}] ^ al[{v}]), "
        f"__uint_as_float(bh[{v % 2}] ^ bl[{v % 2}]), big[{v}]);"
        for v in range(4))
    return {
        "base": src,
        "one_mma": body("mma3", "\n  float d[4];\n  mma_tf32_new(d, ah, bh);"
                        "\n  for (int v = 0; v < 4; ++v) big[v] += d[v];"),
        "no_mma": body("mma3", fma),
        "no_split": body("split", "\n  hi = __float_as_uint(x);\n  lo = 0u;"),
        "no_philox": src.replace('#include "detect.cuh"\n',
                                 '#include "detect.cuh"\n' + HASH, 1),
    }


def build(name, src):
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for h in ("common.cuh", "detect.cuh"):
        with open(os.path.join(CSRC, h)) as f, \
                open(os.path.join(d, h), "w") as g:
            g.write(f.read())
    with open(os.path.join(d, "k.cu"), "w") as f:
        f.write(src)
    return subprocess.Popen(
        [_build._nvcc(), *_build._NVCC_FLAGS, "-o", os.path.join(d, "k.so"),
         os.path.join(d, "k.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main():
    with open(os.path.join(CSRC, "synth_detect.cu")) as f:
        todo = variants(f.read())
    if sys.argv[1:]:
        todo = {k: v for k, v in todo.items() if k in sys.argv[1:]}
    t0 = time.perf_counter()
    procs = {k: build(k, v) for k, v in todo.items()}
    libs = {}
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "k.so"))
        lib.fast_synth_pass1.argtypes = [u, u, u, i, i, p, p, p, p, p, p, i,
                                         i, i, p]
        libs[name] = lib
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")

    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
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
            for name, lib in libs.items():
                def call():
                    err = lib.fast_synth_pass1(
                        1, 2, 0, 0, nb, s_t.data_ptr(), wr.data_ptr(),
                        wi.data_ptr(), None if m is None else m.data_ptr(),
                        g[0].data_ptr(), g[1].data_ptr(), N, P, rows,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                res.append(f"{name} {cuda_ms(call, 5 if N <= 256 else 2):.3f}")
            print(f"pass 1 {noise} {N}^2, P={hi - lo}, {nb} draws, ms: "
                  + ", ".join(res) + f" ({card})", flush=True)


if __name__ == "__main__":
    main()
