"""What bounds the passes of K1 and K3 on the card: each pass timed beside
variants of itself with one part of its work taken out.

    python scripts/torch_colfac_variants.py

Each variant is the kernel's source (csrc/colfac_detect.cu for K1's pass 1
and the detect pass of detect.cuh, csrc/colfac_split.cu for K3's pass 1)
with one piece of code replaced, built by nvcc with the package's flags
(the harness of scripts/torch_variants.py) into build/colfac_variants/ and
timed through the pass's own C entry (``fast_colfac_pass1``,
``fast_split_pass1``, ``fast_detect_pass``) at chip_smoke.py's shapes,
'mixed' noise: K1 at 512^2, P=82 (padded to 96), 4096 draws; K3 and the
tiled detect pass at 1024^2, P=402 (padded to 416), 630 draws; the detect
pass also at K1's shape. The variants compute wrong numbers on purpose;
only their times mean anything:

  base       the pass as it is
  one_mma    each output block's products of a step at one TF32 pass
             (a_hi b_hi only): a third of the tensor cores' work
  no_philox  (pass 1) Philox4x32-10 replaced by a two-multiply hash of the
             same counter: the time without the random bits

Prints ptxas's registers and spills of each variant's instantiation on
the main path, then one line per pass and shape with the card's name and
power limit; rates count the pupil's own px (82, 402).
"""

import ctypes
import os

import torch

# torch_variants puts the checkout's root on the path first
from torch_variants import build, card, cuda_ms, ptxas, read_sources, \
    replace_once
from fast_tpu_torch.ops import _build
from fast_tpu_torch.ops.synth_detect import pad_pupil
from fast_tpu_torch.synthesis import pruned_ift2_matrix

OUT = os.path.join(os.path.dirname(str(_build._BUILD)), "colfac_variants")
FAKE = """using namespace fast;

__device__ __forceinline__ U4 fake_philox(uint32_t c0, uint32_t c1,
                                          uint32_t c2, uint32_t c3,
                                          uint32_t k0, uint32_t k1) {
  const uint32_t h = (c0 * 2654435761u) ^ (c1 * 2246822519u) ^ c2 ^ c3 ^ k0;
  return {h, h * 3266489917u + k1, 0u, 0u};
}
"""
# the products of one output block and step: (pattern, one TF32 pass)
K1_ONE = [(r"mma_tf32_new\(d, al, rh\);\s*mma_tf32\(d, ah, rl\);\s*"
           r"mma_tf32\(d, ah, rh\);", "mma_tf32_new(d, ah, rh);"),
          (r"mma_tf32_new\(d, al, ih\);\s*mma_tf32\(d, ah, il\);\s*"
           r"mma_tf32\(d, ah, ih\);", "mma_tf32_new(d, ah, ih);")]
K3_ONE = [(r"mma_tf32_new\(d, rl\[a\], brh\);(\s*mma_tf32\(d, \w+\[a\], "
           r"\w+\);){5}", "mma_tf32_new(d, rh[a], brh);\n"
           "          mma_tf32(d, nh[a], bih);"),
          (r"mma_tf32_new\(d, rl\[a\], bih\);(\s*mma_tf32\(d, \w+\[a\], "
           r"\w+\);){5}", "mma_tf32_new(d, rh[a], bih);\n"
           "          mma_tf32(d, ih[a], brh);")]
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


def no_philox(src):
    src = replace_once(src, r"using namespace fast;\n", FAKE, "no_philox")
    return replace_once(src, r"philox4x32_10\(", "fake_philox(", "no_philox")


def main():
    k1, tf32x3 = read_sources("colfac_detect")
    k3, _ = read_sources("colfac_split")
    with open(os.path.join(os.path.dirname(__file__), "..", "fast_tpu_torch",
                           "csrc", "detect.cuh")) as f:
        det = f.read()
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    groups = [
        ("K1 pass 1", "colfac_pass1", "1, 6", "fast_colfac_pass1",
         [u, u, u, i, i, p, p, p, i, i, i, i, p],
         {"base": (k1, tf32x3),
          "one_mma": (patched(k1, K1_ONE, "one_mma"), tf32x3),
          "no_philox": (no_philox(k1), tf32x3)}),
        ("K3 pass 1", "split_pass1", "1, 7", "fast_split_pass1",
         [u, u, u, i, i, p, p, p, i, i, i, i, i, p],
         {"base": (k3, tf32x3),
          "one_mma": (patched(k3, K3_ONE, "one_mma"), tf32x3),
          "no_philox": (no_philox(k3), tf32x3)}),
        ("detect pass", "detect_pass", None, "fast_detect_pass",
         [i, p, p, p, p, p, p, p, p, i, i, p],
         {"base": (k1, tf32x3, det),
          "one_mma": (k1, tf32x3, patched(det, DET_ONE, "one_mma"))}),
    ]
    built = {}
    for label, kernel, key, entry, argtypes, todo in groups:
        fns = build(os.path.join(OUT, kernel), todo, _build._NVCC_FLAGS,
                    entry, argtypes)
        for name, (_, log) in fns.items():
            regs = ptxas(log, kernel)
            for k in ([key] if key else ["6, 1", "7, 0"]):
                print(f"ptxas {name}: {kernel} {k}: {regs.get(k)}")
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

    for label, N, lo, hi, nb, K, reps in (("K1 pass 1", 512, 215, 297, 4096,
                                           256, 10),
                                          ("K3 pass 1", 1024, 311, 713, 630,
                                           512, 3)):
        wr, wi, pm, P = tables(N, lo, hi)
        tab = torch.randn((N, K, P, 2), device=dev, generator=gen) * 1e-3
        g = torch.empty((2, nb, N, P), device=dev)

        def call(fn):
            def go():
                args = ((N, P, K, 1) if label == "K1 pass 1"
                        else (N, P, K, K, 1))
                err = fn(1, 2, 0, 0, nb, tab.data_ptr(), g[0].data_ptr(),
                         g[1].data_ptr(), *args, cs)
                if err:
                    raise RuntimeError(f"{label}: CUDA error {err}")
            return go
        # pass 1 as the real (1 x K') @ (K' x 2 npup) product per column,
        # K' = 2 x lanes (K1's rows; K3's complex lanes as real ones)
        rows = K if label == "K1 pass 1" else 2 * K
        line(label, f"{N}^2, P={hi - lo}, {nb} draws",
             nb * N * 2 * rows * 2 * (hi - lo),
             {n: call(fn) for n, fn in built[label].items()}, reps)
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
        del tab, g
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
