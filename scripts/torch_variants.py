"""The harness that scripts/torch_pass1_variants.py,
scripts/torch_colfac_variants.py, scripts/torch_detect_variants.py,
scripts/torch_ar_dft_variants.py and scripts/torch_ar_update_variants.py
share: copies of one CUDA source of fast_tpu_torch (and of its headers),
each with one piece of its code replaced, built by nvcc
(one process each, all at once, with the package's flags and headers)
into a directory of their own under build/, loaded with ctypes and timed
with CUDA events. A replacement that no longer finds the code it replaces
stops the script with the variant's name, so an edit to a kernel never
times a copy that was not changed.

A module of helpers; run the scripts above. scripts/torch_colfac_ab.py
times with its ``cuda_ms`` and reads the card with ``card``; importing it
puts this checkout's root first on the path but imports nothing of the
package, so a caller may put another checkout before it.
"""

import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "fast_tpu_torch", "csrc")
HEADERS = ("common.cuh", "detect.cuh", "tf32x3.cuh", "wgmma.cuh")


def read_source(name):
    """csrc/<name> (a source or a header) as text."""
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def find_once(pattern, src, what):
    """The one match of the regex ``pattern`` in ``src``; stops the script,
    naming ``what``, if there is none or more than one."""
    found = list(re.finditer(pattern, src, re.S))
    if len(found) != 1:
        raise SystemExit(f"variant {what}: the code it replaces was found "
                         f"{len(found)} times, not once; update the variant "
                         f"to the kernel's source")
    return found[0]


def replace_once(src, pattern, new, what):
    """``src`` with the one match of ``pattern`` replaced by the text
    ``new``."""
    m = find_once(pattern, src, what)
    return src[:m.start()] + new + src[m.end():]


def replace_body(src, name, new, what):
    """``src`` with the body of the device function ``name`` replaced."""
    m = find_once(r"__device__ __forceinline__ void " + name
                  + r"\(.*?\{(.*?)\n\}", src, what)
    return src[:m.start(1)] + new + src[m.end(1):]


HASH = """
__device__ __forceinline__ fast::U4 hash_bits(uint32_t c0, uint32_t c1,
                                              uint32_t, uint32_t,
                                              uint32_t k0, uint32_t) {
  const uint32_t h = (c0 * 0x9E3779B9u) ^ (c1 * 0x85EBCA6Bu) ^ k0;
  return {h, h * 0xC2B2AE35u, 0u, 0u};
}
#define philox4x32_10 hash_bits
"""
ONE_MMA = """
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < NT; ++q) wgmma_tf32<N>(d, a[q][s].h, bh[q][s], s + q);
  wgmma_commit();"""
NO_MMA = """
  const float b = __uint_as_float(static_cast<uint32_t>(bh[0][0] ^ bl[0][1]));
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    d[i] = __uint_as_float(a[0][0].h[i & 3] ^ a[NT - 1][1].l[i & 3]) + b;
  wgmma_commit();"""


def wgmma_variants(name):
    """{variant: {file: text}} of csrc/<name>.cu, a kernel whose pass 1
    runs on wgmma.cuh's fold groups (K1, K2/K7, K3), each variant with one
    part of pass 1's work taken out (they compute wrong numbers on
    purpose; only their times mean anything):

      base       the kernel as it is
      one_mma    one TF32 wgmma a step instead of three (a_hi b_hi only)
      no_mma     no wgmma: each fold group's products replaced by a few
                 instructions on the same A fragments (the tables still
                 land in shared memory): the time without the tensor
                 cores' work
      no_split   hi = x, lo = 0 for the A operands (B is split before)
      no_philox  a two-multiply hash in place of Philox4x32-10
      half_copy  each bulk copy of a B stage moves half its bytes: the time
                 with half the traffic from L2 into shared memory
    """
    src = read_source(f"{name}.cu")
    tf32x3, wg = read_source("tf32x3.cuh"), read_source("wgmma.cuh")
    return {
        "base": {"k.cu": src},
        "one_mma": {"k.cu": src, "wgmma.cuh": replace_body(
            wg, "mma_group", ONE_MMA, "one_mma")},
        "no_mma": {"k.cu": src, "wgmma.cuh": replace_body(
            wg, "mma_group", NO_MMA, "no_mma")},
        "no_split": {"k.cu": src, "tf32x3.cuh": replace_body(
            tf32x3, "split", "\n  hi = __float_as_uint(x);\n  lo = 0u;",
            "no_split")},
        "no_philox": {"k.cu": replace_once(
            src, r'#include "detect\.cuh"\n', '#include "detect.cuh"\n'
            + HASH, "no_philox")},
        "half_copy": {"k.cu": src, "wgmma.cuh": replace_once(
            wg, r"mbar_expect\(&full\[s\], bytes\);(\s*)bulk_copy\(slots "
            r"\+ s \* words, src, bytes, &full\[s\]\);",
            "mbar_expect(&full[s], bytes / 2);\n    bulk_copy(slots + s * "
            "words, src, bytes / 2, &full[s]);", "half_copy")},
    }


def build(out, todo, flags, entry, argtypes):
    """Build {name: {file name: text}} into out/<name>/, one nvcc each,
    all at once: the kernel source as "k.cu", the headers not given copied
    from csrc/. Returns {name: (the C function ``entry`` with
    ``argtypes``, nvcc's log)}."""
    from fast_tpu_torch.ops import _build
    t0 = time.perf_counter()
    procs = {}
    for name, srcs in todo.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        files = {h: read_source(h) for h in HEADERS}
        files.update(srcs)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *flags, "-o", os.path.join(d, "k.so"),
             os.path.join(d, "k.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} variant:\n{log}")
        fn = getattr(ctypes.CDLL(os.path.join(out, name, "k.so")), entry)
        fn.argtypes = argtypes
        built[name] = (fn, log)
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    return built


def _key(args, passes):
    """The template arguments of an entry function as ``ptxas`` and
    ``serialized`` key them: all of them, or, with ``passes``, those of the
    instantiations of that TF32 pass count (the last argument) without
    it; None for another pass count."""
    if passes is None:
        return ", ".join(args)
    return ", ".join(args[:-1]) if args[-1] == str(passes) else None


def ptxas(log, kernel, passes=None):
    """{template arguments: "registers; spills"} of ptxas for each entry
    function ``kernel`` in an nvcc log (the package builds with -Xptxas
    -v): e.g. {"6, 1": "Used 255 registers ...; 80 bytes stack frame,
    ..."}; with ``passes``, of that pass count's instantiations only
    (:func:`_key`)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            e = re.search(kernel + r"I((?:L[bi]\d+E)+)E", m.group(1))
            key = e and _key(re.findall(r"L[bi](\d+)E", e.group(1)), passes)
            continue
        if key and ("Used" in line or "spill" in line):
            out[key] = "; ".join(
                filter(None, (out.get(key), line.split(":", 1)[-1].strip())))
    return out


def serialized(log, kernel, passes=None):
    """{template arguments: [ptxas warning codes]} of each entry function
    ``kernel`` in an nvcc log whose wgmma ptxas serialized or fenced
    (C7510-C7519: "Potential Performance Loss"); ``passes`` as
    :func:`ptxas`'s."""
    out = {}
    for line in log.splitlines():
        m = re.search(r"\((C751\d)\).*function '(\S+)'", line)
        e = m and re.search(kernel + r"I((?:L[bi]\d+E)+)E", m.group(2))
        key = e and _key(re.findall(r"L[bi](\d+)E", e.group(1)), passes)
        if key:
            out.setdefault(key, []).append(m.group(1))
    return out


def cuda_ms(fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls after one warm call, by CUDA
    events on the current stream."""
    import torch
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


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()
