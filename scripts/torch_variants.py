"""The harness that scripts/torch_pass1_variants.py and
scripts/torch_ar_dft_variants.py share: copies of one CUDA source of
fast_tpu_torch, each with one piece of its code replaced, built by nvcc
(one process each, all at once, with the package's flags and headers)
into a directory of their own under build/, loaded with ctypes and timed
with CUDA events. A replacement that no longer finds the code it replaces
stops the script with the variant's name, so an edit to a kernel never
times a copy that was not changed.

A module of helpers; run the two scripts above. scripts/torch_colfac_ab.py
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
HEADERS = ("common.cuh", "detect.cuh", "wgmma.cuh")


def read_sources(name):
    """(csrc/<name>.cu, csrc/tf32x3.cuh) as text."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f, \
            open(os.path.join(CSRC, "tf32x3.cuh")) as g:
        return f.read(), g.read()


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


def build(out, todo, flags, entry, argtypes):
    """Build {name: (kernel source, tf32x3.cuh source[, detect.cuh
    source])} into out/<name>/, one nvcc each, all at once; returns {name:
    (the C function ``entry`` with ``argtypes``, nvcc's log)}."""
    from fast_tpu_torch.ops import _build
    t0 = time.perf_counter()
    procs = {}
    for name, srcs in todo.items():
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        for h in HEADERS:
            with open(os.path.join(CSRC, h)) as f, \
                    open(os.path.join(d, h), "w") as g:
                g.write(f.read())
        for fname, text in zip(("k.cu", "tf32x3.cuh", "detect.cuh"), srcs):
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


def ptxas(log, kernel):
    """{template arguments: "registers; spills"} of ptxas for each entry
    function ``kernel`` in an nvcc log (the package builds with -Xptxas
    -v): e.g. {"6, 1": "Used 255 registers ...; 80 bytes stack frame,
    ..."}."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            e = re.search(kernel + r"I((?:L[bi]\d+E)+)E", m.group(1))
            key = e and ", ".join(re.findall(r"L[bi](\d+)E", e.group(1)))
            continue
        if key and ("Used" in line or "spill" in line):
            out[key] = "; ".join(
                filter(None, (out.get(key), line.split(":", 1)[-1].strip())))
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
