"""Build and load the package's CUDA kernels.

``csrc/<name>.cu`` (with the shared ``csrc/*.cuh`` headers) is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library of its own with a
plain C interface, under ``build/fast_tpu_torch/`` beside the package, at
first use. The library name carries a hash of the sources, so an edited
source is never served by a stale build. It is loaded with ``ctypes``;
callers pass pointers and the CUDA stream as integers.
:func:`build_all` runs one ``nvcc`` per source, all at once.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "fast_tpu_torch"
# -split-compile 0: the kernels of one source are optimised on all the
# host's cores (synth_detect.cu holds 66 of them)
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-split-compile", "0"]

# ar_flow.cu keeps its recurrence free of contracted multiply-adds, so that
# thousands of steps agree bit for bit with the plain torch version; its
# matrix products call fmaf themselves
_EXTRA_FLAGS = {"ar_flow": ["-fmad=false"]}

_LIBS = {}


class BuildInfo:
    """What the last build of a library printed and how long it took."""

    def __init__(self, path, seconds, log):
        self.path, self.seconds, self.log = path, seconds, log


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def build(name):
    """Compile ``csrc/<name>.cu`` unless a build of this exact source
    exists; returns a :class:`BuildInfo`."""
    src = _CSRC / f"{name}.cu"
    deps = sorted(_CSRC.glob("*.cuh")) + [src]
    flags = _NVCC_FLAGS + _EXTRA_FLAGS.get(name, [])
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in deps)
                          + " ".join(flags).encode()).hexdigest()[:16]
    out = _BUILD / f"lib{name}-{digest}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


def build_all(names):
    """Build several libraries at once (one ``nvcc`` process each);
    returns ``{name: BuildInfo}``."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load_library(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    Returns ``(ctypes.CDLL, BuildInfo)``; one load per process.
    """
    if name not in _LIBS:
        info = build(name)
        _LIBS[name] = (ctypes.CDLL(str(info.path)), info)
    return _LIBS[name]
