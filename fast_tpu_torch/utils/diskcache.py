"""Content-keyed disk cache for large derived tables.

The port of ``fast_tpu.utils.diskcache``. The colfac factor build on the
host in float64 (runs in float64, runs on the CPU, and the card's
fallback) is a pure function of the PSD, the pruned inverse-DFT matrix and
the build's jitter, and every process start would pay it again for
byte-identical inputs. Stacks of at least :data:`MIN_BYTES` are cached on
disk under a SHA-256 of the *input tables* (dtype, shape and bytes, not
the config that produced them) and the build's scalars. The card's
float32 build does not use the cache: it takes less time than the save
(``PERF.md``).

Layout: ``$FAST_TPU_CACHE_DIR`` (default
``~/.cache/fast_tpu_torch/tables``) / ``<name>-<hexdigest>.npy``. The
callers' key names begin with ``torch-``, so that this package never
reads a table the JAX package built, even in a shared directory. Writes
are atomic (a temporary file, then a rename), so concurrent processes can
share the directory; a read touches the file's mtime, so that eviction
(the directory capped at :data:`MAX_BYTES`) drops the least recently
used first. ``FAST_TPU_TABLE_CACHE=0`` turns the cache off.
"""

import hashlib
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

MIN_BYTES = 64 << 20   # smaller stacks rebuild faster than they load
MAX_BYTES = 24 << 30   # directory cap; least recently used evicted


def enabled():
    return os.environ.get("FAST_TPU_TABLE_CACHE", "1") != "0"


def cache_dir():
    return os.environ.get(
        "FAST_TPU_CACHE_DIR",
        os.path.expanduser("~/.cache/fast_tpu_torch/tables"))


def table_key(name, arrays, scalars=()):
    """SHA-256 over the content of the numpy ``arrays`` and a scalar
    tuple, prefixed by ``name``."""
    h = hashlib.sha256()
    h.update(name.encode())
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(repr(tuple(scalars)).encode())
    return f"{name}-{h.hexdigest()}"


def load(key):
    """The cached array for ``key``, or None (a miss, the cache off, or a
    file that does not read: it is removed)."""
    if not enabled():
        return None
    path = os.path.join(cache_dir(), key + ".npy")
    try:
        arr = np.load(path)
    except FileNotFoundError:
        return None
    except (OSError, ValueError, EOFError) as e:  # corrupt or truncated
        logger.warning("table cache: unreadable %s (%s); rebuilding",
                       path, e)
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    try:
        os.utime(path)  # LRU touch
    except OSError:
        pass
    logger.info("table cache hit: %s (%.0f MB)", key, arr.nbytes / 1e6)
    return arr


def save(key, arr):
    """Store the numpy ``arr`` under ``key`` (nothing below
    :data:`MIN_BYTES` or with the cache off); a disk that is full or read
    only is logged, never raised."""
    arr = np.asarray(arr)
    if not enabled() or arr.nbytes < MIN_BYTES:
        return
    d = cache_dir()
    path = os.path.join(d, key + ".npy")
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        os.makedirs(d, exist_ok=True)
        with open(tmp, "wb") as f:  # np.save(path) would append '.npy'
            np.save(f, arr)
        os.replace(tmp, path)
    except OSError as e:
        logger.warning("table cache: could not store %s (%s)", key, e)
        try:
            os.remove(tmp)
        except OSError:
            pass
        return
    _evict(d)


def _evict(d):
    """Remove the least recently used ``.npy`` files of ``d`` until it
    holds at most :data:`MAX_BYTES`."""
    try:
        entries = []
        with os.scandir(d) as it:
            for e in it:
                if e.is_file() and e.name.endswith(".npy"):
                    st = e.stat()
                    entries.append((st.st_mtime, st.st_size, e.path))
        total = sum(s for _, s, _ in entries)
        for _, size, path in sorted(entries):
            if total <= MAX_BYTES:
                break
            os.remove(path)
            total -= size
            logger.info("table cache: evicted %s (%.0f MB)",
                        os.path.basename(path), size / 1e6)
    except OSError as e:
        logger.warning("table cache: eviction scan failed (%s)", e)
