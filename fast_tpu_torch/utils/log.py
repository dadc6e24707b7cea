"""Logging setup mirroring the reference (``fast/fast.py:142-145``), and
the progress line of ``Fast.run(progress=True)``."""

import logging
import sys
import time


def init_logging(logfile=None, level="INFO"):
    logging.basicConfig(
        filename=logfile,
        level=logging.getLevelName(level),
        format="[%(levelname)s] %(name)s.%(funcName)s | %(message)s",
    )


def progress(items, total, per_item=1, unit="items", stream=None):
    """Yield ``items`` unchanged, writing after each one a line ``chunk
    i/total, elapsed s, rate unit/s`` to ``stream`` (stderr by default),
    each over the last, and a newline after the last. The rate counts
    ``per_item`` units an item. What the items are and how they are made
    does not change."""
    stream = sys.stderr if stream is None else stream
    t0 = time.perf_counter()
    i = 0
    for i, item in enumerate(items, 1):
        yield item
        dt = time.perf_counter() - t0
        rate = i * per_item / dt if dt > 0 else float("inf")
        stream.write(f"\rchunk {i}/{total}, {dt:.1f} s, {rate:.0f} "
                     f"{unit}/s")
        stream.flush()
    if i:
        stream.write("\n")
        stream.flush()
