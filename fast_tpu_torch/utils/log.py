"""Logging setup mirroring the reference (``fast/fast.py:142-145``)."""

import logging


def init_logging(logfile=None, level="INFO"):
    logging.basicConfig(
        filename=logfile,
        level=logging.getLevelName(level),
        format="[%(levelname)s] %(name)s.%(funcName)s | %(message)s",
    )
