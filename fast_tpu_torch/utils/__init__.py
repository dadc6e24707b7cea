"""Runtime utilities: FITS persistence, logging setup, stage timing and
profiler traces; ``utils.stats`` (calibrated KS for correlated series) and
``utils.diskcache`` (the factor tables' disk cache) import on their own."""

from . import fits
from . import log
from . import profiling

__all__ = ["fits", "log", "profiling"]
