"""Runtime utilities: FITS persistence, logging setup, stage timing."""

from . import fits
from . import log
from . import profiling

__all__ = ["fits", "log", "profiling"]
