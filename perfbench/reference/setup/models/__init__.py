"""Analytic atmosphere and AO models of the PSD stage (frozen copy)."""

from . import ao
from . import atmosphere
from . import scintillation

__all__ = ["ao", "atmosphere", "scintillation"]
