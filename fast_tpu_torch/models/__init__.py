"""Analytic atmosphere / AO models of the PSD stage."""

from . import ao
from . import atmosphere
from . import scintillation

__all__ = ["ao", "atmosphere", "scintillation"]
