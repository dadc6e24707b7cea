"""Numerical building blocks of the PSD stage (frozen copy)."""
