"""Numerical building blocks of the port: FFT conventions, integration,
Bessel functions, apertures, random numbers and the K2 kernel wrapper."""
