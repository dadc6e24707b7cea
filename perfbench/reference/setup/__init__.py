"""Frozen copy of the port's float64 host set-up.

``psd.py``, ``grids.py``, ``models/`` and ``ops/`` are copies of the
modules of the same names in ``fast_tpu_torch`` as the benchmark was
defined, and :mod:`.host` condenses the set-up methods of its
``engine.Fast``: the atmosphere, the grids, the AO masks, the pupils, the
link budget and the power spectra, all in numpy and torch float64 on the
CPU. The reference works out every table of a run again from the
configuration through them, so a later change to the program's set-up is
held against the arithmetic it was measured with. Nothing here imports the
program.
"""
