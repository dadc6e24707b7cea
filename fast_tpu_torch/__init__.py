"""fast_tpu_torch: the FAST Monte Carlo engine in PyTorch, for NVIDIA GPUs.

The port of ``fast_tpu`` (JAX), which stays the reference: the same
config keys, the same ``Fast`` / ``FastResult`` / ``run()`` / ``save`` /
``load`` surface, for the iid Monte Carlo run of one link, its temporal
(frozen-flow) mode, orbit passes, sweeps and parameter scans
(:mod:`.orbit`, :mod:`.sweep`), runs sharded over the ranks of
``torch.distributed`` (:mod:`.parallel`), with the comms
layer on top (:mod:`.comms`: ``FastFSOC``, the modem, I-Q PDFs, GMI/MI,
fade statistics) and the reference's function modules (:mod:`.funcs`,
:mod:`.ao_power_spectra`). The PSD stage runs in float64 torch on the
CPU; the Monte Carlo loop runs on the device given to ``Fast(params,
device=...)`` (``"cuda"`` by default), through the hand-written kernels
of ``csrc/`` (synth-detect, colfac-detect, AR flow) or the stock-op
paths. This package never imports JAX.
"""

__version__ = "0.1.0"

from . import conf
from . import grids
from . import interop
from . import ops
from . import models
from . import turbulence_models
from . import funcs
from . import ao_power_spectra
from .engine import Fast, FastResult, load
from . import comms
from .comms import FastFSOC
from . import orbit
from . import complete_orbit_simulation
from . import parallel
from . import sweep
from . import utils

__all__ = ["Fast", "FastResult", "FastFSOC", "load", "conf", "grids",
           "interop", "ops", "models", "funcs", "ao_power_spectra",
           "turbulence_models", "comms", "orbit", "complete_orbit_simulation",
           "parallel", "sweep", "utils"]
