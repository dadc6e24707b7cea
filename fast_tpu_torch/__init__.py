"""fast_tpu_torch: the FAST Monte Carlo engine in PyTorch, for NVIDIA GPUs.

The port of ``fast_tpu`` (JAX), which stays the reference: the same
config keys, the same ``Fast`` / ``FastResult`` / ``run()`` / ``save`` /
``load`` surface, for the iid Monte Carlo run of one link. The PSD stage
runs in float64 torch on the CPU; the Monte Carlo loop runs on the device
given to ``Fast(params, device=...)`` (``"cuda"`` by default), through
the hand-written synth-detect kernel (``csrc/synth_detect.cu``) or the
stock-op paths. This package never imports JAX.
"""

__version__ = "0.1.0"

from . import conf
from . import grids
from . import interop
from . import turbulence_models
from .engine import Fast, FastResult, load

__all__ = ["Fast", "FastResult", "load", "conf", "grids", "interop",
           "turbulence_models"]
