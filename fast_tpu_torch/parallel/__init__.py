"""Multi-device runs over ``torch.distributed``: NCCL between cards, gloo
on the CPU.

The port of ``fast_tpu.parallel``. The reference is single-process; its
serial chunk loop over the Monte Carlo axis (``fast/fast.py:130-134``)
becomes the axis cut over the ranks of a mesh here (:mod:`.mesh`), and
the orbit sweep's configurations the ``scan`` axis of a ``(scan, mc)``
mesh (:mod:`.scan`). :mod:`.dryrun` spawns ranks on one host.
"""

from .mesh import Mesh, make_mesh, run_sharded, sharded_moments
from .scan import make_scan_mesh, run_scan_sharded

__all__ = ["make_mesh", "run_sharded", "sharded_moments",
           "make_scan_mesh", "run_scan_sharded"]
