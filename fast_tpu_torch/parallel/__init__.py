"""Parameter scans over a batch of link configurations.

The port of ``fast_tpu.parallel``'s scan layer on one device; the
multi-device layer (``parallel/mesh.py``, scans over more than one
device) is still to port.
"""

from .scan import ScanMesh, make_scan_mesh, run_scan_sharded

__all__ = ["ScanMesh", "make_scan_mesh", "run_scan_sharded"]
