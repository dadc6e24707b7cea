"""Example (PyTorch port): frozen-flow temporal fading series and fade
statistics.

The twin of ``temporal_series.py``: a correlated received-power time
series (frozen-flow turbulence plus temporally coloured scintillation),
then its fade probability and mean fade duration below a threshold and
its intensity correlation time, on the run device (``--device cpu`` for
the CPU).

    python examples/torch_temporal_series.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run without installing

import fast_tpu_torch
from fast_tpu_torch import comms, funcs


def main(device="cuda", niter=2000):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": "auto", "DX": 0.01, "NITER": niter, "NCHUNKS": 10,
        "TEMPORAL": True, "DT": 0.001, "D_GROUND": 0.8, "DSUBAP": 0.1,
        "ZENITH_ANGLE": 45, "H_TURB": h, "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 7,
    })
    sim = fast_tpu_torch.Fast(p, device=device)
    res = sim.run()
    I = res.power

    print(res)
    thresh = 0.8 * I.mean()
    print(f"fade probability (<80% mean): "
          f"{comms.fade_prob(I, thresh, min_fades=10):.4f}")
    fd = comms.fade_dur(I, thresh, dt=p["DT"], min_fades=10, device=device)
    print(f"mean fade duration: {fd * 1e3:.2f} ms")
    ac = funcs.temporal_autocorrelation(I)
    efold = np.argmax(ac < ac[0] / np.e) * p["DT"]
    print(f"intensity correlation time (1/e): {efold * 1e3:.1f} ms")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
