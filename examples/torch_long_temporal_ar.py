"""Example (PyTorch port): a 50,000-step fading time series on a fixed
grid.

The twin of ``long_temporal_ar.py``. The AR(1)-in-Fourier temporal mode
(``TEMPORAL_SYNTH='ar'``) evolves the Fourier coefficients on the fixed
grid (exact frozen-flow translation per step, plus a per-mode 'boiling'
decorrelation that keeps the periodic grid from repeating visibly), so
memory is constant in NITER; on the card the series runs through the AR
kernel K4 (``--device cpu`` runs its plain version).

    python examples/torch_long_temporal_ar.py [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run without installing

import torch

import fast_tpu_torch
from fast_tpu_torch import comms


def main(device="cuda", npxls=128, dx=0.02, niter=50_000, nchunks=250):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": npxls, "DX": dx, "NITER": niter, "NCHUNKS": nchunks,
        "TEMPORAL": True, "TEMPORAL_SYNTH": "ar", "DT": 0.001,
        "D_GROUND": 0.8, "DSUBAP": 0.1, "ZENITH_ANGLE": 45,
        "H_TURB": h, "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 11,
    })
    sim = fast_tpu_torch.Fast(p, device=device)
    print(f"grid: {sim.Npxls}^2 (fixed; the reference would need "
          f"{int(w.max() * p['DT'] * p['NITER'] / p['DX'] / 2)} px)")
    print(f"AR mode-survival alpha per layer: {np.round(sim._ar_alpha, 4)}")

    t0 = time.time()
    res = sim.run()
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    dt_run = time.time() - t0
    I = np.asarray(res.power)
    print(res)
    print(f"{p['NITER']} steps in {dt_run:.1f} s "
          f"({p['NITER'] / dt_run:,.0f} steps/s)")

    thresh = 0.5 * I.mean()
    print(f"fade probability below 0.5*mean: "
          f"{comms.fade_prob(I, thresh):.4f}")
    print(f"mean fade duration: "
          f"{comms.fade_dur(I, thresh, dt=p['DT'], device=device) * 1e3:.2f}"
          f" ms")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
