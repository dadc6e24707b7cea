"""Example (PyTorch port): AO-corrected uplink fading statistics vs
zenith angle.

The twin of ``link_budget_study.py``: a small zenith-angle sweep of the
Monte Carlo link simulation, printing mean coupled power, scintillation
index and 1%-fade depth for each geometry. Runs on the card through the
hand-written kernels (``--device cpu`` runs their plain versions).

    python examples/torch_link_budget_study.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run without installing

import fast_tpu_torch


def make_params(zenith, npxls=164, niter=2000):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": npxls, "DX": 0.01, "NITER": niter, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "WVL": 1550e-9,
        "ZENITH_ANGLE": zenith, "AO_MODE": "AO", "DSUBAP": 0.1,
        "TLOOP": 0.001, "TEXP": 0.001, "ALIAS": True,
        "H_TURB": h, "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 1,
    })
    return p


def main(device="cuda", npxls=164, niter=2000):
    print(f"{'zenith':>7} {'mean dBm':>9} {'scint idx':>10} "
          f"{'1% fade dB':>11} {'r0_los cm':>10}")
    for zenith in (0, 30, 45, 60):
        sim = fast_tpu_torch.Fast(make_params(zenith, npxls, niter),
                                  device=device)
        res = sim.run()
        rel = np.sort(res.power / sim.diffraction_limit)
        fade_1pct = 10 * np.log10(rel[int(0.01 * len(rel))] / rel.mean())
        print(f"{zenith:>7} {res.avg_power_dBm:>9.2f} "
              f"{res.scintillation_index:>10.4f} {fade_1pct:>11.2f} "
              f"{sim.r0_los * 100:>10.1f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
