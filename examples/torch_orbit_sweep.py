"""Example (PyTorch port): LEO pass sweep with the built-in Keplerian
ephemeris.

The twin of ``orbit_sweep.py``: an idealised 550 km circular-orbit pass
over a ground station, per-sample link geometry (zenith angle, range,
point-ahead angle, downlink anisoplanatism), one simulation per sample
from one sweep build, run as a parameter scan (``run_scan_sharded``) on a
(1, 1) mesh of the run device; ``torchrun`` with more ranks and a larger
mesh shards the samples (``fast_tpu_torch.parallel``).

    python examples/torch_orbit_sweep.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run without installing

import fast_tpu_torch
from fast_tpu_torch import orbit, parallel, sweep


def main(device="cuda", npxls=164, niter=1600):
    provider = orbit.circular_orbit_provider(550e3, offset_angle_deg=5.0)
    times = np.linspace(-120, 120, 4)  # seconds around culmination

    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": npxls, "DX": 0.01, "NITER": niter, "NCHUNKS": 2,
        "TEMPORAL": False, "D_GROUND": 0.8, "DSUBAP": 0.1,
        "H_TURB": h, "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 1,
    })

    geometry = orbit.sample_pass_geometry(provider, times, p["TLOOP"])
    # one PSD assembly per sample and one set of shared tables
    # (fast_tpu_torch.sweep); the reference-style per-sample path is
    # orbit.FAST_sat_orbit_from_geometry
    sims = sweep.build_sweep(p, {
        "ZENITH_ANGLE": geometry["zenith_angles"],
        "L_SAT": geometry["distances"],
        "DTHETA": geometry["paa"],
        "ANISO_DL": geometry["aniso_dl"],
        "AZIMUT_SAT": geometry["azimuts"],
    }, device=device)
    sims = {f"simulation_{i}": s for i, s in enumerate(sims)}

    with parallel.make_scan_mesh(1, 1, [device]) as mesh:
        results = orbit.run_orbit_sweep(sims, mesh=mesh)

    print(f"{'t [s]':>7} {'elev':>6} {'range km':>9} {'PAA \"':>7} "
          f"{'mean dBm':>9} {'scint':>7}")
    for i, t in enumerate(times):
        r = results[f"simulation_{i}"]
        paa = np.hypot(*geometry["paa"][i])
        print(f"{t:>7.0f} {geometry['altitudes'][i]:>6.1f} "
              f"{geometry['distances'][i] / 1e3:>9.0f} {paa:>7.1f} "
              f"{10 * np.log10(np.mean(r.power) / 1e-3):>9.2f} "
              f"{r.scintillation_index:>7.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
