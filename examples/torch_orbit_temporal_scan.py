"""Example (PyTorch port): temporal fading series across an orbit pass.

The twin of ``orbit_temporal_scan.py``: one correlated AR(1)-in-Fourier
fading series per orbit sample (on a fixed grid: the series length never
grows the grid), the samples run as one parameter scan
(``run_scan_sharded``) on a (1, 1) mesh of the run device, which takes
every series in one call of the batched AR kernel K6 on the card
(``--device cpu`` runs its plain version): the layout for fade durations
and surge statistics along a pass.

    python examples/torch_orbit_temporal_scan.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run without installing

import fast_tpu_torch
from fast_tpu_torch import orbit, parallel
from fast_tpu_torch.comms import fade_dur, fade_prob


def main(device="cuda", npxls=128, niter=600):
    provider = orbit.circular_orbit_provider(550e3, offset_angle_deg=5.0)
    times = np.linspace(-90, 90, 4)  # seconds around culmination

    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": npxls, "DX": 0.01, "NITER": niter, "NCHUNKS": 6,
        "TEMPORAL": True, "TEMPORAL_SYNTH": "ar", "TEMPORAL_ALPHA": 0.98,
        "DT": 0.001, "D_GROUND": 0.8, "DSUBAP": 0.1,
        "H_TURB": h, "CN2_TURB": cn2, "WIND_SPD": w,
        "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]), "SEED": 1,
    })

    geometry = orbit.sample_pass_geometry(provider, times, p["TLOOP"])
    sim_dict = orbit.FAST_sat_orbit_from_geometry(p, geometry, device=device)
    sims = [sim_dict[f"simulation_{i}"] for i in range(len(times))]

    with parallel.make_scan_mesh(1, 1, [device]) as mesh:
        results = parallel.run_scan_sharded(sims, mesh)

    print("t[s]  elev[deg]  mean[dBm]   SI      P(fade<-3dB)  "
          "mean fade dur[ms]")
    for t, el, s, r in zip(times, geometry["altitudes"], sims, results):
        rel = np.asarray(r.power) / s.diffraction_limit
        thresh = rel.mean() * 10 ** (-3 / 10)  # 3 dB below the series mean
        fp = fade_prob(rel, thresh)
        fd = fade_dur(rel, thresh, dt=p["DT"], device=device)
        fd_ms = fd * 1e3 if np.isfinite(fd) else float("nan")
        print(f"{t:5.0f}  {el:8.1f}  {r.avg_power_dBm:9.2f}  "
              f"{r.scintillation_index:.4f}  {fp:12.3f}  {fd_ms:10.2f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
