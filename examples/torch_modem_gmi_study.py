"""Example (PyTorch port): modulation study over a fading link — SEP, BER
and GMI.

The twin of ``modem_gmi_study.py``: one coherent Monte Carlo link run,
then several modulation formats on the same fading series: the measured
symbol-error rate of the modem, the analytic fading-averaged BER, and the
generalised mutual information (soft-decision capacity) from I-Q
histograms, all on the run device (``--device cpu`` for the CPU).

    python examples/torch_modem_gmi_study.py [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run without installing

import fast_tpu_torch
from fast_tpu_torch import comms


def main(device="cuda", npxls=164, niter=4000):
    h, cn2, w = fast_tpu_torch.turbulence_models.HV57_Bufton_profile(4)
    p = dict(fast_tpu_torch.conf.DEFAULTS)
    p.update({
        "NPXLS": npxls, "DX": 0.01, "NITER": niter, "NCHUNKS": 10,
        "TEMPORAL": False, "COHERENT": True, "D_GROUND": 0.8,
        "DSUBAP": 0.1, "ZENITH_ANGLE": 50, "H_TURB": h, "CN2_TURB": cn2,
        "WIND_SPD": w, "WIND_DIR": np.array([0.0, 90.0, 180.0, 270.0]),
        "SEED": 5,
    })
    sim = fast_tpu_torch.Fast(p, device=device)
    res = sim.run()
    field = np.asarray(res.power) / sim.diffraction_limit  # complex
    power = np.abs(field) ** 2

    print(f"{'scheme':>8s} {'EsN0':>5s} {'SEP(meas)':>10s} "
          f"{'BER(analytic)':>14s} {'GMI [bit/sym]':>14s}")
    for scheme, M in (("QPSK", 4), ("16-QAM", 16)):
        for esn0 in (8, 14):
            m = comms.Modulator(power, scheme, EsN0=esn0,
                                symbols_per_iter=100, rng=3, device=device)
            m.run()
            ber = comms.ber_qam(M, esn0 - 10 * np.log10(np.log2(M)), power)
            gmi = comms.generalised_mutual_information_qam(
                field, M, 32, esn0, device=device)
            print(f"{scheme:>8s} {esn0:>5d} {m.sep:>10.4f} "
                  f"{ber:>14.2e} {gmi:>14.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
