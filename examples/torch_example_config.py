"""Example configuration file for the PyTorch port.

The twin of ``example_config.py``: the same contract (an executable Python
file defining a dict ``p``, the reference's ``test/test_params.py``) and
the same values. Load with
``fast_tpu_torch.Fast("examples/torch_example_config.py")``, or run it to
simulate it on the card (``--device cpu`` for the CPU):

    python examples/torch_example_config.py [--device cpu]
"""

import argparse
import os
import sys

import numpy

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # usable without installing

from fast_tpu_torch import turbulence_models

# 4-layer HV57 Cn2 + Bufton wind profile
h, cn2, w = turbulence_models.HV57_Bufton_profile(4)

p = {
    # Simulation
    "NPXLS": "auto",        # grid size per side (or 'auto')
    "DX": 0.01,             # pixel scale [m/px] (or 'auto')
    "NITER": 100,           # Monte Carlo realizations / timesteps
    "SUBHARM": False,       # subharmonic low-order modes
    "NCHUNKS": 10,          # memory chunking of NITER
    "TEMPORAL": True,       # frozen-flow time series
    "DT": 0.001,            # timestep [s]
    "LOGFILE": None,
    "LOGLEVEL": "INFO",
    "SEED": 1234,

    # Transmitter / receiver
    "WVL": 1550e-9,         # wavelength [m]
    "POWER": 1,             # laser power [W]
    "W0": "opt",            # beam radius [m] or 'opt'
    "D_GROUND": 0.8,        # ground aperture diameter [m]
    "OBSC_GROUND": 0,       # ground obscuration [m]
    "D_SAT": 0.1,           # satellite aperture [m]
    "OBSC_SAT": 0,
    "AXICON": False,
    "SMF": True,

    # Turbulence / link
    "H_SAT": 36e6,          # satellite altitude [m]
    "L_SAT": None,          # explicit slant range override [m]
    "H_TURB": h,
    "CN2_TURB": cn2,
    "WIND_SPD": w,
    "WIND_DIR": numpy.array([0.0, 90.0, 180.0, 270.0]),
    "L0": numpy.inf,
    "l0": 1e-6,
    "ZENITH_ANGLE": 55,
    "PROP_DIR": "up",
    "DTHETA": [4, 0],       # point-ahead [arcsec]
    "TRANSMISSION": 1,

    # Adaptive optics
    "AO_MODE": "AO",
    "DSUBAP": 0.1,
    "TLOOP": 0.001,
    "TEXP": 0.001,
    "ALIAS": True,
    "NOISE": 0,
    "MODAL": False,
    "MODAL_MULT": 1,
    "ZMAX": None,

    # Comms
    "COHERENT": False,
    "MODULATION": None,
    "EsN0": None,
}


def main(device="cuda", **overrides):
    """Simulate ``p`` (with ``overrides``) on ``device`` and print the
    result."""
    import fast_tpu_torch
    sim = fast_tpu_torch.Fast(dict(p, **overrides),
                              device=device)
    print(f"grid {sim.Npxls}^2, {sim.Niter} steps on {sim.device}")
    print(sim.run())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
