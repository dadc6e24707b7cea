"""Configuration system.

The same schema as ``fast_tpu.conf``: one parameter dict drives both
packages, so :data:`DEFAULTS` and :data:`TPU_DEFAULTS` carry exactly the
JAX package's keys and default values. A few keys mean something else
here; their comments say what.
"""

import importlib.util
import logging

import numpy as np

logger = logging.getLogger(__name__)

#: Reference-compatible parameter schema (``fast/conf.py:67-115``).
DEFAULTS = {
    # --- simulation ---
    "NPXLS": "auto",        # grid size, or 'auto' (resolution rules in engine)
    "DX": "auto",           # pixel scale [m/px], or 'auto'
    "NITER": 1000,          # number of Monte Carlo realizations
    "SUBHARM": False,       # add low-order subharmonic modes (iid runs)
    "FFTW": False,          # accepted for config compatibility; ignored
    "FFTW_THREADS": 1,      # accepted for config compatibility; ignored
    "NCHUNKS": 10,          # chunks to split NITER into (bounds device memory)
    "TEMPORAL": False,      # frozen-flow time series instead of iid draws
    "DT": 0.001,            # timestep for TEMPORAL mode [s]
    "LOGFILE": None,
    "LOGLEVEL": "INFO",
    "SEED": None,           # RNG seed (None -> nondeterministic)
    # --- transmitter / receiver ---
    "W0": "opt",            # 1/e^2 Tx beam radius [m], or 'opt'
    "D_GROUND": 1.0,        # ground aperture diameter [m]
    "OBSC_GROUND": 0,       # ground central obscuration diameter [m]
    "D_SAT": 0.1,           # satellite aperture diameter [m]
    "OBSC_SAT": 0,          # satellite central obscuration diameter [m]
    "WVL": 1550e-9,         # laser wavelength [m]
    "AXICON": False,        # axicon (ring) launch mode
    "POWER": 1,             # laser power [W]
    "SMF": True,            # single-mode-fibre coupling at receiver
    # --- turbulence / link ---
    "H_SAT": 36e6,          # satellite altitude [m]
    "L_SAT": None,          # explicit slant range [m] (overrides H_SAT)
    "H_TURB": np.array([0, 10e3]),             # layer heights [m]
    "CN2_TURB": np.array([100e-15, 100e-15]),  # integrated Cn2 dh per layer [m^1/3]
    "WIND_SPD": np.array([10, 10]),            # wind speed per layer [m/s]
    "WIND_DIR": np.array([90.0, 0.0]),         # wind direction per layer [deg]
    "L0": np.inf,           # outer scale [m]
    "l0": 1e-06,            # inner scale [m]
    "ZENITH_ANGLE": 0,      # [deg]
    "PROP_DIR": "up",       # 'up' or 'down'
    "DTHETA": [4, 0],       # point-ahead angle (x, y) [arcsec]
    "TRANSMISSION": 1,      # atmospheric transmission coefficient
    # --- adaptive optics ---
    "AO_MODE": "AO",        # 'AO' | 'TT' | 'LGSAO' | 'NOAO'
    "DSUBAP": 0.02,         # WFS subaperture pitch [m]
    "TLOOP": 0.001,         # AO loop delay [s]
    "TEXP": 0.001,          # WFS exposure time [s]
    "ALIAS": True,          # include WFS aliasing PSD
    "NOISE": 0.0,           # WFS noise [rad^2]
    "MODAL": False,         # modal (True) or zonal (False) correction
    "MODAL_MULT": 1,        # modal-space multiplier
    "ZMAX": None,           # max Noll index for modal correction
    # --- comms ---
    "COHERENT": False,      # keep complex field (coherent detection)
    "MODULATION": None,
    "EsN0": None,
}

#: Extension keys of the JAX package, kept so that one dict drives both.
TPU_DEFAULTS = {
    "DTYPE": "float32",     # Monte Carlo synthesis dtype ('float32'|'float64')
    "PSD_DTYPE": "float64", # reserved: PSD assembly is always float64
    "RNG": "threefry",      # accepted and ignored: the port draws from
                            # torch.Generator (plain paths, log-amplitude)
                            # and from the Philox4x32-10 generator written
                            # into the detect kernels
    "PSD_DEVICE": "cpu",    # the PSD stage always runs in float64 torch on
                            # the CPU, whatever the run device is; other
                            # values are accepted and ignored
    "SYNTH": "auto",        # 'auto' | 'pallas_fused' (the hand-written
                            # synth-detect kernel) | 'pallas_colfac' (the
                            # hand-written colfac-detect kernels: merged
                            # layout up to a 128 px pupil, split above) |
                            # 'pallas' (the hand-written screens-out kernel
                            # and the stock-op detector) | 'matmul' (pruned
                            # DFT in stock torch ops) | 'colfac'
                            # (column-factored noise in stock torch ops) |
                            # 'fft' (batched ifft2)
    "PRECISION": "default", # products of the synthesis paths on the card:
                            # 'default' one TF32 pass (10-bit mantissa; the
                            # JAX package's is one bf16 pass) in every
                            # kernel product and TF32 cuBLAS on the stock
                            # paths | 'high' | 'highest' (3xTF32 in the
                            # kernels, fp32-accurate, and full fp32 on the
                            # stock paths; 'high' promotes to 'highest' as
                            # in the JAX package's kernels). A run on the
                            # CPU computes fp32 at every value, as the JAX
                            # package's CPU dots do (PASSES)
    "TEMPORAL_SYNTH": "auto",  # temporal mode: 'screens' (large per-layer
                            # screens sampled along the wind, the grid
                            # grown to the series) | 'ar' (AR(1) in Fourier
                            # space on the fixed grid: the hand-written AR
                            # kernels for float32, the exact batched ifft2
                            # for SYNTH='fft' or float64) | 'auto'
                            # ('screens' while the grown grid stays within
                            # 2048 px, else 'ar')
    "TEMPORAL_ALPHA": "auto",  # AR mode survival per step: a number, or
                            # 'auto' (1 while the series is shorter than
                            # one grid wrap, else exp(-1 / wrap steps))
    "MC_NOISE": "mixed",    # detect kernels' noise: 'mixed'
                            # (orthogonally mixed uniforms) | 'gauss'
                            # (Box-Muller). Plain paths always draw Gaussians.
    "TEMPORAL_NOISE": "uniform",  # AR mode boiling noise: 'uniform'
                            # (unit-variance uniforms) | 'gauss'
                            # (Box-Muller), on every AR route
}


#: The ``PRECISION`` values and the TF32 passes of every kernel product on
#: the card at each (``fast_tpu.ops.pallas_synth._PRECISIONS``' keys).
PASSES = {"default": 1, "high": 3, "highest": 3}


class ConfigParser:
    """Parse a config dict or ``.py`` file into a parameter dict.

    A ``.py`` file is imported as a module and must define a dict ``p``;
    missing reference keys are filled from :data:`DEFAULTS` with a warning,
    extension keys from :data:`TPU_DEFAULTS` silently.
    """

    def __init__(self, fname_or_dict):
        if isinstance(fname_or_dict, dict):
            self.config = dict(fname_or_dict)
            self.fname = None
        elif isinstance(fname_or_dict, str):
            self.fname = fname_or_dict
            self.config = {}
            self.load(fname_or_dict)
        else:
            raise TypeError("Either config file name or params dict required")
        self.check()

    def load(self, fname):
        """Load a ``.py`` config file defining a dict ``p``."""
        if not fname.endswith(".py"):
            raise ValueError("Require .py config file")
        spec = importlib.util.spec_from_file_location("", fname)
        conf_module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(conf_module)
        self.config = dict(conf_module.p)

    def check(self):
        """Fill missing keys from the defaults."""
        for key, val in DEFAULTS.items():
            if key not in self.config:
                logger.warning(
                    "Config parameter %s not defined in %s, setting default "
                    "value of %s", key, self.fname, val)
                self.config[key] = val
        for key, val in TPU_DEFAULTS.items():
            self.config.setdefault(key, val)
        if self.config["PRECISION"] not in PASSES:
            raise ValueError(f"PRECISION must be one of {sorted(PASSES)}, "
                             f"got {self.config['PRECISION']!r}")
