"""Simulation engine: configuration -> power spectra -> Monte Carlo run.

The iid Monte Carlo path and the temporal (frozen-flow) mode of
``fast_tpu.engine`` in PyTorch:

* **Host stage** (numpy, float64): config resolution ('auto' grid rules),
  atmosphere and beam geometry, pupils and fibre mode, link budget.
* **PSD stage** (torch float64 on the CPU, whatever the run device):
  :func:`fast_tpu_torch.psd.assemble_main`.
* **Device stage**: tables cast to float32 and moved to the run device
  once per configuration (:func:`fast_tpu_torch.interop.tables_from_numpy`),
  with the per-column Cholesky factors of the colfac paths (float32 on the
  card, float64 on the CPU or where float32 fails), then a loop over
  chunks. ``SYNTH='pallas_colfac'`` (what 'auto' picks for float32 at
  N >= 512 with a pupil of at most 128 px) runs the hand-written
  colfac-detect kernels, K1 up to a 128 px pupil and K3 (split layout)
  above; ``'pallas_fused'`` (what 'auto' picks for other float32 runs,
  wide pupils among them) the synth-detect kernel K2; ``'pallas'`` the
  screens-out kernel K7 followed by the stock-op detector, on CUDA; on
  the CPU they run their plain torch versions. ``'matmul'``, ``'colfac'``
  and ``'fft'`` are the stock-op paths. ``SUBHARM=True`` adds the
  low-order subharmonic screens on every path, inside the detect pass of
  K1, K2 and K3, and to K7's screens.
* **Temporal mode** (``TEMPORAL=True``): a time series instead of iid
  draws, with a log-amplitude series coloured by the temporal PSD.
  ``TEMPORAL_SYNTH='screens'`` draws one large screen per layer (the grid
  grown to the series) and samples it along the wind; ``'ar'`` evolves the
  per-layer Fourier state on the fixed grid by an AR(1) recursion, through
  the hand-written AR kernels K4 and K5 (:mod:`fast_tpu_torch.ops.ar_flow`)
  for float32 on CUDA (their plain torch version on the CPU), at any pupil
  width, or through the exact batched ``ift2`` for ``SYNTH='fft'`` or
  float64. Every AR route draws the kernels' Philox noise keyed by the
  absolute step, so the series does not depend on ``NCHUNKS``.

``run(progress=True)`` walks the same chunks with a progress line on
stderr (:func:`fast_tpu_torch.utils.log.progress`) and returns the same
numbers. Orbit passes, sweeps and parameter scans build on this class:
:mod:`fast_tpu_torch.orbit`, :mod:`fast_tpu_torch.sweep`,
:mod:`fast_tpu_torch.parallel`.
"""

import logging

import numpy as np
import torch

from . import conf
from . import psd
from .grids import SpatialFrequencies, SpatialFrequencyStruct  # noqa: F401
from .interop import tables_from_numpy
from .models import ao as ao_spectra
from .models import atmosphere
from .models.scintillation import (PupilFilterSampler,  # noqa: F401
                                   logamp_powerspec,
                                   temporal_logamp_powerspec)
from .ops import apertures
from .ops import ar_flow
from .ops.fourier import ft2, ift2
from .ops.integrate import (integrate_path,  # noqa: F401
                            integrate_powerspectrum)
from .ops.rng import complex_normal, draw_seed, make_generator
from .ops import colfac_detect as cd
from .ops.synth_detect import (pack_subharm, supports, synth_detect,
                               synth_screens)
from . import synthesis
from .utils import diskcache, fits
from .utils.log import init_logging, progress as chunk_progress
from .utils.profiling import StageTimer

logger = logging.getLogger(__name__)

# the reference's namespace (``fast/fast.py:5``, the names it takes from
# aotools), as ``fast_tpu.engine`` keeps it
from .models.atmosphere import (cn2_to_r0, coherence_time,  # noqa: E402,F401
                                isoplanatic_angle, rytov_variance)
from .ops.apertures import circle  # noqa: E402,F401

isoplanaticAngle = isoplanatic_angle  # aotools camelCase names
coherenceTime = coherence_time

_PORTED = ("auto", "pallas", "pallas_fused", "pallas_colfac", "matmul",
           "colfac", "fft")


def l_path(h_sat, zeta):
    """Spherical-Earth slant range from altitude and zenith angle [m]."""
    r_earth = 6.371009e6
    zeta = np.radians(zeta)
    b = -2 * r_earth * np.cos(np.pi - zeta)
    c = r_earth ** 2 - (r_earth + h_sat) ** 2
    r1 = (-b + np.sqrt(b ** 2 - 4 * c)) / 2
    r2 = (-b - np.sqrt(b ** 2 - 4 * c)) / 2
    return r1 if r1 >= 0 else r2


def calculate_wind_correction(h, theta_loop, Tloop):
    """Apparent per-layer wind induced by satellite slew over one loop."""
    return -np.array([
        np.sin(np.radians(theta_loop[0] / 3600)) * h / Tloop,
        np.sin(np.radians(theta_loop[1] / 3600)) * h / Tloop,
    ]).T


def _resolve_device(device):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain versions on the CPU")
    return dev


def resolve_synth(synth, dtype, device, N, P, noise):
    """The synthesis path of a run.

    'auto' is 'fft' for float64 runs (the exact path); for float32 runs on
    any device it is the colfac-detect kernel, 'pallas_colfac', at
    N >= 512 with a pupil of at most 128 px (the JAX package's rule) and
    the synth-detect kernel, 'pallas_fused', elsewhere. No pupil width is
    refused: pinned 'pallas_colfac' runs K1 up to 128 px and K3 above
    (:func:`~fast_tpu_torch.ops.colfac_detect.colfac_layout`). On a CUDA
    device 'pallas_fused' raises here, rather than at the first chunk,
    for the one shape K2 does not take ('mixed' noise on a grid over
    2304 px at a 128 px pupil); on the CPU it runs the kernel's plain
    version, which takes every shape.
    """
    if synth == "auto":
        if dtype == torch.float64:
            synth = "fft"
        elif N >= 512 and P <= 128:
            synth = "pallas_colfac"
        else:
            synth = "pallas_fused"
    if (synth == "pallas_fused" and device.type == "cuda"
            and not supports(N, P, mixed=noise == "mixed")):
        raise ValueError(
            f"the synth-detect kernel (SYNTH='pallas_fused', what 'auto' "
            f"picks for float32) takes, with MC_NOISE='mixed', a grid of at "
            f"most 2304 px at a 128 px pupil; got NPXLS={N}, a {P} px "
            f"pupil. SYNTH='matmul' runs the stock-op path")
    return synth


def chunk_couplings(T, synth, nbatch, *, noise="mixed", seed=0, stream=0,
                    generator=None, sh=None):
    """Complex pupil couplings of one chunk: ``2 * nbatch`` screens.

    ``T`` are the device tables of :func:`tables_from_numpy`. The kernel
    paths, 'pallas_fused', 'pallas_colfac' and 'pallas', draw from their
    Philox keyed by ``seed`` with counter word ``stream``; 'matmul',
    'colfac' and 'fft' draw from ``generator``. 'pallas' draws Box-Muller
    noise whatever ``noise`` says, as the TPU kernel does. ``sh`` are
    optional (nbatch, Npup, Npup) complex subharmonic screens, added to
    the screens of every path. Returns the couplings scaled by
    ``dx^2 / norm``, before the log-amplitude factor.
    """
    dx, norm = float(T["dx"]), float(T["norm"])
    if synth in ("pallas_fused", "pallas_colfac"):
        sh_t = None if sh is None else pack_subharm(sh, T["wr"].shape[0])
        mixed = noise == "mixed"
        laid = T.get("w_laid")
        if synth == "pallas_fused":
            c = synth_detect(seed, T["s_t"], T["wr"], T["wi"], T["pm_t"],
                             nbatch, mix=T["mix"] if mixed else None,
                             stream=stream, sh_t=sh_t, laid=laid)
        elif "T_colfac" in T:
            c = cd.colfac_detect_split(seed, T["T_colfac"], T["wr"], T["wi"],
                                       T["pm_t"], nbatch, mixed=mixed,
                                       stream=stream, sh_t=sh_t, laid=laid)
        else:
            c = cd.colfac_detect(seed, T["S_colfac"], T["wr"], T["wi"],
                                 T["pm_t"], nbatch, mixed=mixed,
                                 stream=stream, sh_t=sh_t, laid=laid)
        return torch.complex(c[:, 0], c[:, 1]) * (dx ** 2 / norm)
    df = float(T["df"])
    if synth == "pallas":
        phs = synth_screens(seed, T["s_t"], T["wr"], T["wi"], nbatch,
                            npup=T["pm"].shape[0], stream=stream,
                            laid=T.get("w_laid"))
        if sh is not None:
            phs = phs + synthesis.double_screens(sh)
        return synthesis.detector_coupling(phs, T["pm"], dx, norm)
    if synth == "matmul":
        scr = synthesis.synthesize_screens_pruned(
            generator, T["sqrt_psd"], df, nbatch, T["W"])
    elif synth == "colfac":
        scr = synthesis.synthesize_screens_colfac(generator, T["L"], T["W"],
                                                  nbatch)
    elif synth == "fft":
        lo, hi = (int(v) for v in T["pup_crop"])
        scr = synthesis.synthesize_screens_complex(
            generator, T["sqrt_psd"], df, nbatch, crop=(lo, hi))
    else:
        raise ValueError(f"unknown synthesis path {synth!r}")
    if sh is not None:
        scr = scr + sh
    return synthesis.detector_coupling(synthesis.double_screens(scr),
                                       T["pm"], dx, norm)


class Fast:
    """FAST simulation object on a torch device.

    Construct with a config dict or ``.py`` file path; construction
    precomputes the link budget and all power spectra; :meth:`run` draws
    the Monte Carlo realizations and returns a :class:`FastResult`.
    ``device`` defaults to ``"cuda"``; without a card, pass ``"cpu"``.
    """

    def __init__(self, params, device="cuda"):
        self.device = _resolve_device(device)
        self.conf = conf.ConfigParser(params)
        self.params = p = self.conf.config

        self.Niter = p["NITER"]
        self.Nchunks = p["NCHUNKS"]
        self.seed = p["SEED"]
        self.temporal = p["TEMPORAL"]
        self.dt = p["DT"]
        if p["SYNTH"] not in _PORTED:
            raise ValueError(f"unknown SYNTH {p['SYNTH']!r}")

        if self.Niter % self.Nchunks != 0:
            raise ValueError("NCHUNKS must divide NITER without remainder")
        self.Niter_per_chunk = self.Niter // self.Nchunks
        if self.Niter_per_chunk % 2 != 0:
            raise ValueError("NITER/NCHUNKS must be even number")
        self.dtype = {"float32": torch.float32,
                      "float64": torch.float64}[str(p["DTYPE"])]

        self.init_logging()
        self.profile = StageTimer(self.device)
        self.timings = self.profile.timings

        with self.profile.stage("init_geometry"):
            self.init_atmos()
            self.init_beam_params()
            self.init_frequency_grid()
        if self.temporal:
            self._resolve_temporal_route()
        else:
            self._synth = resolve_synth(p["SYNTH"], self.dtype, self.device,
                                        self.Npxls, self.Npxls_pup,
                                        p["MC_NOISE"])
        with self.profile.stage("init_masks"):
            self.init_ao_params()
        with self.profile.stage("init_pupils"):
            self.init_pupil_mask()
        with self.profile.stage("link_budget"):
            self.compute_link_budget()
        self.compute_powerspec()

    # ------------------------------------------------------------------
    # initialisation pipeline (host, numpy float64)
    # ------------------------------------------------------------------

    def init_logging(self):
        init_logging(self.params["LOGFILE"], self.params["LOGLEVEL"])

    def calc_zenith_correction(self, zenith_angle):
        return 1 / np.cos(np.radians(zenith_angle))

    def init_atmos(self):
        logger.info("Initialising atmosphere")
        p = self.params
        self.zenith_correction = self.calc_zenith_correction(p["ZENITH_ANGLE"])
        self.h = np.asarray(p["H_TURB"], dtype=float) * self.zenith_correction
        self.cn2 = np.asarray(p["CN2_TURB"], dtype=float) * self.zenith_correction
        self.L = (p["L_SAT"] if p["L_SAT"] is not None
                  else l_path(p["H_SAT"], p["ZENITH_ANGLE"]))
        self.dtheta = p["DTHETA"]
        self.paa = np.sqrt(self.dtheta[0] ** 2 + self.dtheta[1] ** 2)

        wind_spd = np.asarray(p["WIND_SPD"], dtype=float)
        self.wind_dir = np.asarray(p["WIND_DIR"], dtype=float)
        if "AZIMUT_SAT" in p:
            self.wind_dir = (self.wind_dir - p["AZIMUT_SAT"]) % 360
        self.wind_vector = (wind_spd * np.array([
            np.cos(np.radians(self.wind_dir)),
            np.sin(np.radians(self.wind_dir)) / self.zenith_correction,
        ])).T
        if "ANISO_DL" in p:
            self.wind_correction = calculate_wind_correction(
                self.h, p["ANISO_DL"], p["TLOOP"])
            self.wind_vector = self.wind_vector + self.wind_correction
        self.wind_speed = np.sqrt(
            self.wind_vector[:, 0] ** 2 + self.wind_vector[:, 1] ** 2)

        cn2_zen = np.asarray(p["CN2_TURB"], dtype=float)
        h_zen = np.asarray(p["H_TURB"], dtype=float)
        self.r0 = atmosphere.cn2_to_r0(cn2_zen.sum(), lamda=500e-9)
        self.theta0 = atmosphere.isoplanatic_angle(cn2_zen, h_zen, lamda=500e-9)
        self.tau0 = atmosphere.coherence_time(cn2_zen, wind_spd, lamda=500e-9)
        self.rytov_variance = atmosphere.rytov_variance(cn2_zen, h_zen,
                                                        lamda=500e-9)
        self.r0_los = atmosphere.cn2_to_r0(self.cn2.sum(), lamda=p["WVL"])
        self.theta0_los = atmosphere.isoplanatic_angle(self.cn2, self.h,
                                                       lamda=p["WVL"])
        self.tau0_los = atmosphere.coherence_time(self.cn2, self.wind_speed,
                                                  lamda=p["WVL"])
        self.rytov_variance_los = atmosphere.rytov_variance(
            self.cn2, self.h, lamda=p["WVL"])
        self.L0 = p["L0"]
        self.l0 = p["l0"]

    def init_beam_params(self):
        logger.info("Initialising beam parameters")
        p = self.params
        self.power = p["POWER"]
        self.W0 = p["W0"]
        self.F0 = np.inf  # collimated launch, as in the reference
        self.wvl = p["WVL"]
        self.k = 2 * np.pi / self.wvl
        self.D_ground = p["D_GROUND"]
        self.obsc_ground = p["OBSC_GROUND"]
        self.D_sat = p["D_SAT"]
        self.obsc_sat = p["OBSC_SAT"]

    def init_frequency_grid(self):
        """Resolve 'auto' grid rules (``fast/fast.py:147-227``) and build
        the main frequency grid."""
        logger.info("Initialising spatial frequencies")
        p = self.params
        if p["DX"] == "auto":
            self.dx = float(np.min([p["DSUBAP"] / 2, self.r0_los / 2,
                                    self.D_ground / 10]))
            if p["AO_MODE"] == "NOAO":
                self.dx = self.r0_los / 2
            logger.info("Auto set DX to %s", self.dx)
        else:
            self.dx = p["DX"]
        # no-wrap pixel bound of the reference's frozen-flow mode
        # (``fast/fast.py:181-185``); the AR route does not grow the grid
        # with NITER, so it ignores this bound
        wind_spd_raw = np.asarray(p["WIND_SPD"], dtype=float)
        temporal_npxls = (int(wind_spd_raw.max() * p["DT"] * p["NITER"]
                              / self.dx / 2) if self.temporal else 0)
        self._temporal_synth = p.get("TEMPORAL_SYNTH", "auto")
        if self._temporal_synth == "auto":
            self._temporal_synth = ("screens" if temporal_npxls <= 2048
                                    else "ar")
        if self._temporal_synth not in ("screens", "ar"):
            raise ValueError("TEMPORAL_SYNTH must be 'auto'|'screens'|'ar'")
        if p.get("TEMPORAL_NOISE", "uniform") not in ("uniform", "gauss"):
            raise ValueError("TEMPORAL_NOISE must be 'uniform'|'gauss'")
        if p.get("MC_NOISE", "gauss") not in ("gauss", "mixed"):
            raise ValueError("MC_NOISE must be 'gauss'|'mixed'")
        grow = self.temporal and self._temporal_synth == "screens"

        if p["NPXLS"] == "auto":
            nyq_aniso = np.pi / (self.h[-1] * self.paa / 206265.0)
            nyq_servo = np.pi / (max(self.wind_speed) * p["TLOOP"])
            nyq_fitting = np.pi / p["DSUBAP"] / 5
            nyq = np.min([nyq_aniso, nyq_servo, nyq_fitting])
            nyq_npxls = int(2 * np.ceil(2 * np.pi / (nyq * self.dx) / 2))
            ap_npxls = int(2 * np.ceil(p["D_GROUND"] / self.dx / 2)) + 2
            self.Npxls = int(np.max([nyq_npxls, ap_npxls,
                                     temporal_npxls if grow else 0]))
            logger.info("Auto set NPXLS to %s", self.Npxls)
            if p["AO_MODE"] == "NOAO" and not np.isinf(p["L0"]):
                L0_npxls = int(2 * np.ceil((p["L0"] * 2) / self.dx) / 2)
                if L0_npxls > self.Npxls:
                    logger.warning(
                        "L0 set with NOAO mode, low orders may be "
                        "undersampled. Recommended NPXLS: %s", L0_npxls)
        else:
            self.Npxls = p["NPXLS"]
            if grow and self.Npxls < temporal_npxls:
                logger.warning("NPXLS likely too small; recommended: %s",
                               temporal_npxls)
        if self.Npxls > 2048:
            logger.warning(
                "NPXLS is large (%s) and may cause very high memory usage",
                self.Npxls)
        self.Npxls_pup = int(np.ceil(self.D_ground / self.dx)) + 2
        self.freq = SpatialFrequencies(self.Npxls, self.dx)
        self.subharmonics = bool(p["SUBHARM"])
        if self.temporal:
            # the meshed temporal grids are informational and kept only at
            # modest sizes; the PSD assembly streams over the axes
            self._temporal_materialized = (
                len(self.h) * self.Npxls * self.Niter <= 2 ** 25)
            self.freq.make_temporal_freqs(
                len(self.h), self.Npxls, self.Niter, self.wind_speed,
                self.wind_dir, self.dt,
                materialize=self._temporal_materialized)
            if self.subharmonics:
                logger.info("SUBHARM not used in TEMPORAL mode")
                self.subharmonics = False
        if self.subharmonics:
            self.freq.make_subharm_freqs()

    def init_ao_params(self):
        logger.info("Initialising AO parameters")
        p = self.params
        self.ao_mode = p["AO_MODE"]
        self.Dsubap = p["DSUBAP"]
        self.tloop = p["TLOOP"]
        self.texp = p["TEXP"]
        self.Zmax = p["ZMAX"]
        self.alias = p["ALIAS"]
        self.noise = p["NOISE"]
        self.modal = p["MODAL"]
        self.modal_mult = p["MODAL_MULT"]
        if self.ao_mode == "TT":
            self.Zmax = 3
            self.modal = True
            self.modal_mult = 1
        self.lf_mask = ao_spectra.mask_lf(
            self.freq.main, self.Dsubap, modal=self.modal,
            modal_mult=self.modal_mult, Zmax=self.Zmax,
            D=self.D_ground).numpy()
        self.hf_mask = 1 - self.lf_mask
        if self.subharmonics:
            self.lf_mask_subharm = ao_spectra.mask_lf(
                self.freq.subharm, self.Dsubap, modal=self.modal,
                modal_mult=self.modal_mult, Zmax=self.Zmax,
                D=self.D_ground).numpy()
        if self.temporal and self._temporal_materialized:
            self.lf_mask_temporal = ao_spectra.mask_lf(
                self.freq.temporal, self.Dsubap, modal=self.modal,
                modal_mult=self.modal_mult, Zmax=self.Zmax,
                D=self.D_ground).numpy()

    def _resolve_temporal_route(self):
        """The route of a temporal run: ``_ar_route`` is None for the
        frozen-flow screens, 'kernel' for the AR kernels (float32 and
        ``SYNTH != 'fft'``: K4 or K5 on a CUDA device, their plain version
        on the CPU) and 'fft' for the exact batched ``ift2``. On a CUDA
        device a shape the kernels do not take (a grid over 32768 px or a
        pupil over 32640 px) raises here."""
        p = self.params
        exact = p["SYNTH"] == "fft" or self.dtype == torch.float64
        self._synth = "fft" if exact else p["SYNTH"]
        self._ar_route = None
        if self._temporal_synth != "ar":
            return
        self._ar_route = "fft" if exact else "kernel"
        if (self._ar_route == "kernel" and self.device.type == "cuda"
                and not ar_flow.supports(self.Npxls, self.Npxls_pup)):
            raise ValueError(
                f"the AR flow kernels (TEMPORAL_SYNTH='ar', float32) take a "
                f"grid of at most 32768 px and a pupil of at most 32640 px; "
                f"got NPXLS={self.Npxls}, a {self.Npxls_pup} px pupil. "
                f"SYNTH='fft' runs the exact stock-op route")

    def init_pupil_mask(self):
        logger.info("Initialising pupil mask")
        p = self.params
        self.dx_sat = self.D_sat / 32  # fixed 32-px satellite pupil
        ptype = "axicon" if p["AXICON"] else "gauss"
        self.pupil = apertures.compute_pupil(
            self.Npxls, self.dx, self.D_ground, self.obsc_ground)
        self.pupil_sat = apertures.compute_pupil(
            32, self.dx_sat, self.D_sat, self.obsc_sat)
        self.pupil_mode, self.W0 = apertures.compute_gaussian_mode(
            self.pupil, self.dx, self.W0, D=self.D_ground,
            obsc=self.obsc_ground, ptype=ptype)
        self.pupil_mode_sat, self.W0_sat = apertures.compute_gaussian_mode(
            self.pupil_sat, self.dx_sat, "opt", ptype="gauss")
        self.pupil_filter = apertures.pupil_filter(self.pupil * self.pupil_mode)

        lo = (self.Npxls - self.Npxls_pup) // 2
        hi = (self.Npxls + self.Npxls_pup) // 2
        self.pup_crop = (lo, hi)
        self.pup_coords = np.array([np.arange(lo, hi), np.arange(lo, hi)])
        self.pupil = self.pupil[lo:hi, lo:hi]
        self.pupil_mode = self.pupil_mode[lo:hi, lo:hi]

        if self.temporal:
            # high-resolution pupil filter for the temporal log-amplitude PSD
            f_max = max(self.freq.temporal.fx_axis.max(),
                        self.freq.temporal.fy_axis.max())
            dx_req = np.pi / f_max
            n_req = int(2 * np.ceil(
                2 * np.pi / (self.freq.main.df * dx_req) / 2))
            pupil_temporal = apertures.compute_pupil(
                n_req, dx_req, self.D_ground, self.obsc_ground,
                Ny=2 * self.Npxls_pup)
            mode_temporal, _ = apertures.compute_gaussian_mode(
                pupil_temporal, dx_req, W0=self.W0, ptype="gauss")
            self.freq.make_logamp_freqs(
                Nx=n_req, dx=dx_req, Ny=2 * self.Npxls_pup, dy=self.dx)
            self.pupil_filter_temporal = PupilFilterSampler(
                apertures.pupil_filter(pupil_temporal * mode_temporal),
                self.freq.logamp.fx_axis, self.freq.logamp.fy_axis)
        return self.pupil

    # ------------------------------------------------------------------
    # analytic precompute
    # ------------------------------------------------------------------

    def compute_link_budget(self):
        """Analytic link budget in dB terms (``fast/fast.py:670-734``)."""
        logger.info("Computing analytical link budget")
        p = self.params
        if p["PROP_DIR"] == "up":
            D_t, D_r = self.D_ground, self.D_sat
            obsc_t, obsc_r = self.obsc_ground, self.obsc_sat
            mode, dx_r, pupil_r = self.pupil_mode_sat, self.dx_sat, self.pupil_sat
            w0 = self.W0
        else:
            D_t, D_r = self.D_sat, self.D_ground
            obsc_t, obsc_r = self.obsc_sat, self.obsc_ground
            mode, dx_r, pupil_r = self.pupil_mode, self.dx, self.pupil
            w0 = self.W0_sat

        lb = {}
        lb["power"] = 10 * np.log10(self.power / 1e-3)
        lb["free_space"] = 10 * np.log10((self.wvl / (4 * np.pi * self.L)) ** 2)
        # Klein & Degnan 1974 eq. 9: obscured-Gaussian transmitter gain
        alpha = D_t / (2 * w0)
        gamma = obsc_t / D_t
        g_t = 2 / alpha ** 2 * (
            np.exp(-alpha ** 2) - np.exp(-gamma ** 2 * alpha ** 2)) ** 2
        lb["transmitter_gain"] = 10 * np.log10(
            (np.pi * D_t ** 2) * 4 * np.pi / self.wvl ** 2 * g_t)
        A = np.pi * ((D_r / 2) ** 2 - (obsc_r / 2) ** 2)
        lb["receiver_gain"] = 10 * np.log10(4 * np.pi * A / self.wvl ** 2)
        lb["transmission_loss"] = 10 * np.log10(p["TRANSMISSION"])
        lb["smf_coupling"] = 10 * np.log10(
            ((pupil_r * mode).sum() * dx_r) ** 2 / (mode ** 2).sum())
        self.link_budget = lb
        self.diffraction_limit = 10 ** (sum(lb.values()) / 10) / 1e3  # W
        return lb

    def compute_powerspec(self):
        """Assemble the residual phase and log-amplitude PSDs (float64,
        CPU), then rebuild the device tables."""
        with self.profile.stage("powerspec"):
            self._compute_powerspec_host()
        with self.profile.stage("device_constants"):
            self._prepare_device_constants()

    def _psd_args(self, g):
        """The grid, the atmosphere and AO arguments and the flags of the
        PSD assembly on the grid ``g``."""
        grid = (g.fx, g.fy, g.fabs, g.fx_axis, g.fy_axis)
        rest = (self.cn2, self.h, self.wind_vector, self.dtheta,
                float(self.noise),
                float(self.Dsubap if self.Dsubap is not None else 0.0),
                float(self.texp), float(self.tloop), float(self.wvl),
                float(self.D_ground), float(self.L0), float(self.l0))
        x_max = (float(np.max(g.fabs) * self.D_ground / 2)
                 if self.ao_mode == "LGSAO" else None)
        flags = dict(mode=self.ao_mode, alias_on=bool(self.alias),
                     noise_on=bool(self.noise > 0), x_max=x_max)
        return grid, rest, flags

    def _compute_powerspec_host(self):
        logger.info("Computing (residual) phase power spectra")
        g = self.freq.main
        grid, rest, flags = self._psd_args(g)
        out = psd.assemble_main(*grid, g.f, self.lf_mask, self.hf_mask,
                                self.pupil_filter, *rest, **flags)
        ao_on = self.ao_mode != "NOAO"
        self.turb_powerspec = out["turb_powerspec"].numpy()
        self.G_ao = out["G_ao"].numpy()
        self.alias_powerspec = (out["alias_powerspec"].numpy()
                                if self.alias and ao_on else 0.0)
        self.noise_powerspec = (out["noise_powerspec"].numpy()
                                if self.noise > 0 and ao_on else 0.0)
        self.powerspec_per_layer = out["powerspec_per_layer"].numpy()
        self.powerspec = out["powerspec"].numpy()
        for k in ("aniso_servo_error", "alias_error", "noise_error",
                  "fitting_error", "phs_var", "logamp_var"):
            setattr(self, k, float(out[k]))
        self.phs_var_weights = out["phs_var_weights"].numpy()
        self.logamp_powerspec = out["logamp_powerspec"].numpy()
        self.powerspec_subharm = self.phs_var_subharm = None
        self.phs_var_weights_sh = None
        if self.subharmonics:
            logger.info("Computing subharmonics power spectra")
            g = self.freq.subharm
            grid, rest, flags = self._psd_args(g)
            out = psd.assemble_subharm(*grid, g.df, self.lf_mask_subharm,
                                       *rest, **flags)
            self.powerspec_subharm_per_layer = (
                out["powerspec_subharm_per_layer"].numpy())
            self.powerspec_subharm = out["powerspec_subharm"].numpy()
            self.phs_var_subharm = out["phs_var_subharm"].numpy()
            self.phs_var_weights_sh = out["phs_var_weights_sh"].numpy()
        self.temporal_logamp_powerspec = None
        if self.temporal:
            logger.info("Computing temporal power spectra")
            dts = np.arange(1, self.Niter_per_chunk + 1) * self.dt
            self.pixel_shifts = (dts * self.wind_vector[..., np.newaxis]
                                 / self.dx)
            # streamed per temporal bin: O(Ny * block) memory instead of
            # the reference's O(nlayers * Ny * NITER)
            t = self.freq.temporal
            self.temporal_logamp_powerspec = temporal_logamp_powerspec(
                t.fx_axis, t.fy_axis, self.h, self.cn2, self.wvl,
                self.pupil_filter_temporal, float(self.freq.main.dfy),
                L0=self.L0, l0=self.l0)
        self.validate()

    def validate(self):
        """Sanity-check the precomputed spectra; raises on corruption:
        every PSD finite and non-negative, masks within [0, 1], the link
        budget finite."""
        problems = []

        def _chk(name, arr, lo=None, hi=None):
            a = np.asarray(arr, dtype=float)
            if not np.isfinite(a).all():
                problems.append(f"{name} contains non-finite values")
            if lo is not None and (a < lo).any():
                problems.append(f"{name} below {lo}")
            if hi is not None and (a > hi + 1e-9).any():
                problems.append(f"{name} above {hi}")

        _chk("powerspec", self.powerspec, lo=0)
        _chk("logamp_powerspec", self.logamp_powerspec, lo=0)
        _chk("lf_mask", self.lf_mask, lo=0, hi=1)
        _chk("pupil", self.pupil, lo=0)
        _chk("link_budget", list(self.link_budget.values()))
        if self.subharmonics:
            _chk("powerspec_subharm", self.powerspec_subharm, lo=0)
        if self.temporal:
            _chk("temporal_logamp_powerspec",
                 self.temporal_logamp_powerspec, lo=0)
        if problems:
            raise ValueError("simulation state invalid: " + "; ".join(problems))
        return True

    # ------------------------------------------------------------------
    # Monte Carlo run
    # ------------------------------------------------------------------

    def _prepare_device_constants(self):
        """Move the per-configuration tables to the run device, with the
        column factors of the colfac paths and the subharmonic tables."""
        self.tables = tables_from_numpy(self._table_arrays(),
                                        device=self.device, dtype=self.dtype,
                                        noise=self.params["MC_NOISE"])

    def _table_arrays(self, column_factors=True):
        """The host arrays of :func:`tables_from_numpy` for this
        configuration; ``column_factors=False`` leaves out the colfac
        paths' factors (a sweep builds each sample's own)."""
        synth = self._synth
        if not self.temporal and not synth.startswith("pallas"):
            # the per-chunk noise tensor is the plain paths' peak allocation
            itemsize = 8 if self.dtype == torch.float32 else 16  # complex
            ncols = self.Npxls_pup if synth == "colfac" else self.Npxls
            chunk_bytes = ((self.Niter_per_chunk // 2) * self.Npxls * ncols
                           * itemsize)
            if chunk_bytes > 8e9:
                logger.warning(
                    "per-chunk noise tensor is %.1f GB; increase NCHUNKS "
                    "to bound device memory", chunk_bytes / 1e9)
        pm = self.pupil * self.pupil_mode
        self._norm = float(pm.sum() * self.dx ** 2)
        W64 = synthesis.pruned_ift2_matrix(self.Npxls, *self.pup_crop,
                                           dtype=np.complex128)
        arrays = dict(
            powerspec=self.powerspec, pupil_mode=pm, W_pruned=W64,
            df=self.freq.main.df, dx=self.dx, norm=self._norm,
            logamp_var=self.logamp_var,
            diffraction_limit=self.diffraction_limit, pup_crop=self.pup_crop)
        if (column_factors and synth in ("colfac", "pallas_colfac")
                and not self.temporal):
            with self.profile.stage("column_factors"):
                arrays["L_colfac"] = self._column_factors(W64)
        if self.subharmonics:
            g = self.freq.subharm
            modes = synthesis.make_subharm_modes(g.fx, g.fy, self.Npxls,
                                                 self.dx)
            arrays.update(
                powerspec_subharm=self.powerspec_subharm, subharm_df=g.df,
                subharm_modes=synthesis.subharm_mode_table(modes,
                                                           self.pup_crop))
        if self.temporal:
            arrays.update(self._temporal_arrays())
        return arrays

    def _temporal_arrays(self):
        """The temporal mode's host arrays for :func:`tables_from_numpy`,
        with the AR routes' mode-survival factor ``_ar_alpha`` per layer:
        'auto' keeps pure frozen flow (alpha = 1) while the series is
        shorter than one grid wrap, else decorrelates the modes over one
        wrap time so that the fixed grid never repeats visibly."""
        arrays = dict(powerspec_per_layer=self.powerspec_per_layer,
                      temporal_ps=self.temporal_logamp_powerspec)
        np_dt = np.float32 if self.dtype == torch.float32 else np.float64
        self._sqrt_psd_layers = np.sqrt(self.powerspec_per_layer).astype(np_dt)
        alpha_cfg = self.params.get("TEMPORAL_ALPHA", "auto")
        wrap_steps = np.where(
            self.wind_speed > 0,
            self.Npxls * self.dx / (np.maximum(self.wind_speed, 1e-30)
                                    * self.dt), np.inf)
        if alpha_cfg == "auto":
            alpha = np.where(self.Niter <= wrap_steps, 1.0,
                             np.exp(-1.0 / wrap_steps))
        else:
            alpha = np.full(len(self.h), float(alpha_cfg))
        self._ar_alpha = alpha.astype(np_dt)
        if self._temporal_synth == "ar":
            g = self.freq.main
            arrays.update(
                step_phase=synthesis.ar_step_phase(g.fx, g.fy,
                                                   self.wind_vector, self.dt),
                ar_alpha=alpha)
        else:
            arrays.update(wind_vector=self.wind_vector, dt=self.dt,
                          pup_coords=self.pup_coords[0])
        return arrays

    def _column_factors(self, W64):
        """The per-column Cholesky factors (N, Npup, Npup), numpy complex
        in the working type.

        A float32 run on the card builds them in float32 there; if a column
        fails to factor in float32 it falls back, as the JAX package does,
        to the float64 build on the CPU, cast to complex64. Other runs use
        the float64 build directly. Only the float64 build goes through the
        disk cache (:mod:`.utils.diskcache`), keyed as the JAX package keys
        its own: by the PSD, ``W`` in complex128, the working type and the
        jitter. The card's build is not cached: it takes less time than
        writing its stack to disk (``PERF.md``).
        """
        sqrt_psd = np.sqrt(self.powerspec)
        df = float(self.freq.main.df)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            L = synthesis.column_factors_device(
                sqrt_psd, df, W64, self.device, jitter=synthesis.JITTER_F32)
            if bool(torch.isfinite(torch.view_as_real(L)).all()):
                return L.cpu().numpy()
            logger.info("f32 device factorisation hit an ill-conditioned "
                        "column; using the host float64 path")
        cdt = np.complex64 if self.dtype == torch.float32 else np.complex128
        key = diskcache.table_key(
            "torch-colfac-f64", (self.powerspec, W64),
            (df, str(cdt), synthesis.JITTER_F64))
        L = diskcache.load(key)
        if L is None:
            L = synthesis.column_factors(
                sqrt_psd, df, W64,
                jitter=synthesis.JITTER_F64).numpy().astype(cdt)
            diskcache.save(key, L)
        return L

    def set_seed(self, seed):
        self.seed = seed

    def run(self, progress=False):
        """Draw all Monte Carlo realizations; returns :class:`FastResult`.

        ``progress=True`` writes a progress line per chunk to stderr; the
        numbers are those of ``run()``, bit for bit.
        """
        with self.profile.stage("mc_run"):
            return self._run(progress=progress)

    def _run(self, progress=False):
        """The run from the seeds of :meth:`_run_seeds`."""
        logamp_seed, seed_mc = self._run_seeds()
        # the complex pupil couplings of every chunk, before the
        # log-amplitude factor
        if not self.temporal:
            chunks = self._iid_chunks(seed_mc)
        elif self._ar_route is None:
            chunks = self._temporal_screens_chunks(seed_mc)
        else:
            chunks = self._ar_chunks(*self._ar_start(seed_mc))
        if progress:
            chunks = chunk_progress(
                chunks, self.Nchunks, per_item=self.Niter_per_chunk,
                unit="steps" if self.temporal else "realizations")
        return self._store(self._series(logamp_seed, chunks))

    def _series(self, logamp_seed, chunks, t0=0):
        """The iterates of the chunks' couplings (in series order, of any
        lengths), from the iterate ``t0`` on (0, or a rank's window of a
        sharded run): the log-amplitude factor of ``logamp_seed``'s series,
        then ``|.|^2`` unless ``COHERENT``."""
        self._logamp_seed, self._logamp_cache = logamp_seed, None
        chi = self._draw_logamp().to(self.device)
        coherent = bool(self.params["COHERENT"])
        outs = []
        for pc in chunks:
            n = pc.shape[0]
            out = torch.exp(chi[t0:t0 + n]).to(pc.real.dtype) * pc
            outs.append(out if coherent else out.abs() ** 2)
            t0 += n
        return torch.cat(outs)

    def _store(self, out):
        """The result of the whole series ``out``: its moments on the
        device and the non-finite guard; stores and returns
        :attr:`result`."""
        mean, si, nbad = _moments(out)
        if nbad:
            raise FloatingPointError(
                "Monte Carlo run produced non-finite iterates "
                f"({nbad} non-finite values over {out.shape[0]} iterates)")
        self.result = FastResult(out, self.diffraction_limit,
                                 moments=(mean, si))
        logger.info(self.result)
        return self.result

    def _run_seeds(self, seed=None):
        """The seeds of a run, from ``seed`` (default: the sim's seed): that
        of the log-amplitude series and that of the screens (the Monte
        Carlo draws of an iid run)."""
        gen = make_generator(self.seed if seed is None else seed)
        return draw_seed(gen), draw_seed(gen)

    def _draw_logamp(self):
        """The run's log-amplitude series from its seed, on the CPU: iid,
        or coloured by the temporal PSD in temporal mode."""
        return synthesis.draw_logamp(
            make_generator(self._logamp_seed), self.Niter, self.logamp_var,
            temporal_powerspec=(self.tables["temporal_ps"].cpu()
                                if self.temporal else None),
            dtype=self.dtype)

    def _iid_chunks(self, seed_mc, first=0, count=None, nbatch=None,
                    generator=None):
        """The couplings of every chunk of an iid run, or of the ``count``
        chunks of ``nbatch`` draws from chunk ``first`` (a rank's share of
        a sharded run) with the plain paths drawing from ``generator``."""
        # plain paths draw on the run device from one generator; the
        # kernel keys its Philox by seed_mc and counts chunks in `stream`
        dev_gen = (make_generator(seed_mc, device=self.device)
                   if generator is None else generator)
        T = self.tables
        B = self.Niter_per_chunk if nbatch is None else nbatch
        count = self.Nchunks if count is None else count
        for i in range(first, first + count):
            sh = (synthesis.subharm_screens(
                dev_gen, T["sqrt_psd_sh"], T["sh_df"], T["sh_modes"], B // 2)
                if self.subharmonics else None)
            yield chunk_couplings(T, self._synth, B // 2,
                                  noise=self.params["MC_NOISE"], seed=seed_mc,
                                  stream=i, generator=dev_gen, sh=sh)

    def _pieces(self, step0=0, nsteps=None):
        """``(first step, steps)`` of each chunk of the steps ``step0 ..
        step0 + nsteps - 1`` (default: the whole series), at most
        ``Niter_per_chunk`` steps each."""
        B = self.Niter_per_chunk
        end = step0 + (self.Niter if nsteps is None else nsteps)
        return [(s, min(B, end - s)) for s in range(step0, end, B)]

    def _frozen_flow_coords(self, step0, nsteps):
        """Fractional (rows, cols) pixel coordinates of the pupil along the
        wind for the steps ``step0 .. step0 + nsteps - 1``: (nlayers,
        nsteps, Npup) each, in the working type. Made in float64 from the
        absolute step, so a step's coordinates do not depend on how the
        series is cut into chunks."""
        T = self.tables
        steps = torch.arange(step0 + 1, step0 + nsteps + 1,
                             dtype=torch.float64, device=self.device)
        shifts = (steps * float(T["dt"])) * T["wind_px"][..., None]
        coords = T["pup_coords"][None, None, None, :] + shifts[..., None]
        return coords[:, 0].to(self.dtype), coords[:, 1].to(self.dtype)

    def _temporal_screens_chunks(self, seed_scr, step0=0, nsteps=None):
        """The frozen-flow ('screens') route: one large screen per layer,
        sampled along the wind chunk by chunk, over the whole series or the
        steps ``step0 ..`` of a rank's window."""
        T = self.tables
        screens = synthesis.synthesize_layer_screens(
            make_generator(seed_scr, device=self.device),
            T["sqrt_psd_layers"], float(T["df"]))
        for s, n in self._pieces(step0, nsteps):
            phs = synthesis.sample_frozen_flow(
                screens, *self._frozen_flow_coords(s, n))
            yield synthesis.detector_coupling(phs, T["pm"], float(T["dx"]),
                                              float(T["norm"]))

    def _ar_start(self, seed_scr):
        """The initial Fourier state of an AR series and the seed of its
        boiling noise, both from the run's screen seed."""
        T = self.tables
        gen = make_generator(seed_scr, device=self.device)
        cdtype = (torch.complex64 if self.dtype == torch.float32
                  else torch.complex128)
        a = complex_normal(tuple(T["sqrt_psd_df"].shape), gen,
                           dtype=cdtype) * T["sqrt_psd_df"]
        return a, draw_seed(gen)

    def _ar_series_chunks(self, a, seed_noise, series=0, step0=0,
                          nsteps=None):
        """The layer-summed Fourier coefficients (B, N, N) of every chunk
        from the stock-op recursion from the state ``a`` at the absolute
        step ``step0``, with the AR kernels' noise stream (of series
        ``series`` of a batch: :class:`ar_flow.NoiseStream`)."""
        T = self.tables
        boiling = bool((T["alpha"] < 1).any())
        alpha = T["alpha"][:, None, None]
        sqrt1ma = torch.sqrt(torch.clamp(1.0 - alpha ** 2, min=0.0))
        noise = ar_flow.NoiseStream(
            seed_noise, a.shape[0], self.Npxls, self.Niter,
            noise=self.params["TEMPORAL_NOISE"], device=self.device,
            dtype=a.dtype, series=series)
        for s, n in self._pieces(step0, nsteps):
            a, A = synthesis.ar_flow_series(
                a, noise, T["step_phasor"], T["sqrt_psd_df"], alpha, sqrt1ma,
                n, boiling, step0=s)
            yield A

    def _ar_chunks(self, a, seed_noise, step0=0, nsteps=None):
        """The AR routes from the state ``a`` at the absolute step
        ``step0``, for the whole series or ``nsteps`` steps (a rank's
        window of a pure frozen-flow series): through the AR kernel (its
        plain version on the CPU), one call per chunk from the chunk's
        absolute step, or through the exact batched ``ift2`` of the
        stock-op recursion."""
        if self._ar_route != "kernel":
            yield from self._ar_fft_chunks(a, seed_noise, step0=step0,
                                           nsteps=nsteps)
            return
        T = self.tables
        dx, norm = float(T["dx"]), float(T["norm"])
        kernel = ar_flow.select(a.shape[0])
        for s, n in self._pieces(step0, nsteps):
            c, a = kernel(seed_noise, a, T["ph"], T.get("ns"), T["W"],
                          T["pm"], n, noise=self.params["TEMPORAL_NOISE"],
                          step0=s)
            yield torch.complex(c[:, 0], c[:, 1]) * (dx ** 2 / norm)

    def _ar_fft_chunks(self, a, seed_noise, series=0, step0=0, nsteps=None):
        """The exact AR route from the state ``a``: the stock-op recursion
        with the noise of series ``series`` and the batched centred
        ``ift2``, chunk by chunk, from the absolute step ``step0``."""
        T = self.tables
        dx, norm = float(T["dx"]), float(T["norm"])
        lo, hi = self.pup_crop
        for A in self._ar_series_chunks(a, seed_noise, series, step0, nsteps):
            phs = ift2(A, 1.0).real[:, lo:hi, lo:hi]
            yield synthesis.detector_coupling(phs, T["pm"], dx, norm)

    @property
    def I(self):
        """The run's power series (reference-compatible alias)."""
        if getattr(self, "result", None) is None:
            raise AttributeError("I is available after run()")
        return self.result.power

    @property
    def logamp(self):
        """The run's log-amplitude draws (redrawn lazily from the run's
        seed: the same series the run used)."""
        if getattr(self, "_logamp_seed", None) is None:
            raise AttributeError("logamp is available after run()")
        if self._logamp_cache is None:
            self._logamp_cache = self._draw_logamp().numpy()
        return self._logamp_cache

    # ------------------------------------------------------------------
    # reference-API methods of the temporal mode (``fast/fast.py`` names);
    # run() does not use them
    # ------------------------------------------------------------------

    def compute_logamp(self):
        """Draw (or return) the full log-amplitude series
        (``fast/fast.py:639-645``)."""
        if getattr(self, "_logamp_seed", None) is None:
            self._logamp_seed = self._run_seeds()[0]
            self._logamp_cache = None
        return self.logamp

    def compute_phs_temporal(self, chunk=0, generator=None):
        """Sample one chunk of the frozen-flow phase series
        (``fast/fast.py:607-637``): stores and returns ``self.phs``,
        (Niter_per_chunk, Npup, Npup). The screen seed is drawn from
        ``generator`` (a ``torch.Generator``, as :meth:`sample_screens`
        takes one) when given, else it is the screen seed of :meth:`run`,
        so ``chunk=k`` is the k-th window of the run's own trajectory; in
        AR mode the state is evolved from the series start through the
        stock-op recursion and the exact centred ``ift2``."""
        if not self.temporal:
            raise ValueError("compute_phs_temporal requires TEMPORAL=True")
        seed = (self._run_seeds()[1] if generator is None
                else draw_seed(generator))
        B = self.Niter_per_chunk
        if self._ar_route is None:
            screens = synthesis.synthesize_layer_screens(
                make_generator(seed, device=self.device),
                self.tables["sqrt_psd_layers"], float(self.tables["df"]))
            phs = synthesis.sample_frozen_flow(
                screens, *self._frozen_flow_coords(chunk * B, B))
        else:
            lo, hi = self.pup_crop
            series = self._ar_series_chunks(*self._ar_start(seed))
            for _ in range(chunk + 1):
                A = next(series)
            phs = ift2(A, 1.0).real[:, lo:hi, lo:hi]
        self.phs = phs.cpu().numpy()
        return self.phs

    def compute_detector(self, chunk=0):
        """Pupil-overlap couplings for the phases in ``self.phs``
        (``fast/fast.py:647-668``), times the chunk's log-amplitude
        factor. Requires :meth:`compute_phs_temporal` first."""
        if getattr(self, "phs", None) is None:
            raise ValueError("call compute_phs_temporal first")
        T = self.tables
        phs = torch.as_tensor(self.phs, dtype=self.dtype, device=self.device)
        pc = synthesis.detector_coupling(phs, T["pm"], float(T["dx"]),
                                         float(T["norm"])).cpu().numpy()
        B = self.phs.shape[0]
        chi = self.compute_logamp()[chunk * B:(chunk + 1) * B]
        out = np.exp(chi[:pc.shape[0]]) * pc
        return out if bool(self.params["COHERENT"]) else np.abs(out) ** 2

    # ------------------------------------------------------------------
    # reference-API methods of the iid mode (``fast/fast.py`` names, as
    # ``fast_tpu.Fast`` has them); run() does not use them
    # ------------------------------------------------------------------

    def sample_screens(self, nscreens=2, generator=None):
        """Draw pupil-cropped residual phase screens for inspection
        (``fast/fast.py:589-605``) without touching the run's state:
        ``nscreens`` real (Npup, Npup) screens, the real and imaginary
        parts of complex FFT screens, with the subharmonic screens where
        ``SUBHARM`` is on. ``generator``: a ``torch.Generator`` on the run
        device (default: one seeded by ``SEED``). Stores and returns
        ``self.phs``, numpy."""
        if generator is None:
            generator = make_generator(self.seed, device=self.device)
        T = self.tables
        n2 = max(1, nscreens // 2 + nscreens % 2)
        scr = synthesis.synthesize_screens_complex(
            generator, T["sqrt_psd"], float(T["df"]), n2, crop=self.pup_crop)
        if self.subharmonics:
            scr = scr + synthesis.subharm_screens(
                generator, T["sqrt_psd_sh"], T["sh_df"], T["sh_modes"], n2)
        self.phs = synthesis.double_screens(scr)[:nscreens].cpu().numpy()
        return self.phs

    compute_phs = sample_screens  # reference-name alias

    def init_fftw(self):
        """Reference-API no-op (``fast/fast.py:419-438``): ``torch.fft``
        runs the FFTs; the FFTW and FFTW_THREADS keys are accepted and
        ignored."""
        logger.info("FFTW plans are not used; torch.fft runs the FFTs")

    def init_phs_logamp(self):
        """Reference-API no-op (``fast/fast.py:440-443``): torch manages
        the phase and log-amplitude buffers."""
        logger.info("phase/log-amplitude buffers are managed by torch")

    def compute_mean_irradiance(self, onaxis=True):
        """Mean PSF or coupled flux from the OTF of the residual PSD, the
        analytic path, no Monte Carlo (``fast/fast.py:736-761``), float64
        on the CPU: the on-axis value, or with ``onaxis=False`` the (N, N)
        mean PSF, in the units of the diffraction limit."""
        logger.info("Computing mean irradiance/coupled flux")
        df = self.freq.main.df
        pupil = np.zeros(self.powerspec.shape)
        pm = self.pupil * self.pupil_mode
        pupil[: pm.shape[0], : pm.shape[1]] = pm

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        phs_otf = ift2(t(self.powerspec), df).numpy()
        mid = phs_otf.shape[0] // 2, phs_otf.shape[1] // 2
        phs_sf = phs_otf[mid[0], mid[1]] - phs_otf
        pupil_ft = ft2(t(pupil), self.dx).numpy()
        pupil_otf = ift2(t(np.abs(pupil_ft) ** 2), df).numpy() \
            / (2 * np.pi) ** 2
        otf = np.exp(-phs_sf) * pupil_otf
        if not onaxis:
            psf = ft2(t(otf), self.dx).numpy().real
        else:
            psf = otf.sum().real * self.dx ** 2
        normalisation = (pupil.sum() * self.dx ** 2) ** 2
        return psf * self.diffraction_limit / normalisation

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def make_header(self, params):
        """FITS header with the reference's key set (``fast/fast.py:771-807``)."""
        hdr = fits.Header()
        hdr["ZENITH"] = params["ZENITH_ANGLE"]
        hdr["WVL"] = int(params["WVL"] * 1e9)
        hdr["OTRSCALE"] = (str(params["L0"]) if np.isinf(params["L0"])
                           else params["L0"])
        hdr["INRSCALE"] = params["l0"]
        hdr["POWER"] = params["POWER"]
        hdr["PAA"] = self.paa
        hdr["AO_MODE"] = self.ao_mode
        hdr["TLOOP"] = params["TLOOP"]
        hdr["TEXP"] = params["TEXP"]
        hdr["DSUBAP"] = params["DSUBAP"]
        hdr["ALIAS"] = str(params["ALIAS"])
        hdr["NOISE"] = params["NOISE"]
        hdr["D_GND"] = params["D_GROUND"]
        hdr["OBSC_GND"] = params["OBSC_GROUND"]
        hdr["D_SAT"] = params["D_SAT"]
        hdr["OBSC_SAT"] = params["OBSC_SAT"]
        hdr["AXICON"] = str(params["AXICON"])
        hdr["W0"] = self.W0
        hdr["L_SAT"] = self.L
        hdr["H_SAT"] = params["H_SAT"]
        hdr["DX"] = self.dx
        hdr["NPXLS"] = int(self.Npxls)
        hdr["NITER"] = int(self.Niter)
        hdr["R0"] = self.r0
        hdr["THETA0"] = self.theta0
        hdr["TAU0"] = self.tau0
        hdr["DIFFLIM"] = self.diffraction_limit
        if self.seed is not None:
            hdr["SEED"] = self.seed
        return hdr

    def save(self, fname, **kwargs):
        logger.info("Saving results to %s", fname)
        fits.writeto(fname, np.asarray(self.result.power),
                     header=self.make_header(self.params), **kwargs)


def _moments(out):
    """(mean, scintillation index, non-finite count) of a run's output,
    computed in float64 on its device; three scalars reach the host."""
    if out.is_complex():
        o = out.to(torch.complex128)
        m = o.mean()
        var = (o - m).abs().pow(2).mean()
        si = var / m.abs() ** 2
        mean = complex(m)
    else:
        o = out.to(torch.float64)
        m = o.mean()
        si = ((o - m) ** 2).mean() / (m * m)
        mean = float(m)
    nbad = int((~torch.isfinite(torch.view_as_real(out) if out.is_complex()
                                else out)).sum())
    return mean, float(si), nbad


class FastResult:
    """Unit conversions over the raw normalised Monte Carlo iterates
    (reference ``fast/fast.py:931-994``).

    ``random_iters`` may be a tensor on the run device: the series moves
    to the host on first access of a series-valued property, and the
    summary ``moments = (mean, scintillation index)`` computed on the
    device serve until then.
    """

    def __init__(self, random_iters, diffraction_limit, header=None,
                 moments=None):
        self._raw = random_iters
        self._np = None
        self._moments = moments
        self._dl = diffraction_limit
        if header is not None:
            self.hdr = header

    @property
    def _r(self):
        if self._np is None:
            raw = self._raw
            self._np = (raw.detach().cpu().numpy() if torch.is_tensor(raw)
                        else np.asarray(raw))
            self._raw = None
        return self._np

    @property
    def dB_rel(self):
        return 10 * np.log10(self._r)

    @property
    def dB_abs(self):
        return 10 * np.log10(self._r * self._dl)

    @property
    def dBm(self):
        return 10 * np.log10(self._r * self._dl / 1e-3)

    @property
    def power(self):
        return self._dl * self._r

    @property
    def scintillation_index(self):
        if self._moments is not None and self._np is None:
            return self._moments[1]
        return (self._r / self._r.mean()).var()

    @property
    def avg_power_W(self):
        if self._moments is not None and self._np is None:
            return self._dl * self._moments[0]
        return self.power.mean()

    @property
    def avg_power_dBm(self):
        return 10 * np.log10(self.avg_power_W / 1e-3)

    @property
    def avg_power_dB_rel(self):
        if self._moments is not None and self._np is None:
            return 10 * np.log10(self._moments[0])
        return 10 * np.log10((self.power / self._dl).mean())

    @property
    def avg_power_dB_abs(self):
        return 10 * np.log10(self.avg_power_W)

    def __str__(self):
        return (
            "FAST result statistics:\n"
            f"    Avg. power (W): {self.avg_power_W}\n"
            f"    Avg. power (dBm): {self.avg_power_dBm}\n"
            f"    Avg. power (dB_rel): {self.avg_power_dB_rel}\n"
            f"    Avg. power (dB_abs): {self.avg_power_dB_abs}\n"
            f"    Scintillation index: {self.scintillation_index}\n"
        )


def load(fname):
    """Load a saved result file back into a :class:`FastResult`."""
    hdr = fits.getheader(fname)
    data = np.array(fits.getdata(fname))
    data /= hdr["DIFFLIM"]  # saved in units of power
    return FastResult(data, hdr["DIFFLIM"], header=hdr)
