"""Simulation engine: configuration -> power spectra -> Monte Carlo run.

The iid Monte Carlo path of ``fast_tpu.engine`` in PyTorch:

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
  colfac-detect kernel K1 and ``'pallas_fused'`` (what 'auto' picks for
  other float32 runs) the synth-detect kernel K2, on CUDA; on the CPU they
  run their plain torch versions. ``'matmul'``, ``'colfac'`` and ``'fft'``
  are the stock-op paths. ``SUBHARM=True`` adds the low-order subharmonic
  screens on every path, inside the detect pass of both kernels.

Not ported yet, and refused with ``NotImplementedError``: ``TEMPORAL``,
``SYNTH='pallas'`` (K7) and ``run(progress=True)`` (ROADMAP.md, queues 1
and 2).
"""

import logging

import numpy as np
import torch

from . import conf
from . import psd
from .grids import SpatialFrequencies
from .interop import tables_from_numpy
from .models import ao as ao_spectra
from .models import atmosphere
from .ops import apertures
from .ops.rng import draw_seed, make_generator
from .ops import colfac_detect as cd
from .ops.synth_detect import pack_subharm, supports, synth_detect
from . import synthesis
from .utils import fits
from .utils.log import init_logging
from .utils.profiling import StageTimer

logger = logging.getLogger(__name__)

_NOT_PORTED = {"pallas": "ROADMAP.md queue 2, K7"}
_PORTED = ("auto", "pallas_fused", "pallas_colfac", "matmul", "colfac", "fft")


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
    the synth-detect kernel, 'pallas_fused', elsewhere. 'pallas_colfac'
    raises for a pupil over 128 px on any device. On a CUDA device
    'pallas_fused' raises here for a grid or pupil the kernel does not
    take, rather than at the first chunk; on the CPU it runs the kernel's
    plain version, which takes every shape.
    """
    if synth == "auto":
        if dtype == torch.float64:
            synth = "fft"
        elif N >= 512 and P <= 128:
            synth = "pallas_colfac"
        else:
            synth = "pallas_fused"
    if synth == "pallas_colfac" and not cd.supports(N, P):
        raise ValueError(
            f"the colfac-detect kernel (SYNTH='pallas_colfac') takes a pupil "
            f"of at most 128 px; got NPXLS={N}, a {P} px pupil. The "
            f"split-layout kernel for wider pupils (K3, ROADMAP.md queue 2) "
            f"is not ported yet; SYNTH='matmul' runs the stock-op path")
    if (synth == "pallas_fused" and device.type == "cuda"
            and not supports(N, P, mixed=noise == "mixed")):
        raise ValueError(
            f"the synth-detect kernel (SYNTH='pallas_fused', what 'auto' "
            f"picks for float32) takes a pupil of at most 128 px and, with "
            f"MC_NOISE='mixed', a grid of at most 2368 px; got NPXLS={N}, "
            f"a {P} px pupil. SYNTH='matmul' runs the stock-op path")
    return synth


def chunk_couplings(T, synth, nbatch, *, noise="mixed", seed=0, stream=0,
                    generator=None, sh=None):
    """Complex pupil couplings of one chunk: ``2 * nbatch`` screens.

    ``T`` are the device tables of :func:`tables_from_numpy`. The kernel
    paths, 'pallas_fused' and 'pallas_colfac', draw from their Philox keyed
    by ``seed`` with counter word ``stream``; 'matmul', 'colfac' and 'fft'
    draw from ``generator``. ``sh`` are optional (nbatch, Npup, Npup)
    complex subharmonic screens, added to the screens of every path.
    Returns the couplings scaled by ``dx^2 / norm``, before the
    log-amplitude factor.
    """
    dx, norm = float(T["dx"]), float(T["norm"])
    if synth in ("pallas_fused", "pallas_colfac"):
        sh_t = None if sh is None else pack_subharm(sh, T["wr"].shape[0])
        if synth == "pallas_fused":
            mix = T["mix"] if noise == "mixed" else None
            c = synth_detect(seed, T["s_t"], T["wr"], T["wi"], T["pm_t"],
                             nbatch, mix=mix, stream=stream, sh_t=sh_t)
        else:
            c = cd.colfac_detect(seed, T["S_colfac"], T["wr"], T["wi"],
                                 T["pm_t"], nbatch, mixed=noise == "mixed",
                                 stream=stream, sh_t=sh_t)
        return torch.complex(c[:, 0], c[:, 1]) * (dx ** 2 / norm)
    df = float(T["df"])
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
        if self.temporal:
            raise NotImplementedError(
                "TEMPORAL=True is not ported yet (ROADMAP.md queue 1, "
                "item 7: the temporal slice)")
        if p["SYNTH"] in _NOT_PORTED:
            raise NotImplementedError(
                f"SYNTH={p['SYNTH']!r} is not ported yet "
                f"({_NOT_PORTED[p['SYNTH']]})")
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
        if p.get("MC_NOISE", "gauss") not in ("gauss", "mixed"):
            raise ValueError("MC_NOISE must be 'gauss'|'mixed'")

        if p["NPXLS"] == "auto":
            nyq_aniso = np.pi / (self.h[-1] * self.paa / 206265.0)
            nyq_servo = np.pi / (max(self.wind_speed) * p["TLOOP"])
            nyq_fitting = np.pi / p["DSUBAP"] / 5
            nyq = np.min([nyq_aniso, nyq_servo, nyq_fitting])
            nyq_npxls = int(2 * np.ceil(2 * np.pi / (nyq * self.dx) / 2))
            ap_npxls = int(2 * np.ceil(p["D_GROUND"] / self.dx / 2)) + 2
            self.Npxls = int(np.max([nyq_npxls, ap_npxls]))
            logger.info("Auto set NPXLS to %s", self.Npxls)
            if p["AO_MODE"] == "NOAO" and not np.isinf(p["L0"]):
                L0_npxls = int(2 * np.ceil((p["L0"] * 2) / self.dx) / 2)
                if L0_npxls > self.Npxls:
                    logger.warning(
                        "L0 set with NOAO mode, low orders may be "
                        "undersampled. Recommended NPXLS: %s", L0_npxls)
        else:
            self.Npxls = p["NPXLS"]
        if self.Npxls > 2048:
            logger.warning(
                "NPXLS is large (%s) and may cause very high memory usage",
                self.Npxls)
        self.Npxls_pup = int(np.ceil(self.D_ground / self.dx)) + 2
        self.freq = SpatialFrequencies(self.Npxls, self.dx)
        # subharmonics are not used in temporal mode, as in the JAX package
        self.subharmonics = bool(p["SUBHARM"]) and not self.temporal
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
        self.pupil = self.pupil[lo:hi, lo:hi]
        self.pupil_mode = self.pupil_mode[lo:hi, lo:hi]
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
        if problems:
            raise ValueError("simulation state invalid: " + "; ".join(problems))
        return True

    # ------------------------------------------------------------------
    # Monte Carlo run
    # ------------------------------------------------------------------

    def _prepare_device_constants(self):
        """Move the per-configuration tables to the run device, with the
        column factors of the colfac paths and the subharmonic tables."""
        synth = self._synth
        if not synth.startswith("pallas"):
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
        if synth in ("colfac", "pallas_colfac"):
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
        self.tables = tables_from_numpy(arrays, device=self.device,
                                        dtype=self.dtype,
                                        noise=self.params["MC_NOISE"])

    def _column_factors(self, W64):
        """The per-column Cholesky factors (N, Npup, Npup), numpy complex
        in the working type.

        A float32 run on the card builds them in float32 there; if a column
        fails to factor in float32 it falls back, as the JAX package does,
        to the float64 build on the CPU, cast to complex64. Other runs use
        the float64 build directly.
        """
        sqrt_psd = np.sqrt(self.powerspec)
        df = float(self.freq.main.df)
        if self.device.type == "cuda" and self.dtype == torch.float32:
            L = synthesis.column_factors_device(sqrt_psd, df, W64,
                                                self.device)
            if bool(torch.isfinite(torch.view_as_real(L)).all()):
                return L.cpu().numpy()
            logger.info("f32 device factorisation hit an ill-conditioned "
                        "column; using the host float64 path")
        cdt = np.complex64 if self.dtype == torch.float32 else np.complex128
        return synthesis.column_factors(sqrt_psd, df, W64).numpy().astype(cdt)

    def set_seed(self, seed):
        self.seed = seed

    def run(self, progress=False):
        """Draw all Monte Carlo realizations; returns :class:`FastResult`."""
        if progress:
            raise NotImplementedError(
                "run(progress=True) is not ported yet (ROADMAP.md queue 1, "
                "item 4)")
        with self.profile.stage("mc_run"):
            return self._run()

    def _run(self):
        gen = make_generator(self.seed)
        self._logamp_seed = draw_seed(gen)
        self._logamp_cache = None
        seed_mc = draw_seed(gen)
        chi = synthesis.draw_logamp(make_generator(self._logamp_seed),
                                    self.Niter, self.logamp_var,
                                    dtype=self.dtype).to(self.device)
        # plain paths draw on the run device from one generator; the
        # kernel keys its Philox by seed_mc and counts chunks in `stream`
        dev_gen = make_generator(seed_mc, device=self.device)
        coherent = bool(self.params["COHERENT"])
        T = self.tables
        B = self.Niter_per_chunk
        outs = []
        for i in range(self.Nchunks):
            sh = (synthesis.synthesize_subharm_complex(
                dev_gen, T["sqrt_psd_sh"], T["sh_df"], T["sh_modes"], B // 2)
                if self.subharmonics else None)
            pc = chunk_couplings(T, self._synth, B // 2,
                                 noise=self.params["MC_NOISE"], seed=seed_mc,
                                 stream=i, generator=dev_gen, sh=sh)
            out = torch.exp(chi[i * B:(i + 1) * B]).to(pc.real.dtype) * pc
            outs.append(out if coherent else out.abs() ** 2)
        out = torch.cat(outs)
        mean, si, nbad = _moments(out)
        if nbad:
            raise FloatingPointError(
                "Monte Carlo run produced non-finite iterates "
                f"({nbad} non-finite values over {out.shape[0]} iterates)")
        self.result = FastResult(out, self.diffraction_limit,
                                 moments=(mean, si))
        logger.info(self.result)
        return self.result

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
            self._logamp_cache = synthesis.draw_logamp(
                make_generator(self._logamp_seed), self.Niter,
                self.logamp_var, dtype=self.dtype).numpy()
        return self._logamp_cache

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
