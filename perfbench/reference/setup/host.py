"""The set-up of one configuration in float64 on the host: a condensed copy
of the set-up methods of the port's ``engine.Fast`` (the atmosphere, the
grids with their 'auto' rules, the AO masks, the pupils and the fibre
mode, the link budget, the residual phase and log-amplitude PSDs and, in
temporal mode, the AR route's phases and mode survival factors and the
temporal log-amplitude PSD), for the iid and the AR temporal routes
without subharmonics. :class:`HostSetup` takes the configuration dict as
it is run, every key present.
"""

import numpy as np

from . import psd
from .grids import SpatialFrequencies
from .models import ao as ao_spectra
from .models import atmosphere
from .models.scintillation import PupilFilterSampler, temporal_logamp_powerspec
from .ops import apertures


def l_path(h_sat, zeta):
    """Spherical-Earth slant range from altitude and zenith angle [m]."""
    r_earth = 6.371009e6
    zeta = np.radians(zeta)
    b = -2 * r_earth * np.cos(np.pi - zeta)
    c = r_earth ** 2 - (r_earth + h_sat) ** 2
    r1 = (-b + np.sqrt(b ** 2 - 4 * c)) / 2
    r2 = (-b - np.sqrt(b ** 2 - 4 * c)) / 2
    return r1 if r1 >= 0 else r2


def pruned_ift2_matrix(N, lo, hi):
    """Rows ``[lo, hi)`` of the centred inverse-DFT matrix, complex128:
    ``W[u, v] = exp(2j pi (u - N/2)(v - N/2) / N)``."""
    u = np.arange(lo, hi) - N / 2
    v = np.arange(N) - N / 2
    return np.exp(2j * np.pi * np.outer(u, v) / N)


def ar_step_phase(fx, fy, wind_vector, dt):
    """The per-step translation phase ``kappa . v dt`` of every layer and
    mode, wrapped into (-pi, pi]: (nlayers, N, N) float64."""
    v = np.asarray(wind_vector, np.float64)
    phase = (fx[None] * v[:, 0, None, None]
             + fy[None] * v[:, 1, None, None]) * float(dt)
    return np.angle(np.exp(1j * phase))


class HostSetup:
    """Every table a run of the configuration ``p`` reads, in float64.

    Attributes after construction: ``N``, ``npup``, ``dx``, ``pup_crop``,
    ``pm`` (npup, npup) pupil * mode, ``norm``, ``W`` (npup, N) complex,
    ``powerspec`` (N, N), ``logamp_var``, ``diffraction_limit``; temporal:
    ``powerspec_per_layer`` (L, N, N), ``step_phase`` (L, N, N),
    ``alpha`` (L,), ``temporal_ps`` (NITER,).
    """

    def __init__(self, p):
        self.p = p
        self.temporal = bool(p["TEMPORAL"])
        self.niter = int(p["NITER"])
        self._atmos()
        self._grid()
        self._masks()
        self._pupils()
        self._link_budget()
        self._powerspec()
        W = pruned_ift2_matrix(self.N, *self.pup_crop)
        self.W = W
        self.pm = self.pupil * self.pupil_mode
        self.norm = float(self.pm.sum() * self.dx ** 2)
        if self.temporal:
            self._temporal_tables()

    def _atmos(self):
        p = self.p
        zc = 1 / np.cos(np.radians(p["ZENITH_ANGLE"]))
        self.h = np.asarray(p["H_TURB"], float) * zc
        self.cn2 = np.asarray(p["CN2_TURB"], float) * zc
        self.L = (p["L_SAT"] if p["L_SAT"] is not None
                  else l_path(p["H_SAT"], p["ZENITH_ANGLE"]))
        self.dtheta = p["DTHETA"]
        self.paa = np.sqrt(self.dtheta[0] ** 2 + self.dtheta[1] ** 2)
        spd = np.asarray(p["WIND_SPD"], float)
        self.wind_dir = np.asarray(p["WIND_DIR"], float)
        self.wind_vector = (spd * np.array([
            np.cos(np.radians(self.wind_dir)),
            np.sin(np.radians(self.wind_dir)) / zc])).T
        self.wind_speed = np.hypot(self.wind_vector[:, 0],
                                   self.wind_vector[:, 1])
        self.r0_los = atmosphere.cn2_to_r0(self.cn2.sum(), lamda=p["WVL"])
        self.wvl = p["WVL"]
        self.D_ground = p["D_GROUND"]

    def _grid(self):
        p = self.p
        if p["DX"] == "auto":
            self.dx = float(np.min([p["DSUBAP"] / 2, self.r0_los / 2,
                                    self.D_ground / 10]))
            if p["AO_MODE"] == "NOAO":
                self.dx = self.r0_los / 2
        else:
            self.dx = p["DX"]
        if p["NPXLS"] == "auto":
            nyq_aniso = np.pi / (self.h[-1] * self.paa / 206265.0)
            nyq_servo = np.pi / (max(self.wind_speed) * p["TLOOP"])
            nyq_fitting = np.pi / p["DSUBAP"] / 5
            nyq = np.min([nyq_aniso, nyq_servo, nyq_fitting])
            self.N = int(np.max([int(2 * np.ceil(2 * np.pi / (nyq * self.dx)
                                                 / 2)),
                                 int(2 * np.ceil(p["D_GROUND"] / self.dx / 2))
                                 + 2]))
        else:
            self.N = int(p["NPXLS"])
        self.npup = int(np.ceil(self.D_ground / self.dx)) + 2
        self.freq = SpatialFrequencies(self.N, self.dx)
        if self.temporal:
            self.freq.make_temporal_freqs(
                len(self.h), self.N, self.niter, self.wind_speed,
                self.wind_dir, p["DT"], materialize=False)

    def _masks(self):
        p = self.p
        modal, mult, zmax = p["MODAL"], p["MODAL_MULT"], p["ZMAX"]
        if p["AO_MODE"] == "TT":
            zmax, modal, mult = 3, True, 1
        self.lf_mask = ao_spectra.mask_lf(
            self.freq.main, p["DSUBAP"], modal=modal, modal_mult=mult,
            Zmax=zmax, D=self.D_ground).numpy()
        self.hf_mask = 1 - self.lf_mask

    def _pupils(self):
        p = self.p
        N, dx = self.N, self.dx
        self.dx_sat = p["D_SAT"] / 32
        ptype = "axicon" if p["AXICON"] else "gauss"
        pupil = apertures.compute_pupil(N, dx, self.D_ground,
                                        p["OBSC_GROUND"])
        self.pupil_sat = apertures.compute_pupil(32, self.dx_sat, p["D_SAT"],
                                                 p["OBSC_SAT"])
        mode, self.W0 = apertures.compute_gaussian_mode(
            pupil, dx, p["W0"], D=self.D_ground, obsc=p["OBSC_GROUND"],
            ptype=ptype)
        self.pupil_mode_sat, self.W0_sat = apertures.compute_gaussian_mode(
            self.pupil_sat, self.dx_sat, "opt", ptype="gauss")
        self.pupil_filter = apertures.pupil_filter(pupil * mode)
        lo, hi = (N - self.npup) // 2, (N + self.npup) // 2
        self.pup_crop = (lo, hi)
        self.pupil = pupil[lo:hi, lo:hi]
        self.pupil_mode = mode[lo:hi, lo:hi]
        if self.temporal:
            t = self.freq.temporal
            f_max = max(t.fx_axis.max(), t.fy_axis.max())
            dx_req = np.pi / f_max
            n_req = int(2 * np.ceil(2 * np.pi / (self.freq.main.df * dx_req)
                                    / 2))
            pup_t = apertures.compute_pupil(n_req, dx_req, self.D_ground,
                                            p["OBSC_GROUND"],
                                            Ny=2 * self.npup)
            mode_t, _ = apertures.compute_gaussian_mode(pup_t, dx_req,
                                                        W0=self.W0,
                                                        ptype="gauss")
            self.freq.make_logamp_freqs(Nx=n_req, dx=dx_req,
                                        Ny=2 * self.npup, dy=dx)
            self.pupil_filter_temporal = PupilFilterSampler(
                apertures.pupil_filter(pup_t * mode_t),
                self.freq.logamp.fx_axis, self.freq.logamp.fy_axis)

    def _link_budget(self):
        p = self.p
        if p["PROP_DIR"] == "up":
            D_t, D_r = self.D_ground, p["D_SAT"]
            obsc_t, obsc_r = p["OBSC_GROUND"], p["OBSC_SAT"]
            mode, dx_r, pupil_r = (self.pupil_mode_sat, self.dx_sat,
                                   self.pupil_sat)
            w0 = self.W0
        else:
            D_t, D_r = p["D_SAT"], self.D_ground
            obsc_t, obsc_r = p["OBSC_SAT"], p["OBSC_GROUND"]
            mode, dx_r, pupil_r = self.pupil_mode, self.dx, self.pupil
            w0 = self.W0_sat
        wvl = self.wvl
        lb = [10 * np.log10(p["POWER"] / 1e-3),
              10 * np.log10((wvl / (4 * np.pi * self.L)) ** 2)]
        alpha = D_t / (2 * w0)
        gamma = obsc_t / D_t
        g_t = 2 / alpha ** 2 * (np.exp(-alpha ** 2)
                                - np.exp(-gamma ** 2 * alpha ** 2)) ** 2
        lb.append(10 * np.log10((np.pi * D_t ** 2) * 4 * np.pi / wvl ** 2
                                * g_t))
        A = np.pi * ((D_r / 2) ** 2 - (obsc_r / 2) ** 2)
        lb.append(10 * np.log10(4 * np.pi * A / wvl ** 2))
        lb.append(10 * np.log10(p["TRANSMISSION"]))
        lb.append(10 * np.log10(((pupil_r * mode).sum() * dx_r) ** 2
                                / (mode ** 2).sum()))
        self.diffraction_limit = 10 ** (sum(lb) / 10) / 1e3

    def _psd_args(self, g):
        p = self.p
        grid = (g.fx, g.fy, g.fabs, g.fx_axis, g.fy_axis)
        rest = (self.cn2, self.h, self.wind_vector, self.dtheta,
                float(p["NOISE"]),
                float(p["DSUBAP"] if p["DSUBAP"] is not None else 0.0),
                float(p["TEXP"]), float(p["TLOOP"]), float(self.wvl),
                float(self.D_ground), float(p["L0"]), float(p["l0"]))
        x_max = (float(np.max(g.fabs) * self.D_ground / 2)
                 if p["AO_MODE"] == "LGSAO" else None)
        flags = dict(mode=p["AO_MODE"], alias_on=bool(p["ALIAS"]),
                     noise_on=bool(p["NOISE"] > 0), x_max=x_max)
        return grid, rest, flags

    def _powerspec(self):
        g = self.freq.main
        grid, rest, flags = self._psd_args(g)
        out = psd.assemble_main(*grid, g.f, self.lf_mask, self.hf_mask,
                                self.pupil_filter, *rest, **flags)
        self.powerspec = out["powerspec"].numpy()
        self.powerspec_per_layer = out["powerspec_per_layer"].numpy()
        self.logamp_var = float(out["logamp_var"])
        if self.temporal:
            t = self.freq.temporal
            self.temporal_ps = temporal_logamp_powerspec(
                t.fx_axis, t.fy_axis, self.h, self.cn2, self.wvl,
                self.pupil_filter_temporal, float(g.dfy),
                L0=self.p["L0"], l0=self.p["l0"])

    def _temporal_tables(self):
        """The AR route's per-step phase and mode survival factor: 1 while
        the series is shorter than one grid wrap, else exp(-1 / wrap
        steps) ('auto'), or the configured number."""
        p = self.p
        wrap = np.where(self.wind_speed > 0,
                        self.N * self.dx / (np.maximum(self.wind_speed, 1e-30)
                                            * p["DT"]), np.inf)
        a_cfg = p.get("TEMPORAL_ALPHA", "auto")
        if a_cfg == "auto":
            self.alpha = np.where(self.niter <= wrap, 1.0, np.exp(-1.0 / wrap))
        else:
            self.alpha = np.full(len(self.h), float(a_cfg))
        g = self.freq.main
        self.step_phase = ar_step_phase(g.fx, g.fy, self.wind_vector,
                                        p["DT"])
