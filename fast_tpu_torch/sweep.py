"""Link-geometry sweeps: one skeleton, per-sample spectra and tables.

The port of ``fast_tpu.sweep``. The reference's orbit code constructs
one fully-initialised simulation per orbit sample — N complete init
pipelines (``fast/complete_orbit_simulation.py:217-228``). Here a sweep
shares a single grid/AO/pupil skeleton (those depend only on the static
configuration) and runs only the per-sample quantities — layer heights
and Cn2 (zenith scaling), wind vectors (azimuth rotation and slew
correction), point-ahead angle, slant range — through the float64 PSD
assembly (:func:`fast_tpu_torch.psd.assemble_main`, on the CPU, one sample
after another). Each sample then becomes a lightweight clone of the
skeleton with its own device tables (:func:`fast_tpu_torch.interop.
sample_tables`: its own sqrt-PSD, norm, log-amplitude variance,
subharmonic spectra and, on the colfac routes, its own column factors;
the grid's tables shared), ready for
:func:`fast_tpu_torch.parallel.run_scan_sharded`.

Restrictions: the sweep shares NPXLS/DX (pass them explicitly so the
'auto' rules cannot diverge), and supports the iid Monte Carlo mode
(TEMPORAL=False; SUBHARM supported) — the production regime for orbit
scans.
"""

import copy
import logging

import numpy as np
import torch

from . import psd
from .engine import Fast, calculate_wind_correction, l_path
from .interop import sample_tables
from .synthesis import pruned_ift2_matrix

logger = logging.getLogger(__name__)


def build_sweep(base_params, samples, device="cuda"):
    """Build lightweight per-sample simulations on ``device``.

    Args:
        base_params: config dict; must give explicit ``NPXLS`` and ``DX``
            (shared grid) and use ``TEMPORAL=False``. ``SUBHARM=True`` is
            supported. Without a ``SYNTH`` key the clones take the
            synth-detect kernel ('pallas_fused', K2) for float32 on a CUDA
            device and 'matmul' elsewhere, as the JAX package takes its
            fused kernel on the TPU; an explicit 'auto' resolves through
            the base simulation.
        samples: dict of per-sample arrays (length ``nsamples`` each), any
            of: ``ZENITH_ANGLE``, ``L_SAT``, ``DTHETA`` (n, 2), ``ANISO_DL``
            (n, 2), ``AZIMUT_SAT`` — the quantities an orbit pass varies
            (reference ``complete_orbit_simulation.py:217-228``).
        device: the run device of every clone.

    Returns:
        list of :class:`Fast` clones sharing the skeleton, each with its
        own power spectra, log-amplitude variance, link budget and device
        tables — run them serially or with
        :func:`fast_tpu_torch.parallel.run_scan_sharded`.
    """
    if base_params.get("TEMPORAL"):
        raise NotImplementedError("build_sweep supports TEMPORAL=False")
    if base_params.get("NPXLS") in (None, "auto") or \
            base_params.get("DX") in (None, "auto"):
        raise ValueError("pass explicit NPXLS and DX so the sweep shares "
                         "one grid")
    base_params = dict(base_params)
    if "SYNTH" not in base_params:
        # factor-free default, as the JAX package's: the fused kernel on
        # the accelerator for float32, else matmul; set on the base too,
        # so its init builds no factor stack that no clone uses
        base_params["SYNTH"] = (
            "pallas_fused"
            if (torch.device(device).type == "cuda"
                and np.dtype(base_params.get("DTYPE", "float32"))
                == np.float32)
            else "matmul")
        logger.info(
            "sweep clones default to the factor-free SYNTH='%s' — pass "
            "SYNTH explicitly to override", base_params["SYNTH"])

    nsamples = len(next(iter(samples.values())))
    base = Fast(dict(base_params), device=device)
    p = base.params
    prof = base.profile  # sweep stages land in the shared StageTimer

    # --- per-sample geometry (host, cheap) ---
    zen = np.asarray(samples.get(
        "ZENITH_ANGLE", np.full(nsamples, p["ZENITH_ANGLE"])), dtype=float)
    gamma = 1 / np.cos(np.radians(zen))
    h_b = np.asarray(p["H_TURB"], float)[None, :] * gamma[:, None]
    cn2_b = np.asarray(p["CN2_TURB"], float)[None, :] * gamma[:, None]

    if "L_SAT" in samples:
        L_b = np.asarray(samples["L_SAT"], dtype=float)
    else:
        L_b = np.array([l_path(p["H_SAT"], z) for z in zen])

    dtheta_b = np.asarray(samples.get(
        "DTHETA", np.tile(np.asarray(p["DTHETA"], float), (nsamples, 1))),
        dtype=float)

    wind_spd = np.asarray(p["WIND_SPD"], float)
    wind_dir = np.asarray(p["WIND_DIR"], float)[None, :].repeat(nsamples, 0)
    if "AZIMUT_SAT" in samples:
        wind_dir = (wind_dir
                    - np.asarray(samples["AZIMUT_SAT"], float)[:, None]) % 360
    wind_vec_b = np.stack([
        wind_spd * np.cos(np.radians(wind_dir)),
        wind_spd * np.sin(np.radians(wind_dir)) / gamma[:, None],
    ], axis=-1)
    if "ANISO_DL" in samples:
        for i in range(nsamples):
            wind_vec_b[i] += calculate_wind_correction(
                h_b[i], np.asarray(samples["ANISO_DL"])[i], p["TLOOP"])

    # --- the float64 PSD assembly of each sample (the engine's own, so
    # clones match full per-sample inits by construction) ---
    def per_sample(g, assemble, *head):
        grid, rest, flags = base._psd_args(g)
        return [{k: v.numpy() for k, v in assemble(
            *grid, *head, cn2_b[i], h_b[i], wind_vec_b[i], dtheta_b[i],
            *rest[4:], **flags).items()} for i in range(nsamples)]

    with prof.stage("sweep_assemble"):
        out = per_sample(base.freq.main, psd.assemble_main, base.freq.main.f,
                         base.lf_mask, base.hf_mask, base.pupil_filter)
    if base.subharmonics:
        with prof.stage("sweep_assemble_subharm"):
            out_sh = per_sample(base.freq.subharm, psd.assemble_subharm,
                                base.freq.subharm.df, base.lf_mask_subharm)

    # --- stamp out lightweight clones ---
    sweep_synth = base_params["SYNTH"]
    if sweep_synth == "auto":
        # configs built from DEFAULTS carry SYNTH='auto' explicitly; the
        # clones take the base's engine-resolved pick
        sweep_synth = base._synth
    colfac = sweep_synth in ("colfac", "pallas_colfac")
    sims, per = [], {k: [] for k in ("powerspec", "logamp_var",
                                     "diffraction_limit")}
    if colfac:
        per["L_colfac"] = []
        W64 = pruned_ift2_matrix(base.Npxls, *base.pup_crop,
                                 dtype=np.complex128)
    if base.subharmonics:
        per["powerspec_subharm"] = []
    with prof.stage("sweep_clones"):
        for i in range(nsamples):
            o = out[i]
            s = copy.copy(base)
            s.params = dict(p)
            s.params["ZENITH_ANGLE"] = zen[i]
            s.params["SYNTH"] = s._synth = sweep_synth
            s.zenith_correction = gamma[i]
            s.h, s.cn2, s.L = h_b[i], cn2_b[i], L_b[i]
            s.wind_vector = wind_vec_b[i]
            s.wind_speed = np.hypot(wind_vec_b[i, :, 0], wind_vec_b[i, :, 1])
            s.dtheta = dtheta_b[i]
            s.paa = float(np.hypot(*dtheta_b[i]))
            s.powerspec = o["powerspec"]
            s.powerspec_per_layer = o["powerspec_per_layer"]
            s.logamp_powerspec = o["logamp_powerspec"]
            # per-sample error budgets (noise_error is sample-invariant:
            # the noise PSD depends only on the shared grid and config)
            for k in ("logamp_var", "phs_var", "fitting_error",
                      "aniso_servo_error", "alias_error"):
                setattr(s, k, float(o[k]))
            s.phs_var_weights = o["phs_var_weights"]
            # link budget: only the free-space term varies along the pass
            s.link_budget = dict(base.link_budget)
            s.link_budget["free_space"] = 10 * np.log10(
                (s.wvl / (4 * np.pi * s.L)) ** 2)
            s.diffraction_limit = 10 ** (sum(s.link_budget.values()) / 10) \
                / 1e3
            if base.subharmonics:
                for k, v in out_sh[i].items():
                    setattr(s, k, v)
                per["powerspec_subharm"].append(s.powerspec_subharm)
            if colfac:
                # the factors follow the sample's own PSD: a clone that
                # kept the base's would run the base atmosphere
                per["L_colfac"].append(s._column_factors(W64))
            for k in ("powerspec", "logamp_var", "diffraction_limit"):
                per[k].append(getattr(s, k))
            sims.append(s)
        tables = sample_tables(base._table_arrays(column_factors=False), per,
                               device=base.device, dtype=base.dtype,
                               noise=p["MC_NOISE"],
                               precision=base._precision)
        for s, T in zip(sims, tables):
            s.tables = T
    return sims
