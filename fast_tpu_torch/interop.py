"""Per-configuration tables, from numpy arrays to the port's device tables.

The JAX package and this one compute the same per-configuration tables on
the host in numpy float64. :func:`tables_from_numpy` turns them into the
tensors the Monte Carlo run reads, on the run device, once per
configuration. ``Fast`` builds its own tables through it, a sweep builds
each sample's through :func:`sample_tables`, and a test can hand either the
JAX package's arrays (those of one simulation, or the per-sample arrays of
a JAX sweep or scan) so that both packages run the same inputs. This
module imports nothing of the JAX package.
"""

import numpy as np
import torch

from .ops.colfac_detect import colfac_layout, kernel_table
from .ops.synth_detect import laid_w, mixing_matrix, pad_pupil

#: The arrays :func:`tables_from_numpy` reads.
KEYS = ("powerspec", "pupil_mode", "W_pruned", "df", "dx", "norm",
        "logamp_var", "diffraction_limit", "pup_crop")


def tables_from_numpy(arrays, device="cpu", dtype=torch.float32,
                      noise="mixed"):
    """Device tables of one configuration.

    Args:
        arrays: dict with the :data:`KEYS`: ``powerspec`` (N, N) float64
            residual phase PSD; ``pupil_mode`` (Npup, Npup) the product
            pupil * mode; ``W_pruned`` (Npup, N) pruned inverse-DFT matrix;
            the scalars ``df``, ``dx``, ``norm`` (sum of pupil * mode times
            dx^2), ``logamp_var``, ``diffraction_limit``; and ``pup_crop``
            (lo, hi). Optionally: ``L_colfac`` (N, Npup,
            Npup) complex, the column factors; ``powerspec_subharm``
            (levels, 3, 3) with ``subharm_df`` (levels,) and
            ``subharm_modes`` (levels, 3, 3, Npup, Npup) complex, the
            mean-subtracted, cropped modes
            (:func:`~fast_tpu_torch.synthesis.subharm_mode_table`).
            Temporal mode: ``powerspec_per_layer`` (nlayers, N, N) and
            ``temporal_ps`` (NITER,), the temporal log-amplitude PSD;
            with them either ``step_phase`` (nlayers, N, N), the float64
            per-step phase wrapped into (-pi, pi]
            (:func:`~fast_tpu_torch.synthesis.ar_step_phase`), and
            ``ar_alpha`` (nlayers,) for the AR routes, or ``wind_vector``
            (nlayers, 2), ``dt`` and ``pup_coords`` (Npup,) for the
            frozen-flow screens.
        device: the run device.
        dtype: working type of the plain paths (float32 or float64).
        noise: the colfac kernel's noise, 'mixed' or 'gauss', which its
            packed factor table depends on.

    Returns:
        dict of tensors on ``device``: ``sqrt_psd`` (N, N), ``pm`` (Npup,
        Npup) and ``W`` (Npup, N, complex) in the working type for the
        plain paths; ``s_t`` (N, N) = sqrt(PSD)^T * df, ``wr``/``wi`` (P, N)
        and ``pm_t`` (P, P), zero padded as the kernels take them
        (:func:`~fast_tpu_torch.ops.synth_detect.pad_pupil`), and
        ``mix`` (N, N), all float32, for the synth-detect kernel; on the
        card, ``w_laid``, the laid W table that the iid kernels' products
        read (:func:`~fast_tpu_torch.ops.synth_detect.laid_w`: ``wr``,
        ``wi`` and ``mix`` split and laid out once; on the CPU the plain
        tables are the kernels' and there is none); and 0-d
        float64 CPU tensors for the scalars, with ``pup_crop`` a (2,)
        int64 tensor. With ``L_colfac``: ``L`` (N, Npup, Npup) complex in
        the working type for ``SYNTH='colfac'`` and the colfac-detect
        kernel's float32 table: ``S_colfac`` for K1 at a pupil of at most
        128 px, ``T_colfac`` for K3 above
        (:func:`~fast_tpu_torch.ops.colfac_detect.kernel_table`: on the
        card split and laid out once for the kernel's pass 1, on the CPU
        as the plain version takes it). With the
        subharmonic tables: ``sqrt_psd_sh`` (levels, 3, 3), ``sh_df``
        (levels,) and ``sh_modes`` (levels, 3, 3, Npup, Npup) complex, in
        the working type. Temporal mode (no ``mix``, which only the iid
        kernel reads): ``sqrt_psd_layers`` (nlayers, N, N) and
        ``temporal_ps`` in the working type. AR routes: ``sqrt_psd_df`` =
        sqrt(PSD) df, ``step_phase``, ``step_phasor`` (complex) and
        ``alpha`` (nlayers,) in the working type for the exact route, and
        for the AR kernels ``ph`` (nlayers, N, N) complex64 =
        alpha e^{i phase} and, where some alpha < 1, ``ns`` float32 =
        sqrt(1 - alpha^2) sqrt(PSD) df, both folded in float64 before the
        cast. Screens route: ``wind_px`` (nlayers, 2) = wind / dx in pixels
        per second and ``pup_coords`` (Npup,), float64, with ``dt``.
    """
    _check(arrays)
    temporal = arrays.get("powerspec_per_layer") is not None
    return {**_grid_tables(arrays, temporal, device, dtype),
            **_own_tables(arrays, device, dtype, noise)}


#: The arrays a sample may not vary: the tables made from them are the
#: grid's and the pupil's (:func:`_grid_tables` reads these alone), shared
#: by the samples of a sweep.
GRID_KEYS = ("W_pruned", "pupil_mode", "df", "dx", "norm", "pup_crop",
             "subharm_df", "subharm_modes")


def _check(arrays):
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"tables_from_numpy needs {missing}")


def as_torch_dtype(dtype):
    """A numpy dtype or scalar type (``np.float32``, ``"complex128"``) as
    the torch dtype of the same name; a torch dtype is returned as is."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _dtypes(dtype):
    if dtype == torch.float32:
        return np.float32, np.complex64
    return np.float64, np.complex128


def _dev(a, device):
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _grid_tables(arrays, temporal, device, dtype):
    """The tables of the grid and the pupil, from :data:`GRID_KEYS` only."""
    g = {k: arrays.get(k) for k in GRID_KEYS}
    np_dt, np_cdt = _dtypes(dtype)
    pm = np.asarray(g["pupil_mode"], np.float64)
    W = np.asarray(g["W_pruned"])
    W32 = W.astype(np.complex64)
    # float32 K2 tables exactly as the TPU kernel's wrapper builds them:
    # cast first, then transpose / pad
    wr, wi, pm_t = pad_pupil(_dev(W32.real, device), _dev(W32.imag, device),
                             _dev(pm.astype(np.float32).T, device))
    T = dict(pm=_dev(pm.astype(np_dt), device),
             W=_dev(W.astype(np_cdt), device), wr=wr, wi=wi, pm_t=pm_t,
             pup_crop=torch.as_tensor(np.asarray(g["pup_crop"], np.int64)))
    if not temporal:
        T["mix"] = _dev(mixing_matrix(W.shape[-1]), device)
        if wr.device.type == "cuda":
            T["w_laid"] = laid_w(wr, wi, T["mix"])
    for k in ("df", "dx", "norm"):
        T[k] = torch.tensor(float(g[k]), dtype=torch.float64)
    if g["subharm_modes"] is not None:
        T["sh_df"] = _dev(np.asarray(g["subharm_df"]).astype(np_dt), device)
        T["sh_modes"] = _dev(np.asarray(g["subharm_modes"]).astype(np_cdt),
                             device)
    return T


def _own_tables(arrays, device, dtype, noise):
    """The tables of one configuration's atmosphere and link: every table
    but the grid's."""
    np_dt, np_cdt = _dtypes(dtype)

    def dev(a):
        return _dev(a, device)

    sqrt_psd = np.sqrt(np.asarray(arrays["powerspec"], np.float64))
    # cast first, then transpose / scale, as the TPU kernel's wrapper does
    T = dict(sqrt_psd=dev(sqrt_psd.astype(np_dt)),
             s_t=dev(sqrt_psd.astype(np.float32).T
                     * np.float32(arrays["df"])))
    for k in ("logamp_var", "diffraction_limit"):
        T[k] = torch.tensor(float(arrays[k]), dtype=torch.float64)
    if arrays.get("L_colfac") is not None:
        L = dev(np.asarray(arrays["L_colfac"]).astype(np_cdt))
        T["L"] = L
        split = colfac_layout(L.shape[1]) == "split"
        T["T_colfac" if split else "S_colfac"] = kernel_table(
            L, mixed=noise == "mixed")
    if arrays.get("powerspec_subharm") is not None:
        T["sqrt_psd_sh"] = dev(np.sqrt(arrays["powerspec_subharm"])
                               .astype(np_dt))
    if arrays.get("powerspec_per_layer") is not None:
        sqrt_layers = np.sqrt(np.asarray(arrays["powerspec_per_layer"],
                                         np.float64)).astype(np_dt)
        T["sqrt_psd_layers"] = dev(sqrt_layers)
        T["temporal_ps"] = dev(np.asarray(arrays["temporal_ps"]).astype(np_dt))
        if arrays.get("step_phase") is not None:
            _ar_tables(T, arrays, sqrt_layers, np_dt, dev)
        else:
            T["wind_px"] = dev(np.asarray(arrays["wind_vector"], np.float64)
                               / float(arrays["dx"]))
            T["pup_coords"] = dev(np.asarray(arrays["pup_coords"],
                                             np.float64))
            T["dt"] = torch.tensor(float(arrays["dt"]), dtype=torch.float64)
    return T


def sample_tables(arrays, samples, device="cpu", dtype=torch.float32,
                  noise="mixed"):
    """Device tables of each sample of a sweep or a parameter scan.

    Args:
        arrays: the arrays of :func:`tables_from_numpy` that every sample
            shares (the grid's, the pupil's).
        samples: dict of per-sample arrays under the keys of
            :func:`tables_from_numpy` they replace, each a sequence with
            one entry per sample (a stacked array or a list): the keys an
            orbit pass varies are ``powerspec``, ``logamp_var``,
            ``diffraction_limit``, ``L_colfac`` and ``powerspec_subharm``.
            None of :data:`GRID_KEYS`.
        device, dtype, noise: as :func:`tables_from_numpy`.

    Returns:
        list of table dicts, one per sample; the tables of the grid and the
        pupil (``W``, ``wr``, ``wi``, ``pm``, ``pm_t``, ``mix``, the
        subharmonic modes) are built once and shared by every dict.
    """
    fixed = sorted(set(samples) & set(GRID_KEYS))
    if fixed:
        raise ValueError(f"the samples of a sweep share the grid and the "
                         f"pupil; {fixed} may not vary")
    counts = {len(v) for v in samples.values()}
    if len(counts) != 1:
        raise ValueError(f"every per-sample array needs one entry per "
                         f"sample; got lengths {sorted(counts)}")
    n = counts.pop()
    _check(arrays)
    grid = _grid_tables(arrays, arrays.get("powerspec_per_layer") is not None
                        or "powerspec_per_layer" in samples, device, dtype)
    return [{**grid, **_own_tables({**arrays,
                                    **{k: v[i] for k, v in samples.items()}},
                                   device, dtype, noise)}
            for i in range(n)]


def _ar_tables(T, arrays, sqrt_layers, np_dt, dev):
    """The AR routes' tables, as ``fast_tpu.engine`` builds them
    (``_build_run_all_fn_temporal_ar``): the per-layer sqrt-PSD is cast to
    the working type before the float64 ``df`` scales it, ``alpha`` is
    rounded to the working type before it is folded, and the phasor and
    the noise scale are folded in float64 and cast once."""
    phase = np.asarray(arrays["step_phase"], np.float64)
    alpha = np.asarray(arrays["ar_alpha"], np.float64).astype(np_dt)
    sqrt_psd_df = (sqrt_layers * np.float64(arrays["df"])).astype(np_dt)
    T["sqrt_psd_df"] = dev(sqrt_psd_df)
    T["step_phase"] = dev(phase.astype(np_dt))
    T["step_phasor"] = torch.complex(torch.cos(T["step_phase"]),
                                     torch.sin(T["step_phase"]))
    T["alpha"] = dev(alpha)
    if np_dt == np.float32:
        ph = np.exp(1j * phase) * alpha[:, None, None]
        T["ph"] = dev(ph.astype(np.complex64))
        if np.any(alpha < 1.0):
            # asarray: np.float64 of a one-layer array is a scalar
            sqrt1ma = np.sqrt(np.maximum(
                0.0, 1.0 - np.asarray(alpha, np.float64) ** 2))
            T["ns"] = dev((sqrt1ma[:, None, None]
                           * np.float64(sqrt_psd_df)).astype(np.float32))
