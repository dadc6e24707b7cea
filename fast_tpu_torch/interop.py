"""Per-configuration tables, from numpy arrays to the port's device tables.

The JAX package and this one compute the same per-configuration tables on
the host in numpy float64. :func:`tables_from_numpy` turns them into the
tensors the Monte Carlo run reads, on the run device, once per
configuration. ``Fast`` builds its own tables through it, and a test can
hand it the JAX package's arrays so that both packages run the same
inputs. This module imports nothing of the JAX package.
"""

import numpy as np
import torch

from .ops.synth_detect import mixing_matrix, pad_pupil

#: The arrays :func:`tables_from_numpy` reads.
KEYS = ("powerspec", "pupil_mode", "W_pruned", "df", "dx", "norm",
        "logamp_var", "diffraction_limit", "pup_crop")


def tables_from_numpy(arrays, device="cpu", dtype=torch.float32):
    """Device tables of one configuration.

    Args:
        arrays: dict with the :data:`KEYS`: ``powerspec`` (N, N) float64
            residual phase PSD; ``pupil_mode`` (Npup, Npup) the product
            pupil * mode; ``W_pruned`` (Npup, N) pruned inverse-DFT matrix;
            the scalars ``df``, ``dx``, ``norm`` (sum of pupil * mode times
            dx^2), ``logamp_var``, ``diffraction_limit``; and ``pup_crop``
            (lo, hi).
        device: the run device.
        dtype: working type of the plain paths (float32 or float64).

    Returns:
        dict of tensors on ``device``: ``sqrt_psd`` (N, N), ``pm`` (Npup,
        Npup) and ``W`` (Npup, N, complex) in the working type for the
        plain paths; ``s_t`` (N, N) = sqrt(PSD)^T * df, ``wr``/``wi`` (P, N)
        and ``pm_t`` (P, P), zero padded as the kernel takes them
        (:func:`~fast_tpu_torch.ops.synth_detect.pad_pupil`), and
        ``mix`` (N, N), all float32, for the synth-detect kernel; and 0-d
        float64 CPU tensors for the scalars, with ``pup_crop`` a (2,)
        int64 tensor.
    """
    missing = [k for k in KEYS if k not in arrays]
    if missing:
        raise KeyError(f"tables_from_numpy needs {missing}")
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    np_cdt = np.complex64 if dtype == torch.float32 else np.complex128

    def dev(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)

    powerspec = np.asarray(arrays["powerspec"], np.float64)
    N = powerspec.shape[-1]
    sqrt_psd = np.sqrt(powerspec)
    pm = np.asarray(arrays["pupil_mode"], np.float64)
    W = np.asarray(arrays["W_pruned"])
    # float32 K2 tables exactly as the TPU kernel's wrapper builds them:
    # cast first, then transpose / scale / pad
    s32 = sqrt_psd.astype(np.float32)
    W32 = W.astype(np.complex64)
    wr, wi, pm_t = pad_pupil(dev(W32.real), dev(W32.imag),
                             dev(pm.astype(np.float32).T))
    T = dict(
        sqrt_psd=dev(sqrt_psd.astype(np_dt)),
        pm=dev(pm.astype(np_dt)),
        W=dev(W.astype(np_cdt)),
        s_t=dev(s32.T * np.float32(arrays["df"])),
        wr=wr, wi=wi, pm_t=pm_t,
        mix=dev(mixing_matrix(N)),
        pup_crop=torch.as_tensor(np.asarray(arrays["pup_crop"], np.int64)),
    )
    for k in ("df", "dx", "norm", "logamp_var", "diffraction_limit"):
        T[k] = torch.tensor(float(arrays[k]), dtype=torch.float64)
    return T
