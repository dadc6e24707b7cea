"""Whether the timed path was right: the program's outputs of the window
against the plain reference (``perfbench/reference``).

After the window the check draws from the seed which runs it judges and,
in each, which outputs: in an iid run ``draws_per_chunk`` draws of every
chunk (both realizations of each), in a temporal run ``steps_per_chunk``
steps of every chunk and each chunk's first and last step. The reference
works out the power of each from the run's parameters and seed (the
temporal series from its start, through every step), and two numbers are
compared, each with the limit of ``checks/<cell>.json``:

* ``power_gap``: the widest gap between a judged realization's power and
  the reference's, over the mean of the reference's powers;
* ``moments_gap``: the wider relative gap between the mean power and the
  scintillation index that the program reports (``FastResult``) and those
  of the program's own series, in float64.
"""

import numpy as np


def sample(check, seed, nruns, nchunks, niter, temporal):
    """``[(run index, picks)]`` to judge, drawn from ``seed``: the runs,
    then in each run the realizations (iid: ``draws_per_chunk`` draws of
    every chunk, both screens of each) or the steps (temporal:
    ``steps_per_chunk`` steps of every chunk, and its first and last)."""
    rng = np.random.default_rng([int(seed), 0xC4EC])
    want = min(int(check["runs"]), nruns)
    runs = sorted(rng.choice(nruns, size=want, replace=False).tolist())
    out = []
    for r in runs:
        B = niter // nchunks
        if temporal:
            k = min(int(check["steps_per_chunk"]), B)
            picks = np.unique(np.concatenate([
                i * B + np.concatenate([[0, B - 1],
                                        rng.choice(B, size=k, replace=False)])
                for i in range(nchunks)]))
        else:
            nb = B // 2
            k = min(int(check["draws_per_chunk"]), nb)
            picks = np.concatenate([
                i * B + d + off
                for i in range(nchunks)
                for d in [np.sort(rng.choice(nb, size=k, replace=False))]
                for off in (0, nb)])
        out.append((r, np.sort(picks)))
    return out


def power_gap(program, reference):
    """The widest gap between two arrays of powers over the mean of the
    reference's."""
    program = np.asarray(program, np.float64)
    reference = np.asarray(reference, np.float64)
    return float(np.max(np.abs(program - reference)) / np.mean(reference))


def moments_gap(power, mean, si):
    """The wider relative gap of the reported mean power and
    scintillation index from those of the series ``power`` (float64)."""
    p = np.asarray(power, np.float64)
    m = p.mean()
    s = ((p - m) ** 2).mean() / (m * m)
    return float(max(abs(mean - m) / abs(m), abs(si - s) / abs(s)))


def reference_powers(setup, params, seed, picks, precision="float64",
                     device="cpu"):
    """The reference's powers of the realizations or steps ``picks`` of
    the run of seed ``seed``."""
    from .reference import plain
    if params["TEMPORAL"]:
        return plain.ar_powers(setup, seed, picks,
                               noise=params["TEMPORAL_NOISE"],
                               precision=precision, device=device)
    return plain.iid_powers(setup, seed, int(params["NCHUNKS"]), picks,
                            noise=params["MC_NOISE"], precision=precision,
                            device=device)


def judge(judged, limits, device="cpu", failed=0):
    """The compared numbers and ``correct``.

    ``judged``: ``[(setup, params, seed, picks, power series, mean, si)]``
    of the program's runs, ``setup`` the reference's ``HostSetup`` of the
    run's ``params``. Returns ``(correct, {name: (value, limit)})``."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gaps, mgaps = [], []
        for setup, params, seed, picks, power, mean, si in judged:
            ref = reference_powers(setup, params, seed, picks,
                                   device=device)
            gaps.append(power_gap(power[picks], ref))
            mgaps.append(moments_gap(power, mean, si))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # no completed run to judge reads as infinitely far off
    numbers = {"power_gap": (max(gaps, default=float("inf")),
                             limits["power_gap"]),
               "moments_gap": (max(mgaps, default=float("inf")),
                               limits["moments_gap"])}
    correct = failed == 0 and all(v <= lim for v, lim in numbers.values())
    return correct, numbers
