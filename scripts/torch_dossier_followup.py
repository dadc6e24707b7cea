"""Follow-ups of the dossier's borderline rows, on the card.

``scripts/torch_validate_hw.py`` gates each row once; these runs take
the rows that came close to a gate apart with more seeds or samples.

* ``means`` (the K3 rows of §2 and §2b): each path runs 2^20
  realizations at each of four seeds (2^18 for the slow ``'matmul'`` and
  K2 runs at 512^2); prints each path's pooled mean with its standard
  error, then for each pair the mean ratio, its z-score and the
  two-sample KS p-value of the pooled samples. The 256^2 flagship (an
  82 px pupil): K1 and K3 ('mixed' and 'gauss'; K3 through the run loop's
  split-layout tables, as §2 does), the stock-op colfac Gaussian process
  and K2 'mixed'. The 512^2 link from a 2 m telescope (a 202 px pupil,
  §2b's): K3 'mixed' and 'gauss', colfac 'gauss', ``'matmul'`` and K2
  'gauss'.
* ``lag1`` (§4's kernel-against-``'fft'`` rows): the lag-1
  autocorrelation of the series of the 16-layer 512^2 link through K5 at
  2,048 and 8,192 steps, and of the temporal flagship through K4 at 16,384
  and 65,536 steps (each row's --quick and default lengths), at 16 seeds
  each: its mean and standard deviation over the seeds (the dossier's
  ``LAG1_SD``); and the kernel against ``SYNTH='fft'`` from the first
  seed (the routes draw the same noise): the largest relative difference
  of the two series and their lag-1 values.
* ``fades`` (§3's 256^2 panel): the 1e-3, 1e-4 and 1e-5 quantiles of
  I/<I> from 2^23 realizations of the 256^2 flagship through K2 'mixed'
  (the default path), K2 'gauss' and the stock-op colfac 'gauss', at
  four seeds each: each path against each at the first seeds (K2
  'mixed' against K2 'gauss' isolates the noise), then the differences
  of the four seeds' means with their standard errors, and each path's
  seed-to-seed standard deviation.

    python scripts/torch_dossier_followup.py [means] [lag1] [fades]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import torch
from scipy.stats import ks_2samp

from torch_validate_hw import (MID, fade_quantiles, fade_tol,
                               flagship_params, lag1)

SEEDS = (101, 102, 103, 104)


def runs(sim):
    """The normalised power of ``sim.run()`` at each seed."""
    out = []
    for s in SEEDS:
        sim.set_seed(s)
        out.append(np.asarray(sim.run()._r, np.float64))
    return np.concatenate(out)


def report(tag, paths):
    print(f"== {tag}")
    for name, x in paths.items():
        print(f"  {name:18s} n={x.size:8d} mean {x.mean():.6f} +- "
              f"{x.std() / np.sqrt(x.size):.6f}")
    names = list(paths)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            x, y = paths[a], paths[b]
            se = np.hypot(x.std() / np.sqrt(x.size), y.std() / np.sqrt(y.size))
            print(f"  {a} vs {b}: ratio {x.mean() / y.mean():.5f} z "
                  f"{(x.mean() - y.mean()) / se:+.2f} KS p "
                  f"{ks_2samp(x, y).pvalue:.4f}", flush=True)


def sim(niter=2 ** 20, nchunks=16, split=False, nlayers=4, **kw):
    from fast_tpu_torch import Fast
    from fast_tpu_torch.ops import colfac_detect as cd
    from fast_tpu_torch.ops.synth_detect import passes
    s = Fast(flagship_params(nlayers, NITER=niter, NCHUNKS=nchunks, **kw),
             device="cuda")
    if split:  # K3 on a pupil K1 takes: the split-layout tables, laid out
        # at the run's precision
        s.tables["T_colfac"] = cd.lay_tables_split(cd.pack_tables_split(
            s.tables["L"], mixed=kw["MC_NOISE"] == "mixed"),
            passes(s._precision))
    return s


def check_means():
    n_slow = 2 ** 18
    k1 = dict(SYNTH="pallas_colfac")
    report("256^2, P=82", {
        "K1 mixed": runs(sim(MC_NOISE="mixed", **k1)),
        "K3 mixed": runs(sim(MC_NOISE="mixed", split=True, **k1)),
        "K1 gauss": runs(sim(MC_NOISE="gauss", **k1)),
        "K3 gauss": runs(sim(MC_NOISE="gauss", split=True, **k1)),
        "colfac gauss": runs(sim(nchunks=256, SYNTH="colfac",
                                 MC_NOISE="gauss")),
        "K2 mixed": runs(sim(SYNTH="pallas_fused", MC_NOISE="mixed"))})
    torch.cuda.empty_cache()
    report("512^2 / 2 m, P=202", {
        "K3 mixed": runs(sim(MC_NOISE="mixed", **k1, **MID)),
        "K3 gauss": runs(sim(MC_NOISE="gauss", **k1, **MID)),
        "colfac gauss": runs(sim(nchunks=256, SYNTH="colfac",
                                 MC_NOISE="gauss", **MID)),
        "matmul (2^18)": runs(sim(n_slow, 64, SYNTH="matmul", **MID)),
        "K2 gauss (2^18)": runs(sim(n_slow, 4, SYNTH="pallas_fused",
                                    MC_NOISE="gauss", **MID))})


def check_lag1(seeds=tuple(range(94, 110))):
    """The seed-to-seed scatter of the lag-1 value of each kernel-against-
    ``'fft'`` row's kernel series, at the row's --quick and default
    lengths; and the kernel against ``'fft'`` from the first seed."""
    rows = (("K5", dict(nlayers=16, NPXLS=512), (2048, 8192)),
            ("K4", dict(), (16384, 65536)))
    for kernel, link, lengths in rows:
        for n in lengths:
            kw = dict(TEMPORAL=True, TEMPORAL_SYNTH="ar", DT=0.001, **link)
            nch = max(1, n // 1024)
            s = sim(n, nch, **kw)
            l1 = []
            for seed in seeds:
                s.set_seed(seed)
                x = np.asarray(s.run()._r, np.float64)
                l1.append(lag1(x))
                if seed == seeds[0]:
                    k = x
            l1 = np.array(l1)
            print(f"  {n} steps, {kernel}: lag-1 over {len(l1)} seeds mean "
                  f"{l1.mean():.5f} sd {l1.std(ddof=1):.5f} (min "
                  f"{l1.min():.5f}, max {l1.max():.5f})", flush=True)
            f = sim(n, nch, SYNTH="fft", **kw)
            f.set_seed(seeds[0])
            f = np.asarray(f.run()._r, np.float64)
            print(f"  {n} steps, seed {seeds[0]}: {kernel} against fft "
                  f"largest relative difference {np.abs(k / f - 1).max():.3e}"
                  f", lag-1 {lag1(k):.6f} / {lag1(f):.6f}", flush=True)
            torch.cuda.empty_cache()


def check_fades(n=2 ** 23, nseeds=4):
    paths = {"K2 mixed": (42, dict(SYNTH="pallas_fused", MC_NOISE="mixed")),
             "K2 gauss": (47, dict(SYNTH="pallas_fused", MC_NOISE="gauss")),
             "colfac gauss": (41, dict(SYNTH="colfac", MC_NOISE="gauss"))}
    q = {}
    for name, (seed0, kw) in paths.items():
        per = 4096 if kw["SYNTH"] == "colfac" else 65536
        s = sim(n, max(1, n // per), **kw)
        q[name] = []
        for seed in range(seed0, seed0 + 100 * nseeds, 100):
            s.set_seed(seed)
            q[name].append(fade_quantiles(np.asarray(s.run()._r, np.float64)))
            print(f"  {name}, seed {seed}: " + ", ".join(
                f"q={k:g} {v:.2f} dB" for k, v in q[name][-1].items()),
                flush=True)
        del s
    names = list(q)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            print(f"  {a} - {b}, first seeds: " + ", ".join(
                f"q={k:g} {q[a][0][k] - q[b][0][k]:+.2f} dB (gate "
                f"{fade_tol(k * n)})" for k in q[a][0]), flush=True)
    if nseeds < 2:
        return
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            out = []
            for k in q[a][0]:
                va = np.array([d[k] for d in q[a]])
                vb = np.array([d[k] for d in q[b]])
                se = np.hypot(va.std(ddof=1), vb.std(ddof=1)) / np.sqrt(nseeds)
                out.append(f"q={k:g} {va.mean() - vb.mean():+.2f} +- "
                           f"{se:.2f} dB")
            print(f"  {a} - {b}, mean over {nseeds} seeds: "
                  + ", ".join(out), flush=True)
    for name in names:
        print(f"  {name}: seed-to-seed sd " + ", ".join(
            f"q={k:g} {np.std([d[k] for d in q[name]], ddof=1):.2f} dB"
            for k in q[name][0]), flush=True)


def main(argv=None):
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 2
    os.environ["FAST_TPU_TABLE_CACHE"] = "0"
    checks = {"means": check_means, "lag1": check_lag1,
              "fades": check_fades}
    for name in (argv or sys.argv[1:]) or ["means"]:
        print(f"== {name}", flush=True)
        checks[name]()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
