"""Readings of a cell's compared numbers under its control, on the card
at the cell's own size (the benchmark's runs never run this).

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, on the realizations or steps that a window of that seed
would have judged (the widest reading over its judged runs):

* ``power_gap`` of the control: the reference computed in float32 with
  every product's operands rounded to bfloat16 (the precision below the
  configuration's one TF32 pass) put in the program's place, against the
  float64 reference;
* ``moments_gap`` of the control: the mean power and scintillation index
  of the program's own series of that seed computed in float32 (below the
  float64 moments the program states) against float64.

Prints one JSON line per seed. Pass ``--device cpu`` to read them on the
CPU at a size the CPU holds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import check, harness  # noqa: E402


def readings(cell, seeds, spec=None, device="cuda", control=True):
    """``[{seed, power_gap, moments_gap, program_power_gap, seconds}]``:
    for each seed the runs that a window of that seed would have judged
    (of a sweep, a window of one turn of its points), the control's
    readings (without ``control``, the program's alone)."""
    import numpy as np
    import torch

    from perfbench.reference.setup.host import HostSetup

    spec = spec or harness.Spec()
    w = spec.cell(cell)
    traffic = spec.traffic(w["traffic"])
    if "threads" in traffic:
        torch.set_num_threads(int(traffic["threads"]))
    params = harness.run_params(spec.config(w["config"]), traffic)
    nruns = len(traffic.get("points", [None]))
    torch.backends.cuda.matmul.allow_tf32 = False
    from fast_tpu_torch import Fast
    setups, sims = {}, {}
    out = []
    for s in seeds:
        t0 = time.perf_counter()
        row = {"seed": int(s), "power_gap": 0.0, "moments_gap": 0.0,
               "program_power_gap": 0.0}
        for r, picks in check.sample(spec.check(cell)["sample"], s, nruns,
                                     int(params["NCHUNKS"]),
                                     int(params["NITER"]),
                                     bool(params["TEMPORAL"])):
            k = harness.point(traffic, r)
            p = harness.point_params(params, traffic, r)
            if k not in setups:
                setups[k] = HostSetup(p)
                sims[k] = Fast(dict(p, SEED=int(s)), device=device)
            ref = check.reference_powers(setups[k], p, int(s) + r, picks,
                                         device=device)
            sims[k].set_seed(int(s) + r)
            power = np.asarray(sims[k].run().power)
            gaps = {"program_power_gap": check.power_gap(power[picks], ref)}
            if control:
                low = check.reference_powers(setups[k], p, int(s) + r, picks,
                                             precision="bf16", device=device)
                p32 = torch.as_tensor(power, dtype=torch.float32,
                                      device=device)
                m32 = p32.mean()
                si32 = ((p32 - m32) ** 2).mean() / (m32 * m32)
                gaps["power_gap"] = check.power_gap(low, ref)
                gaps["moments_gap"] = check.moments_gap(power, float(m32),
                                                        float(si32))
            for name, v in gaps.items():
                row[name] = max(row[name], v)
        if not control:
            del row["power_gap"], row["moments_gap"]
        row["seconds"] = time.perf_counter() - t0
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--program-only", action="store_true",
                    help="read the program's numbers alone, not the control")
    a = ap.parse_args(argv)
    for r in readings(a.workload, a.seeds, device=a.device,
                      control=not a.program_only):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
