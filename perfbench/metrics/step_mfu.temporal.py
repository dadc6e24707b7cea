"""step_mfu.temporal: the least time the card could take for the traced
window's AR steps (perfbench/counts/bounds.py's ar_bound), as a share of
the device's busy time in that window (%)."""

from perfbench.counts.bounds import PEAKS, ar_bound


def read(record):
    tr = record["trace"]
    if tr is None or record["unit"] != "steps" or not tr["busy_s"]:
        return None
    s = record["shape"]
    steps = record["window"].ok * record["work_per_run"]
    least = ar_bound(s["L"], s["N"], s["P"], steps, s["boiling"],
                     peak=PEAKS[s["precision"]])[0]
    return 100 * least / 1e3 / tr["busy_s"]
