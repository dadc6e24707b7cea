"""step_mfu.iid: the least time the card could take for the traced
window's realizations, over the port's float32 iid routes (the pruned-DFT
route's count, the column-factor route's: perfbench/counts/bounds.py), as
a share of the device's busy time in that window (%)."""

from perfbench.counts.bounds import iid_least_ms


def read(record):
    tr = record["trace"]
    if tr is None or record["unit"] != "realizations" or not tr["busy_s"]:
        return None
    s = record["shape"]
    draws = record["window"].ok * record["work_per_run"] // 2
    least = iid_least_ms(s["N"], s["P"], draws, s["mixed"], s["precision"])
    return 100 * least / 1e3 / tr["busy_s"]
