"""ar_roofline: the least time the card could take for the traced
window's AR steps (perfbench/counts/bounds.py's ar_bound) as a share of
the device seconds of the AR kernels alone in that window (%): the
records whose names hold one of KERNELS, the layer update, the two
products and the sums of the detect partials."""

from perfbench.counts.bounds import PEAKS, ar_bound

KERNELS = ("ar_update", "ar_dft", "ar_detect", "sum_tiles")


def read(record):
    tr = record["trace"]
    if tr is None or record["unit"] != "steps":
        return None
    busy = sum(s for name, s in tr["per_kernel"].items()
               if any(k in name for k in KERNELS))
    if not busy:
        return None
    s = record["shape"]
    steps = record["window"].ok * record["work_per_run"]
    least = ar_bound(s["L"], s["N"], s["P"], steps, s["boiling"],
                     peak=PEAKS[s["precision"]])[0]
    return 100 * least / 1e3 / busy
