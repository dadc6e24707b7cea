"""device_idle_pct.iid: the share of the traced window's wall time in
which no operation ran on the device (%), from the profiler's records of
the whole window, traced for CUDA activity alone (perfbench/tracing.py)."""


def read(record):
    tr = record["trace"]
    if tr is None or record["unit"] != "realizations":
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
