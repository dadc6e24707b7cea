"""steps_per_s: the time steps of every run() that completed in the
window over the window's wall time (host clock)."""


def read(record):
    if record["unit"] != "steps":
        return None
    return record["window"].rate(record["work_per_run"])
