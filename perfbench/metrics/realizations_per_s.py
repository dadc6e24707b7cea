"""realizations_per_s: the realizations of every run() that completed in
the window over the window's wall time (host clock)."""


def read(record):
    if record["unit"] != "realizations":
        return None
    return record["window"].rate(record["work_per_run"])
