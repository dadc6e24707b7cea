"""points_per_s: the parameter points of a sweep whose Fast() and run()
completed in the window over the window's wall time (host clock)."""


def read(record):
    if record["unit"] != "points":
        return None
    return record["window"].ok / record["window"].seconds
