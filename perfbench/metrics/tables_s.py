"""tables_s: seconds of Fast()'s device tables, the program's own
sim.timings["device_constants"] (the column factors' stage, where a route
builds them, runs inside it)."""


def read(record):
    return record["timings"].get("device_constants")
