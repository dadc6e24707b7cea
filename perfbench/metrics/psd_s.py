"""psd_s: seconds of Fast()'s PSD stage, the program's own
sim.timings["powerspec"] (a span closed by a device synchronise)."""


def read(record):
    return record["timings"].get("powerspec")
