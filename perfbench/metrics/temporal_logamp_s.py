"""temporal_logamp_s: seconds of the temporal log-amplitude PSD inside
Fast()'s PSD stage, the program's own sim.timings["temporal_logamp"] (a
span nested in "powerspec", so psd_s still holds it); None where the
program has no such span."""


def read(record):
    return record["timings"].get("temporal_logamp")
