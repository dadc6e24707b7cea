"""point_setup_s: the mean seconds of each sweep point's Fast() in the
window: its geometry, float64 PSD stage and device tables (host clock)."""


def read(record):
    inits = record.get("inits")
    if not inits:
        return None
    return sum(inits) / len(inits)
