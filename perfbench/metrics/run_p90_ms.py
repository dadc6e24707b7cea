"""run_p90_ms: the 90th percentile (nearest rank) of the wall time of
every run() in the window, from the call to the returned FastResult
(host clock)."""


def read(record):
    return record["window"].percentile_ms(90)
