"""setup_s: seconds from the process's start to the window's: imports,
the kernels' build or load, Fast() and one warm run() (host clock)."""


def read(record):
    return record["setup_s"]
