"""Process start to the end of set-up: imports, the inputs from the seed,
the program's objects, in a fresh checkout the kernels' build, and the
first unit of work at the cell's shapes; on the host clock, ending in a
synchronize."""


def read(record):
    return record["setup_s"]
