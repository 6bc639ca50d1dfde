"""The samples the window trained (a kind's unit: one token position in
the LM cells) over the window's host-clock wall time, which ends in a
synchronize."""


def read(record):
    w = record["window"]
    return w["samples"] / w["wall_s"] if w["samples"] else None
