"""The FL step's host time without its round: every window step's time
(a host clock around the step, which ends in the read of its losses, a
synchronize) over their count, in ms."""


def read(record):
    steps = record["window"].get("step_s")
    return 1e3 * sum(steps) / len(steps) if steps else None
