"""The device's idle share of the profiled round: 1 - (the union of the
device operations' intervals) / (the round's wall time, host clock), in
%."""


def read(record):
    if not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
