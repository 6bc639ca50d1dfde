"""A kernel's share of its roofline in the first profiled unit of work:
the least time of each of its calls at the cell's shape
(``bench/roofline.py``) over the device time the trace gives every device
operation whose name holds ``marker``, in %. Nothing where the kernel did
not run, or where the trace's calls differ from the launches the program
counted (the shape would be unknown)."""
from bench.roofline import bound_s


def share(record, marker: str, launch_name: str, cost):
    hits = [cs for name, cs in record.get("kernels", {}).items()
            if marker in name]
    calls = sum(c for c, _ in hits)
    seconds = sum(s for _, s in hits)
    if calls == 0 or seconds <= 0:
        return None
    if record["launches"].get(launch_name) != calls:
        return None
    return 100.0 * calls * bound_s(*cost) / seconds
