"""The pod round's host time, synchronized before and after as the
launcher's loop does: every window round's time over their count, in
ms."""


def read(record):
    rounds = record["window"].get("round_s")
    return 1e3 * sum(rounds) / len(rounds) if rounds else None
