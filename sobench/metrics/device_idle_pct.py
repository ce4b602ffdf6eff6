"""Share of the traced jobs' wall time in which no kernel, copy or set
ran on the card: 100 * (1 - union of device intervals / window)."""

from sobench import trace as tr


def read(record):
    trace = record["trace"]
    win = trace.window() if trace is not None else None
    if win is None or not trace.ops:
        return None
    busy = tr.union_ns([(s, e) for _, s, e in trace.ops], *win)
    return 100.0 * (1.0 - busy / (win[1] - win[0]))
