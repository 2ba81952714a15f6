"""The share of the profiled window in which no device operation runs: one
minus the union of their intervals over the window's length."""


def read(record):
    p = record.profile
    if p is None or not p.device:
        return None
    return 100.0 * (1.0 - p.busy_ns / (p.end_ns - p.start_ns))
