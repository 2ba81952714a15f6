"""The host's time in the entry, from the call until it returns (before the
synchronize), in us: the mean over every call of the window with the
profiler off (the profiler's own records would inflate it)."""


def read(record):
    host = record.window.host_ns
    return sum(host) / len(host) / 1e3
