"""The 95th percentile of every call's latency in the window (from the call
to the return of its synchronize), in ms."""

from port_bench.core import percentile


def read(record):
    return percentile(record.window.latency_ns, 95) / 1e6
