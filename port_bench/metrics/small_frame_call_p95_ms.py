"""``call_p95_ms`` in the cells whose frames are small enough that the host
sets the pace: the same reading, under a bound of its own for their wider
spread."""

from port_bench.metrics.call_p95_ms import read  # noqa: F401
