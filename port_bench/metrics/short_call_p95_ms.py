"""``call_p95_ms`` in the cells whose calls take under a millisecond on the
device (see ``short_call_mpix_per_s``): the same reading, under a bound of
its own."""

from port_bench.metrics.call_p95_ms import read  # noqa: F401
