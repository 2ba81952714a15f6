"""``mpix_per_s`` in the cells whose calls take under a millisecond on the
device, so that the host's time a call, which swings with the shared host,
is a tenth of the wall or more: the same reading, under a bound of its own
for their wider spread."""

from port_bench.metrics.mpix_per_s import read  # noqa: F401
