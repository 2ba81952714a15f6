"""``mpix_per_s`` in the cells whose frames are small enough that the host
sets the pace: the same reading, under a bound of its own for their wider
spread."""

from port_bench.metrics.mpix_per_s import read  # noqa: F401
