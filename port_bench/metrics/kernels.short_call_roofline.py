"""The kernels' share of the roofline in the cells that report
``short_call_mpix_per_s`` (``_roofline.py`` has the arithmetic)."""

from port_bench.metrics._roofline import read  # noqa: F401
