"""Image I/O, CUDA-event timing and the native host runtime's loader.

The names the JAX package's ``utils`` exports: ``imread``, ``imread_gray``
and ``imwrite`` (``io.py``), ``measure``, ``measure_chained``,
``measure_throughput``, ``fence`` and ``trace`` (``profiling.py``), and the
``native`` module, which builds its C++ source at first use, not here."""

from . import native as native
from .io import imread as imread
from .io import imread_gray as imread_gray
from .io import imwrite as imwrite
from .profiling import fence as fence
from .profiling import measure as measure
from .profiling import measure_chained as measure_chained
from .profiling import measure_throughput as measure_throughput
from .profiling import trace as trace
