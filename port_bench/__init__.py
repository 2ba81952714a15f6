"""The benchmark of the PyTorch and CUDA port (various_image_processings_tpu_torch).

``run.py`` runs one cell of ``BENCHMARK.json`` (at the checkout's root);
``core.py`` holds what every cell shares; each configuration, traffic mix,
input generator, reference, work count and metric is a file of its own under
``configs/``, ``traffic/``, ``inputs/``, ``refs/``, ``counts/`` and
``metrics/``, found by its name.  ``control.py`` reads the numbers that the
limits of ``correct`` were set from.  Nothing here imports jax or the JAX
package, and ``refs/`` imports nothing of the port.
"""
