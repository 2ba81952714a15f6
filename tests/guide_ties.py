"""Guide inputs full of ties, for the tests of the port's guide on the CPU
(tests/test_torch_guide_ties.py) and on the card (tests/test_torch_cuda.py).
chip_smoke.py makes the same inputs with its own copy of ``tie_inputs``."""

import numpy as np


def tie_inputs(h: int, w: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(blurred (h, w, 3), rtv (h, w)) f32 full of ties for the guide: rtv
    takes 4 levels far apart (so |alpha| is near 1), with the minimum (as
    +0 and -0) sprinkled so that windows hold equal minima in different rows
    and in different columns, and a flat block of whole flat windows;
    blurred differs by tap (13 a column, 23 a row, within 96..160, so the
    blend does not clamp), so a wrong pick moves the output."""
    rng = np.random.default_rng(seed)
    rtv = np.array([500.0, 1000.0, 3000.0], np.float32)[rng.integers(0, 3, (h, w))]
    rtv[rng.random((h, w)) < 0.04] = 0.0
    rtv[rng.random((h, w)) < 0.02] = -0.0
    rtv[h // 4 : h // 4 + h // 2, w // 4 : w // 4 + w // 3] = 1000.0
    yy, xx = np.mgrid[:h, :w]
    blurred = np.stack([96 + (23 * yy + 13 * xx + 7 * c) % 64 + (xx * yy % 8) / 8
                        for c in range(3)], axis=2).astype(np.float32)
    return blurred, rtv
