"""Work of one bilateral filter call, from its parameters and the frame's
shape alone.  Operations per pixel: 8 a nonzero tap (the range weight's
product with the spatial one, 3 products and 4 sums) and 6 more (3 divisions,
3 roundings).  Bytes: the input frame read once, the output written once."""

import numpy as np


def nonzero_taps(ksize: int, sigma_space: float) -> int:
    """Taps inside the inscribed circle whose float32 spatial weight is not 0."""
    r = ksize // 2
    ky, kx = np.mgrid[-r:r + 1, -r:r + 1]
    r2 = kx * kx + ky * ky
    denom = np.float32(np.float32(2.0 * np.float32(sigma_space)) * np.float32(sigma_space))
    weight = np.exp(r2 * (-1.0 / float(denom))).astype(np.float32)
    return int(np.count_nonzero((r2 <= r * r) & (weight != 0)))


def work(kwargs: dict, height: int, width: int, channels: int) -> tuple[float, float]:
    """(operations, bytes) of one call."""
    pixels = height * width
    ops = pixels * (8 * nonzero_taps(kwargs["ksize"], kwargs["sigma_space"]) + 6)
    return float(ops), float(2 * pixels * channels)
