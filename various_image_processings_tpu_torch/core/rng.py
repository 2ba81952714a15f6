"""Deterministic pseudo-image generator.

NumPy twin of ``various_image_processings_tpu/core/rng.py``: a byte-exact
``std::mt19937`` and the reference test fixture ``random_array`` (reference:
test/random_array.hpp:10-31), seeded 42.  The twist runs as NumPy slices
instead of a Python loop, so a 4K test image takes about a second instead of
tens; tests/test_torch_core.py pins the stream equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)


class MT19937:
    """std::mt19937-compatible Mersenne Twister (32-bit)."""

    def __init__(self, seed: int = 5489):
        mt = [0] * _N
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self._mt = np.asarray(mt, dtype=np.uint32)
        self._idx = _N

    def _twist(self) -> None:
        """In-place twist.  Element i reads mt[i+1] (not yet updated) and
        mt[(i+M) % N], which is updated already once i ≥ N−M.  Slices of
        N−M = 227 elements never read an element updated inside the same
        slice, so each slice is one vectorized step of the sequential loop."""
        mt = self._mt
        step = _N - _M
        for lo in range(0, _N, step):
            hi = min(lo + step, _N)
            i = np.arange(lo, hi)
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            mag = np.where((y & np.uint32(1)) != 0, _MATRIX_A, np.uint32(0))
            mt[i] = mt[(i + _M) % _N] ^ (y >> np.uint32(1)) ^ mag
        self._idx = 0

    def next_block(self) -> np.ndarray:
        """Return the next 624 tempered outputs as uint32."""
        if self._idx >= _N:
            self._twist()
        y = self._mt.copy()
        y ^= y >> np.uint32(11)
        y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
        y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
        y ^= y >> np.uint32(18)
        self._idx = _N
        return y

    def raw(self, count: int) -> np.ndarray:
        """Return `count` raw uint32 draws."""
        blocks = []
        remaining = count
        while remaining > 0:
            b = self.next_block()
            blocks.append(b[: min(remaining, _N)])
            remaining -= _N
        return np.concatenate(blocks)[:count]


def random_array(length: int, max_value=255, dtype=np.uint8) -> np.ndarray:
    """Twin of ``random_array<T>(len, max)`` (reference: test/random_array.hpp:10).

    Integer dtypes: ``rand() % max`` (so 255 never appears with the
    default).  Float dtype: ``max * float(rand()) / numeric_limits<uint32>::max()``
    evaluated in f32.
    """
    raw = MT19937(42).raw(length)
    if np.issubdtype(np.dtype(dtype), np.floating):
        # static_cast<float>(u32) rounds to nearest f32; the uint32 max
        # denominator also converts to f32 (4294967296.0).
        fvals = raw.astype(np.float32)
        denom = np.float32(np.uint32(0xFFFFFFFF))
        return ((np.float32(max_value) * fvals) / denom).astype(np.float32)
    return (raw % np.uint32(max_value)).astype(dtype)


def random_image(height: int, width: int, channels: int = 3, max_value=255,
                 dtype=np.uint8) -> np.ndarray:
    """Deterministic HWC test image drawn from the seed-42 MT19937 stream."""
    arr = random_array(height * width * channels, max_value, dtype)
    return arr.reshape(height, width, channels)
