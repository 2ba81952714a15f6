"""Precomputed filter kernels (LUTs) for the bilateral-filter family.

NumPy twin of ``various_image_processings_tpu/core/luts.py`` (reference:
include/cpp/bilateral_filter.hpp:12-37).  The tables are built on the host
in float64 exactly as the C++ does, then stored as float32 — bit-identical
table contents are what makes the port's LUT-gather filter bit-exact to the
golden layer.  tests/test_torch_core.py pins every table equal to the JAX
package's.
"""

from __future__ import annotations

import numpy as np

# Range-kernel table lengths: the bilateral/joint filters index by the L1
# distance of three u8 channels (max 3*255), the adaptive filter by an
# offset-widened distance (max 2*3*255).  Reference:
# include/cpp/bilateral_filter.hpp:12 (256*3) and
# include/cpp/adaptive_bilateral_filter.hpp:34 (512*3).
COLOR_TABLE_SIZE_BILATERAL = 256 * 3
COLOR_TABLE_SIZE_ADAPTIVE = 512 * 3


def space_kernel(ksize: int, sigma_space: float) -> np.ndarray:
    """(ksize, ksize) f32 spatial Gaussian, zeroed outside the inscribed circle.

    Mirrors include/cpp/bilateral_filter.hpp:18-29: entries with
    ``kx²+ky² > radius²`` are exactly 0.
    """
    radius = ksize // 2
    # -1. / (2 * σs * σs): the product is evaluated in f32 (σs is float in
    # C++), the division in f64.
    denom = np.float32(np.float32(2.0 * np.float32(sigma_space)) * np.float32(sigma_space))
    coeff = -1.0 / float(denom)
    ky, kx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    r2 = (kx * kx + ky * ky).astype(np.int64)
    table = np.exp(r2 * coeff).astype(np.float32)
    table[r2 > radius * radius] = 0.0
    return table


def color_table(sigma_color: float, size: int = COLOR_TABLE_SIZE_BILATERAL) -> np.ndarray:
    """(size,) f32 range Gaussian table: ``exp(-(i*i) / (2 σc²))``.

    Mirrors include/cpp/bilateral_filter.hpp:31-34.
    """
    denom = np.float32(np.float32(2.0 * np.float32(sigma_color)) * np.float32(sigma_color))
    coeff = -1.0 / float(denom)
    i = np.arange(size, dtype=np.int64)
    return np.exp((i * i) * coeff).astype(np.float32)


def pre_compute_kernels(ksize: int, sigma_space: float, sigma_color: float,
                        color_table_size: int = COLOR_TABLE_SIZE_BILATERAL):
    """Return (space_kernel (k,k) f32, color_table (size,) f32)."""
    return space_kernel(ksize, sigma_space), color_table(sigma_color, color_table_size)


def tap_table(space: np.ndarray) -> np.ndarray:
    """(n, 4) int32 table of the nonzero taps of a (k, k) space kernel, in
    the reference's (ky, kx) scan order: ``dy, dx, f32 bits of ws, 0``.

    Taps with zero spatial weight add exactly 0 to every sum, so dropping
    them keeps the sums bit-identical.  This is the layout the CUDA kernel
    reads (csrc/bilateral.cu), one 16-byte load per tap."""
    space = np.asarray(space, np.float32)
    dy, dx = np.nonzero(space)  # row-major, i.e. (ky, kx) order
    ws_bits = np.ascontiguousarray(space[dy, dx]).view(np.int32)
    return np.stack([dy, dx, ws_bits, np.zeros_like(dy)], axis=1).astype(np.int32)


def gauss_coeff_f32(sigma: float) -> np.float32:
    """f32 value of ``-1. / (2 σ²)`` with the C++ evaluation order."""
    denom = np.float32(np.float32(2.0 * np.float32(sigma)) * np.float32(sigma))
    return np.float32(-1.0 / float(denom))
