"""Color conversions.

Twin of ``various_image_processings_tpu/core/colors.py``.

``bgr2lab_u8_exact`` is OpenCV's fixed-point 8-bit BGR→Lab (the conversion
the reference's SLIC init calls, include/cpp/slic.hpp:166) written as
integer tensor ops on the image's own device: int32 gathers from the sRGB
gamma and cube-root tables, 12-bit integer XYZ coefficients over the D65
white point and ``CV_DESCALE`` rounding shifts.  The arithmetic is exact
integer arithmetic, so the CPU and the card give the same bytes, equal to
``cv2.cvtColor`` on all 2²⁴ colors (tests/test_torch_colors.py).

``bgr2lab_u8`` is the float conversion (within ±1 code of the exact one).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_GAMMA_SHIFT = 3
_LAB_SHIFT = 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT


def _srgb_linearize(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c > 0.04045, torch.pow((c + 0.055) / 1.055, 2.4), c / 12.92)


def bgr2lab_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) u8 BGR → (H, W, 3) u8 Lab (OpenCV 8-bit convention), in f32."""
    bgr = bgr_u8.to(torch.float32) / 255.0
    b, g, r = (_srgb_linearize(bgr[..., i]) for i in range(3))
    x = 0.412453 * r + 0.357580 * g + 0.180423 * b
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    x = x / 0.950456
    z = z / 1.088754

    def f(t):
        return torch.where(t > 0.008856, torch.pow(t, 1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(x), f(y), f(z)
    lum = torch.where(y > 0.008856, 116.0 * fy - 16.0, 903.3 * y)
    a = 500.0 * (fx - fy) + 128.0
    bb = 200.0 * (fy - fz) + 128.0
    lab = torch.stack([lum * 255.0 / 100.0, a, bb], dim=-1)
    return torch.round(lab).clamp(0, 255).to(torch.uint8)


@functools.cache
def _lab_tables():
    """OpenCV initLabTabs() twin: tables built in float32 with
    round-half-to-even (cvRound), exactly like modules/imgproc/color_lab.cpp.

    int32 arithmetic suffices downstream: every intermediate is bounded by
    max(gamma)·Σ|coeff| = 2040·4095 ≈ 8.4e6 ≪ 2³¹ (and the Lab linear
    combinations by 500·max(cbrt_tab) ≈ 1.9e7)."""
    f32 = np.float32
    i = np.arange(256, dtype=np.float32)
    x = i * f32(1.0 / 255.0)
    g = np.where(x <= f32(0.04045), x / f32(12.92),
                 np.power((x + f32(0.055)) / f32(1.055), f32(2.4),
                          dtype=np.float32))
    gamma_tab = np.rint(f32(255.0 * (1 << _GAMMA_SHIFT)) * g).astype(np.int32)

    tab_len = 256 * 3 // 2 * (1 << _GAMMA_SHIFT)
    j = np.arange(tab_len, dtype=np.float32)
    xx = j * f32(1.0 / (255.0 * (1 << _GAMMA_SHIFT)))
    fv = np.where(xx < f32(0.008856),
                  xx * f32(7.787) + f32(0.13793103448275862),
                  np.cbrt(xx, dtype=np.float32))
    cbrt_tab = np.rint(f32(1 << _LAB_SHIFT2) * fv).astype(np.int32)

    d65 = np.array([0.950456, 1.0, 1.088754])
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    coeffs = np.rint(m * (1 << _LAB_SHIFT) / d65[:, None]).astype(np.int32)
    return gamma_tab, cbrt_tab, coeffs


@functools.cache
def _device_tables(device: torch.device):
    gamma_tab, cbrt_tab, coeffs = _lab_tables()
    return (torch.from_numpy(gamma_tab).to(device), torch.from_numpy(cbrt_tab).to(device),
            [[int(v) for v in row] for row in coeffs])


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def bgr2lab_u8_exact(bgr_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 BGR → (..., 3) u8 Lab on the input's device, bit-identical
    to ``cv2.cvtColor(img, cv2.COLOR_BGR2Lab)``."""
    gamma, cbrt, c = _device_tables(bgr_u8.device)
    idx = bgr_u8.to(torch.int64)
    b, g, r = (gamma[idx[..., i]] for i in range(3))
    fx, fy, fz = (cbrt[_descale(r * c[k][0] + g * c[k][1] + b * c[k][2], _LAB_SHIFT).long()]
                  for k in range(3))
    lscale = (116 * 255 + 50) // 100
    lshift = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)
    lum = _descale(lscale * fy + lshift, _LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([lum, a, bb], dim=-1).clamp(0, 255).to(torch.uint8)
