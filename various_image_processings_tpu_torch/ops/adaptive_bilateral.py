"""Adaptive bilateral filter (Zhang–Allebach style).

PyTorch counterpart of ``various_image_processings_tpu/ops/adaptive_bilateral.py``
(reference: include/cpp/adaptive_bilateral_filter.hpp:13-104, the CUDA kernel
src/adaptive_bilateral_filter_impl.cu:7-152).  Per output pixel:

- offset = center − box mean of the (2r+1)² window, the box sum taken from
  the border-replicated integral image and divided by k² in f32 (a true
  division: the divisor is a 0-d tensor on the input's device, never a
  Python number, which PyTorch's CUDA division turns into a reciprocal
  multiply);
- per nonzero tap in (ky, kx) order, the range index
  ``int((|Δ0 − o0| + |Δ1 − o1|) + |Δ2 − o2|)`` with Δ = pixel − center, each
  op rounded in f32 and the sum truncated, as the C++ does (:41-45);
- ``wk = lut[idx] * ws`` from the f64-built, f32-stored 1536-entry table;
- ``u8(floor(sums / sumk + 0.5))``, and 0 where every weight underflowed to
  0: the reference divides 0/0 there and its NaN casts to u8 0.

Written as golden/adaptive_bilateral.py is, with the table gather instead of
the TPU kernels' exp2 recompute (2⁶⁴ bias, grid rounding), so both the plain
version (``impl="torch"``) and the CUDA kernel (``impl="cuda"``,
csrc/adaptive_bilateral.cu) are bit-exact to the golden layer, subnormal
weights included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.luts import COLOR_TABLE_SIZE_ADAPTIVE, color_table, space_kernel, tap_table
from ..core.pad import replicate_pad
from ..utils.profiling import SPANS
from . import _validate
from ._dispatch import resolve_impl
from .bilateral_texture import _device_scalar
from .cuda import adaptive_bilateral as cuda_abf
from .integral_image import window_sums


def box_mean(box: torch.Tensor, ksize: int) -> torch.Tensor:
    """f32 ``box / k²`` as a true IEEE division on every device (the C++
    :54-56); box: f32 window sums, exact integers."""
    return box / _device_scalar(ksize * ksize, box)


def _abf_taps_math(src: torch.Tensor, taps, lut: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version driven by the kernel's own tables: ``taps`` an (n, 4)
    int32 tap table (core.luts.tap_table), ``lut`` the (1536,) f32 range
    table on src's device.  src: (H, W, 3) u8 → (H, W, 3) u8."""
    h, w, _ = src.shape
    ksize = 2 * radius + 1
    tab = np.asarray(torch.as_tensor(taps).cpu(), dtype=np.int32)
    weights = np.ascontiguousarray(tab[:, 2]).view(np.float32)
    src_i = src.to(torch.int32)
    src_f = src.to(torch.float32)
    box = window_sums(src_i, radius).to(torch.float32)  # exact: ≤ 255·k² < 2²⁴
    offset = src_f - box_mean(box, ksize)
    src_p_i = replicate_pad(src_i, radius, radius, radius, radius)
    src_p_f = src_p_i.to(torch.float32)

    sums = torch.zeros((h, w, 3), dtype=torch.float32, device=src.device)
    sumk = torch.zeros((h, w), dtype=torch.float32, device=src.device)
    for (dy, dx), ws in zip(tab[:, :2].tolist(), weights.tolist()):
        sp_i = src_p_i[dy : dy + h, dx : dx + w]
        a = ((sp_i - src_i).to(torch.float32) - offset).abs()  # Δ exact, |Δ| ≤ 255
        dist = (a[:, :, 0] + a[:, :, 1]) + a[:, :, 2]  # the C++ order; ≤ 1530
        wk = lut[dist.to(torch.int64)] * ws  # truncation, dist ≥ 0
        sums = sums + src_p_f[dy : dy + h, dx : dx + w] * wk[:, :, None]
        sumk = sumk + wk
    out = torch.floor(sums / sumk[:, :, None] + 0.5)
    return torch.where(sumk[:, :, None] == 0, 0.0, out).to(torch.uint8)


def _abf_math(src: torch.Tensor, ksize: int, sigma_space: float,
              sigma_color: float) -> torch.Tensor:
    """src: (H, W, 3) u8 → (H, W, 3) u8, on src's device."""
    taps = tap_table(space_kernel(ksize, sigma_space))
    lut = torch.from_numpy(color_table(sigma_color, COLOR_TABLE_SIZE_ADAPTIVE)).to(src.device)
    return _abf_taps_math(src, taps, lut, ksize // 2)


def adaptive_bilateral_filter(src, ksize: int = 9, sigma_space: float = 10.0,
                              sigma_color: float = 30.0, impl: str = "auto",
                              device="cuda") -> torch.Tensor:
    """(H, W, 3) u8 → (H, W, 3) u8.

    A tensor is filtered on its own device; any other array is first copied
    to ``device`` (the GPU unless the caller passes ``device="cpu"``).  The
    call is the span ``ops.adaptive_bilateral_filter``."""
    s = SPANS.open("ops.adaptive_bilateral_filter") if SPANS.on else -1
    try:
        v = SPANS.open("ops.validate") if SPANS.on else -1
        src = _validate.as_tensor(src, device)
        _validate.check_u8_color("src", src)
        _validate.check_ksize(ksize)
        ksize, sigma_space, sigma_color = int(ksize), float(sigma_space), float(sigma_color)
        impl = resolve_impl(impl, src)
        if v >= 0:
            SPANS.close(v)
        if impl == "cuda":
            t = SPANS.open("ops.tables") if SPANS.on else -1
            taps, lut = cuda_abf.device_tables(ksize, sigma_space, sigma_color, src.device)
            if t >= 0:
                SPANS.close(t)
            return cuda_abf.adaptive_bilateral_taps(src.contiguous(), taps, lut, ksize // 2)
        return _abf_math(src, ksize, sigma_space, sigma_color)
    finally:
        if s >= 0:
            SPANS.close(s)
