"""Bilateral and joint bilateral filters.

PyTorch counterpart of ``various_image_processings_tpu/ops/bilateral.py``
(reference: include/cpp/bilateral_filter.hpp:41-207, the CUDA kernels in
src/bilateral_filter_impl.cu:7-202).  Per output pixel:

- spatial Gaussian zeroed outside the inscribed circle (zero-weight taps
  are skipped — they add exactly 0);
- range weight gathered from the 768-entry f32 LUT at the L1 u8 color
  distance of the guide, ``wk = ws * lut[d]``, as the reference does;
- f32 sums in (ky, kx) tap order, every product and sum rounded on its own;
- ``sums / sumk`` as a true division, stored as ``u8(floor(x + 0.5))`` or,
  for cv::ximgproc's variant, ``rint``.

With the LUT gather instead of the TPU kernels' ``exp`` recompute, both the
plain version (``impl="torch"``) and the CUDA kernel (``impl="cuda"``,
csrc/bilateral.cu) are bit-exact to the golden layer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.luts import color_table, space_kernel, tap_table
from ..core.pad import reflect101_pad, replicate_pad
from . import _validate
from ._dispatch import resolve_impl
from .cuda import bilateral as cuda_bilateral


def nonzero_taps(ksize: int, sigma_space: float):
    """[(dy, dx, weight_f32)] for taps inside the inscribed circle, in the
    reference's (ky, kx) scan order."""
    table = tap_table(space_kernel(ksize, sigma_space))
    weights = np.ascontiguousarray(table[:, 2]).view(np.float32)
    return [(dy, dx, w) for (dy, dx), w in zip(table[:, :2].tolist(), weights)]


def _pad2d(x: torch.Tensor, r: int, border: str) -> torch.Tensor:
    if border == "replicate":
        return replicate_pad(x, r, r, r, r)
    if border == "reflect101":
        # cv BORDER_DEFAULT, what cv::ximgproc::jointBilateralFilter uses;
        # multi-reflects like cv::borderInterpolate when r exceeds the image
        return reflect101_pad(x, r, 0, 1)
    raise ValueError(f"border must be 'replicate' or 'reflect101', got {border!r}")


def _taps_math(src: torch.Tensor, guide: torch.Tensor, taps, lut: torch.Tensor,
               radius: int, border: str = "replicate",
               rounding: str = "trunc") -> torch.Tensor:
    """Plain version driven by the kernel's own tables: ``taps`` an (n, 4)
    int32 tap table (core.luts.tap_table), ``lut`` the (768,) f32 range
    table on src's device.  src/guide: (H, W, 3) holding u8 values."""
    if rounding not in ("trunc", "rint"):
        raise ValueError(f"rounding must be 'trunc' or 'rint', got {rounding!r}")
    h, w, _ = src.shape
    tab = np.asarray(torch.as_tensor(taps).cpu(), dtype=np.int32)
    weights = np.ascontiguousarray(tab[:, 2]).view(np.float32)
    src_p = _pad2d(src.to(torch.float32), radius, border)
    guide_c = guide.to(torch.int64)
    guide_p = _pad2d(guide_c, radius, border)

    sums = torch.zeros((h, w, 3), dtype=torch.float32, device=src.device)
    sumk = torch.zeros((h, w), dtype=torch.float32, device=src.device)
    for (dy, dx), ws in zip(tab[:, :2].tolist(), weights.tolist()):
        sp = src_p[dy : dy + h, dx : dx + w]
        gp = guide_p[dy : dy + h, dx : dx + w]
        dist = (gp - guide_c).abs().sum(dim=2)  # exact int, ≤ 765
        # ws is an f32 value: the scalar product rounds once, in f32
        wk = lut[dist] * ws
        sums = sums + sp * wk[:, :, None]
        sumk = sumk + wk
    out = sums / sumk[:, :, None]
    if rounding == "rint":
        return torch.round(out).to(torch.uint8)  # half-to-even, like cvRound
    return torch.floor(out + 0.5).to(torch.uint8)


def _bilateral_math(src: torch.Tensor, guide: torch.Tensor, ksize: int,
                    sigma_space: float, sigma_color: float,
                    border: str = "replicate", rounding: str = "trunc",
                    strict: bool = False) -> torch.Tensor:
    """src/guide: (H, W, 3) tensors holding u8 values (uint8 or float32) →
    (H, W, 3) u8, on src's device.

    border/rounding select between the reference's own JBF semantics
    (replicate pad + ``u8(x + 0.5f)`` truncation) and
    cv::ximgproc::jointBilateralFilter's (reflect-101 pad + cvRound
    half-to-even), which the BTF "cpp" variant needs.

    ``strict`` is accepted for signature parity with the JAX package, where
    it keeps XLA from contracting ``sums + sp*wk`` into FMAs under jit.
    Eager PyTorch already rounds every op on its own, so it changes
    nothing here."""
    del strict
    taps = tap_table(space_kernel(ksize, sigma_space))
    lut = torch.from_numpy(color_table(sigma_color)).to(src.device)
    return _taps_math(src, guide, taps, lut, ksize // 2, border, rounding)


def _filter(src: torch.Tensor, guide, ksize: int, sigma_space: float,
            sigma_color: float, impl: str, border: str = "replicate",
            rounding: str = "trunc") -> torch.Tensor:
    """guide=None: the self filter (range weights keyed off src)."""
    if resolve_impl(impl, src) == "cuda":
        return cuda_bilateral.bilateral(
            src.contiguous(), None if guide is None else guide.contiguous(),
            ksize, sigma_space, sigma_color, border, rounding)
    return _bilateral_math(src, src if guide is None else guide, ksize,
                           sigma_space, sigma_color, border, rounding)


def bilateral_filter(src, ksize: int = 9, sigma_space: float = 10.0,
                     sigma_color: float = 30.0, impl: str = "auto",
                     device="cpu") -> torch.Tensor:
    """(H, W, 3) u8 → (H, W, 3) u8 edge-preserving smoothing.

    A tensor is filtered on its own device; any other array is first copied
    to ``device``."""
    src = _validate.as_tensor(src, device)
    _validate.check_u8_color("src", src)
    _validate.check_ksize(ksize)
    return _filter(src, None, int(ksize), float(sigma_space),
                   float(sigma_color), impl)


def joint_bilateral_filter(src, guide, ksize: int = 9, sigma_space: float = 10.0,
                           sigma_color: float = 30.0, impl: str = "auto",
                           device="cpu") -> torch.Tensor:
    """(H, W, 3) u8 src smoothed with range kernel keyed off `guide`."""
    src = _validate.as_tensor(src, device)
    guide = _validate.as_tensor(guide, device)
    _validate.check_u8_color("src", src)
    _validate.check_u8_color("guide", guide)
    if src.shape != guide.shape:
        raise ValueError(f"src {tuple(src.shape)} and guide {tuple(guide.shape)} "
                         "must have the same shape")
    if src.device != guide.device:
        raise ValueError(f"src ({src.device}) and guide ({guide.device}) "
                         "must be on the same device")
    _validate.check_ksize(ksize)
    return _filter(src, guide, int(ksize), float(sigma_space),
                   float(sigma_color), impl)
