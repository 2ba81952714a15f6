"""Padding helpers.

Twin of ``various_image_processings_tpu/core/pad.py``.  The reference clamps
window coordinates to the image rect (``std::clamp(x + kx, 0, width - 1)``,
include/cpp/bilateral_filter.hpp:89-90), which is replicate padding;
cv::ximgproc's joint bilateral filter uses reflect-101.  Both pads here are
one index gather per axis, so any pad width works — including the
multi-reflection OpenCV's borderInterpolate does when r > n − 1.
"""

from __future__ import annotations

import numpy as np
import torch


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def reflect101_indices(n: int, lo: int, hi: int) -> np.ndarray:
    """Source-index map for cv::BORDER_REFLECT_101 padding: ``lo`` elements
    before and ``hi`` after an n-element axis, with OpenCV's multi-reflection
    semantics.  n == 1 maps everything to 0, like borderInterpolate."""
    idx = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    j = np.mod(idx, period)
    return np.where(j >= n, period - j, j)


def replicate_indices(n: int, lo: int, hi: int) -> np.ndarray:
    """Source-index map for edge (replicate) padding of an n-element axis."""
    return np.clip(np.arange(-lo, n + hi), 0, n - 1)


def _gather(x: torch.Tensor, axis: int, idx: np.ndarray) -> torch.Tensor:
    return torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))


def reflect101_pad(img: torch.Tensor, r: int, row_axis: int = 0,
                   col_axis: int = 1) -> torch.Tensor:
    """Reflect-101 pad the given two axes of a tensor by r, for any r."""
    if r == 0:
        return img
    img = _gather(img, row_axis, reflect101_indices(img.shape[row_axis], r, r))
    return _gather(img, col_axis, reflect101_indices(img.shape[col_axis], r, r))


def replicate_pad(img: torch.Tensor, pad_top: int, pad_bottom: int,
                  pad_left: int, pad_right: int, axis: int = 0) -> torch.Tensor:
    """Edge-pad two adjacent spatial dims (``axis``, ``axis+1``) of a tensor
    — axis=0 for HW[C] layouts, axis=1 for planar CHW."""
    if pad_top or pad_bottom:
        img = _gather(img, axis, replicate_indices(img.shape[axis], pad_top, pad_bottom))
    if pad_left or pad_right:
        img = _gather(img, axis + 1,
                      replicate_indices(img.shape[axis + 1], pad_left, pad_right))
    return img
