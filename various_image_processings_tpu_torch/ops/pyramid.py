"""Gaussian pyramid ops (pyrDown / pyrUp).

PyTorch counterpart of ``various_image_processings_tpu/ops/pyramid.py``: the
cv::pyrDown / cv::pyrUp calls of the reference's inpainting pyramid
(include/cpp/wexler_inpainting.hpp:68-91, :52-57), plain torch on the
tensor's own device.

The u8 path is a bit-exact twin of OpenCV's fixed-point u8 pyramid:

- ``pyr_down``: integer 5-tap binomial [1 4 6 4 1] in both axes at the even
  sample grid, BORDER_REFLECT_101 on the source indices, descale
  ``(acc + 128) >> 8``.  Every intermediate is ≤ 255·256, exact in int32.
- ``pyr_up``: zero-stuffed filtering by the same taps with the reflection in
  the upsampled (2H, 2W) index domain, cropped to the requested size,
  descale ``(acc + 32) >> 6``.  In source rows: row −1 → row 1 and row H →
  row H−1 (not reflect-101's H−2).

Float inputs take a separable f32 path with the same taps.
"""

from __future__ import annotations

import torch

from ..core.pad import reflect101_indices

_K5 = (0.0625, 0.25, 0.375, 0.25, 0.0625)  # [1 4 6 4 1] / 16, exact in f32
_K5I = (1, 4, 6, 4, 1)


def _reflect101(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    idx = reflect101_indices(x.shape[axis], r, r)
    return torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))


def _sep_blur(img_f: torch.Tensor, kernel) -> torch.Tensor:
    """(H, W, C) f32 separable blur with BORDER_REFLECT_101."""
    r = (len(kernel) - 1) // 2
    h, w = img_f.shape[:2]
    p = _reflect101(img_f, 0, r)
    out = torch.zeros_like(img_f)
    for i, kv in enumerate(kernel):
        out = out + kv * p[i : i + h]
    p = _reflect101(out, 1, r)
    out = torch.zeros_like(img_f)
    for i, kv in enumerate(kernel):
        out = out + kv * p[:, i : i + w]
    return out


def _pyr_down_f(img_f: torch.Tensor) -> torch.Tensor:
    return _sep_blur(img_f, _K5)[::2, ::2]


def _pyr_up_f(img_f: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    h, w, c = img_f.shape
    up = torch.zeros((2 * h, 2 * w, c), dtype=img_f.dtype, device=img_f.device)
    up[::2, ::2] = img_f
    up = _sep_blur(up, tuple(2.0 * k for k in _K5))
    # odd-larger dst: the same duplicated trailing lines as the u8 path
    up = torch.cat([up, up[2 * h - 2 : 2 * h - 1]], 0) if out_h == 2 * h + 1 else up[:out_h]
    return torch.cat([up, up[:, 2 * w - 1 : 2 * w]], 1) if out_w == 2 * w + 1 else up[:, :out_w]


def _pyr_down_u8(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) u8 → ((H+1)//2, (W+1)//2, C) u8, bit-exact cv::pyrDown
    (H, W ≥ 3)."""
    h, w, _ = img.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    s = img.to(torch.int32).permute(2, 0, 1)  # (C, H, W)
    s = _reflect101(_reflect101(s, 1, 2), 2, 2)
    vert = sum(kv * s[:, i : i + 2 * oh - 1 : 2] for i, kv in enumerate(_K5I))
    acc = sum(kv * vert[:, :, j : j + 2 * ow - 1 : 2] for j, kv in enumerate(_K5I))
    return ((acc + 128) >> 8).to(torch.uint8).permute(1, 2, 0).contiguous()


def _up_axis(s: torch.Tensor, axis: int, n: int, out_n: int) -> torch.Tensor:
    """One pyrUp axis of a (C, H, W) int32 tensor: n → out_n ≤ 2n+1.

    even rows 2t  = s[t−1] + 6·s[t] + s[t+1]   (t−1 → |t−1|, t = n → n−1)
    odd rows 2t+1 = 4·(s[t] + s[t+1])

    cv::pyrUp also allows the odd-larger size 2n+1; its extra trailing line
    duplicates line 2n−2 on the first (vertical) axis but line 2n−1 on the
    second (horizontal) one, an asymmetry of OpenCV's row-then-column
    implementation."""
    top = s.narrow(axis, min(1, n - 1), 1)
    ext = torch.cat([top, s, s.narrow(axis, n - 1, 1)], axis)  # ext[u+1] = s[reflected u]
    even = ext.narrow(axis, 0, n) + 6 * ext.narrow(axis, 1, n) + ext.narrow(axis, 2, n)
    odd = 4 * (ext.narrow(axis, 1, n) + ext.narrow(axis, 2, n))
    shape = list(even.shape)
    shape[axis] = 2 * n
    inter = torch.stack([even, odd], axis + 1).reshape(shape)
    if out_n == 2 * n + 1:
        dup = 2 * n - 2 if axis == 1 else 2 * n - 1
        return torch.cat([inter, inter.narrow(axis, dup, 1)], axis)
    return inter.narrow(axis, 0, out_n)


def _pyr_up_u8(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, C) u8 → (out_h, out_w, C) u8, bit-exact cv::pyrUp(dstsize)."""
    h, w, _ = img.shape
    s = img.to(torch.int32).permute(2, 0, 1)
    acc = _up_axis(_up_axis(s, 1, h, out_h), 2, w, out_w)
    return ((acc + 32) >> 6).to(torch.uint8).permute(1, 2, 0).contiguous()


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """(H, W[, C]) u8|f32 → (ceil(H/2), ceil(W/2)[, C]), same dtype, on the
    tensor's device.  cv::pyrDown's default size; u8 is bit-exact to
    OpenCV's fixed-point path."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    if img.dtype == torch.uint8 and min(img.shape[:2]) >= 3:
        out = _pyr_down_u8(img)
    else:
        out = _pyr_down_f(img.to(torch.float32))
        if img.dtype == torch.uint8:
            out = torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)
        else:
            out = out.to(img.dtype)
    return out[:, :, 0] if squeeze else out


def pyr_up(img: torch.Tensor, out_shape=None) -> torch.Tensor:
    """(H, W[, C]) → (2H, 2W[, C]) or ``out_shape``, cv::pyrUp semantics; u8
    is bit-exact to OpenCV's fixed-point path, odd destination sizes
    included."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, _ = img.shape
    out_h, out_w = out_shape if out_shape is not None else (2 * h, 2 * w)
    if out_h > 2 * h + 1 or out_w > 2 * w + 1:
        raise ValueError(
            f"pyr_up dst ({out_h}, {out_w}) exceeds (2H+1, 2W+1) for "
            f"source ({h}, {w}) — beyond cv::pyrUp's legal range")
    if img.dtype == torch.uint8:
        out = _pyr_up_u8(img, out_h, out_w)
    else:
        out = _pyr_up_f(img.to(torch.float32), out_h, out_w).to(img.dtype)
    return out[:, :, 0] if squeeze else out
