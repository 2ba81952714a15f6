"""Border-replicated integral image (summed-area table).

PyTorch counterpart of ``various_image_processings_tpu/ops/integral_image.py``
(reference: include/cpp/border_replicated_integral_image.hpp:7-85).  The two
sequential prefix passes are ``torch.cumsum``; integer sources accumulate in
int32, floating sources in float32, as the reference does (:18-23).  Plain
PyTorch on every device: the JAX package leaves these cumsums to XLA, so
there is no kernel to port.
"""

from __future__ import annotations

import torch

from ..core.pad import replicate_pad
from . import _validate


def integral_image(src, radius: int, device="cuda") -> torch.Tensor:
    """(H, W[, C]) u8|i32|f32 → (H+2r+1, W+2r+1[, C]) i32|f32 summed-area table.

    Entry [y, x] holds the inclusive sum of the replicate-padded image over
    rows < y, cols < x (row/col 0 are zero), so the window sum over padded
    coords [y0, y1] × [x0, x1] is the standard 4-corner expression.  A tensor
    stays on its device; anything else is copied to ``device``.
    """
    src = _validate.as_tensor(src, device)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[:, :, None]
    acc = torch.float32 if src.is_floating_point() else torch.int32
    padded = replicate_pad(src.to(acc), radius, radius, radius, radius)
    # dtype= keeps the int32 accumulator: torch.cumsum of int32 gives int64
    ii = torch.zeros((padded.shape[0] + 1, padded.shape[1] + 1, padded.shape[2]),
                     dtype=acc, device=src.device)
    ii[1:, 1:] = torch.cumsum(torch.cumsum(padded, dim=0, dtype=acc), dim=1, dtype=acc)
    return ii[:, :, 0] if squeeze else ii


def window_sums(src, radius: int, window_radius: int | None = None,
                device="cuda") -> torch.Tensor:
    """(H, W[, C]) → (H, W[, C]) inclusive sums of the (2r+1)² window centred
    at each pixel, borders replicate-padded.  Counterpart of the per-pixel
    ``integral.get(x-r, y-r, x+r, y+r)`` pattern
    (reference: include/cpp/adaptive_bilateral_filter.hpp:53)."""
    if window_radius is None:
        window_radius = radius
    src = _validate.as_tensor(src, device)
    h, w = src.shape[0], src.shape[1]
    ii = integral_image(src, radius)
    r, wr = radius, window_radius
    # centre pixel (y, x) → padded-coord window [y-wr, y+wr] × [x-wr, x+wr]
    lo, hi = r - wr, r + wr + 1
    return (ii[hi : hi + h, hi : hi + w] - ii[hi : hi + h, lo : lo + w]
            - ii[lo : lo + h, hi : hi + w] + ii[lo : lo + h, lo : lo + w])
