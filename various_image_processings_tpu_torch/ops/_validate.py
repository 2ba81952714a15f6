"""Input validation for the public op wrappers.

Same exception types and messages as
``various_image_processings_tpu/ops/_validate.py``: the reference takes
``cv::Mat3b`` (u8 BGR) everywhere and invokes UB on malformed parameters;
the ops raise instead.
"""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(img, device) -> torch.Tensor:
    """A tensor stays on its own device; anything else is copied to
    ``device`` (negative-stride NumPy views included)."""
    if isinstance(img, torch.Tensor):
        return img
    return torch.from_numpy(np.ascontiguousarray(img)).to(device)


def check_u8_color(name: str, img: torch.Tensor) -> None:
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(
            f"{name} must be an (H, W, 3) color image, got shape {tuple(img.shape)}")
    if img.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8 (u8 BGR), got {img.dtype}")


def check_ksize(ksize: int) -> None:
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"ksize must be a positive odd integer, got {ksize}")
