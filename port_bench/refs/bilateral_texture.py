"""Plain reference of the bilateral texture filter (Cho et al. 2014), the
reference's CUDA pipeline (src/bilateral_texture_filter_impl.cu:199-214):
each iteration the gradient magnitude, box blur and mRTV, the guide, then the
joint bilateral filter of window 2k − 1, σs = k − 1, σc = √3 (float32)."""

import numpy as np
import torch

from port_bench.refs import _plain

JBF_SIGMA_COLOR = float(np.sqrt(np.float32(3.0)))


def reference(frame: torch.Tensor, ksize: int, nitr: int, variant: str = "cuda",
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 3) u8 → (H, W, 3) u8, on the frame's device."""
    if variant != "cuda":
        raise ValueError(f"the reference follows the 'cuda' variant only, got {variant!r}")
    img = frame
    for _ in range(nitr):
        magnitude = _plain.gradient(img, dtype)
        blurred, rtv = _plain.blur_and_rtv(img, magnitude, ksize, dtype)
        guide = _plain.guide(blurred, rtv, ksize, dtype)
        img = _plain.joint_bilateral(img, guide, 2 * ksize - 1, float(ksize - 1),
                                     JBF_SIGMA_COLOR, dtype)
    return img.clone() if img is frame else img
