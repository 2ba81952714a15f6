"""Plain reference of the bilateral filter: the joint filter guided by the
frame itself (include/cpp/bilateral_filter.hpp:41-124)."""

import torch

from port_bench.refs import _plain


def reference(frame: torch.Tensor, ksize: int, sigma_space: float, sigma_color: float,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 3) u8 → (H, W, 3) u8, on the frame's device."""
    return _plain.joint_bilateral(frame, frame, ksize, sigma_space, sigma_color, dtype)
