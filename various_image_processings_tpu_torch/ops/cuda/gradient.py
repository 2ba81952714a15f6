"""Wrapper of the Hopper gradient-magnitude kernel (csrc/gradient.cu).

Takes an (H, W, C) u8 or f32 CUDA tensor, allocates the (H, W) f32 output
and launches on PyTorch's current stream.  The source picks the kernel by
dtype, channel count, width and alignment (u8 rows of whole words take the
word kernel; everything else the general one), never by catching an error.
Anything the kernels do not take raises; a launch the runtime refuses
raises.  ``launches`` counts successful
launches, so a run can show its main path went through the kernel; a call
is the span ``cuda_wrappers.gradient`` around ``enqueue.gradient``.
"""

from __future__ import annotations

import torch

from ._build import check_tensor, kernel_wrapper, launch

launches = 0


@kernel_wrapper("gradient")
def gradient(src: torch.Tensor) -> torch.Tensor:
    """(H, W, C) u8|f32 → (H, W) f32 gradient magnitude."""
    check_tensor("src", src, (torch.uint8, torch.float32), (3,))
    height, width, channels = src.shape
    out = torch.empty((height, width), dtype=torch.float32, device=src.device)
    launch("vip_gradient", "gradient", src, src.data_ptr(), out.data_ptr(), height, width,
           channels, int(src.dtype == torch.float32))
    return out
