"""Wrapper of the Hopper adaptive bilateral kernel (csrc/adaptive_bilateral.cu).

Takes an (H, W, 3) u8 CUDA tensor and the filter's tables (core.luts.tap_table
and the 1536-entry range LUT) on the same device, allocates the output and
launches on PyTorch's current stream.  Every radius is taken: where the
halo tile does not fit in one block's shared memory, the kernel streams it
through in bands.  Anything the kernel does not take raises; a launch the
runtime refuses raises.  ``launches`` counts
successful launches, so a run can show its main path went through the kernel;
a call is the span ``cuda_wrappers.adaptive_bilateral`` around
``enqueue.adaptive_bilateral``.
"""

from __future__ import annotations

import functools

import torch

from ...core.luts import COLOR_TABLE_SIZE_ADAPTIVE, color_table, space_kernel, tap_table
from ._build import (check_color_image, check_smem, check_table, check_taps, kernel_wrapper,
                     launch, plan)

launches = 0


@kernel_wrapper("adaptive_bilateral")
def adaptive_bilateral_taps(src: torch.Tensor, taps: torch.Tensor, lut: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """Launch the kernel with the filter's tables: the window is 2·radius+1.
    The taps must be in (ky, kx) order, as core.luts.tap_table gives them."""
    check_color_image("src", src)
    check_taps(taps, src.device)
    check_table("lut", lut, torch.float32, (COLOR_TABLE_SIZE_ADAPTIVE,), src.device)
    check_smem("adaptive_bilateral", 2 * radius + 1,
               plan("vip_adaptive_bilateral_smem_bytes", radius))
    height, width, _ = src.shape
    out = torch.empty_like(src)
    launch("vip_adaptive_bilateral_u8", "adaptive_bilateral", src, src.data_ptr(),
           out.data_ptr(), height, width, taps.data_ptr(), taps.shape[0], lut.data_ptr(), radius)
    return out


@functools.lru_cache(maxsize=64)
def device_tables(ksize: int, sigma_space: float, sigma_color: float,
                  device: torch.device):
    """(taps, lut) for one parameter set, built on the host once and kept on
    the device."""
    taps = torch.from_numpy(tap_table(space_kernel(ksize, sigma_space))).to(device)
    lut = torch.from_numpy(color_table(sigma_color, COLOR_TABLE_SIZE_ADAPTIVE)).to(device)
    return taps, lut


def adaptive_bilateral(src: torch.Tensor, ksize: int, sigma_space: float,
                       sigma_color: float) -> torch.Tensor:
    taps, lut = device_tables(ksize, sigma_space, sigma_color, src.device)
    return adaptive_bilateral_taps(src, taps, lut, ksize // 2)
