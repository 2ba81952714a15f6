"""Wrapper of the Hopper bilateral kernel (csrc/bilateral.cu).

Takes (H, W, 3) u8 CUDA tensors and the filter's tables (core.luts.tap_table
and the 768-entry range LUT) on the same device, allocates the output and
launches on PyTorch's current stream.  Every radius is taken: from k = 3
to k = 9 the circle is unrolled at compile time and a thread computes 2 x 4
adjacent output pixels, 1 x 4 on small frames (the unrolled path); from
k = 11 to k = 63 on frames more than 16 rows high a thread computes 4
adjacent output pixels (the blocked path); elsewhere 4 pixels 32 apart, or
where that halo tile does not fit in one block's shared memory, 1 pixel a
thread and, where that tile does not fit either, it streams the tile
through in bands.  Anything the
kernel does not take raises; a launch the runtime refuses raises.
``launches`` counts successful launches, so a run can show its main path
went through the kernel, ``unrolled_calls`` and ``blocked_calls`` those of
them that took the unrolled and the blocked path; a call is the span
``cuda_wrappers.bilateral`` around ``enqueue.bilateral``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.luts import COLOR_TABLE_SIZE_BILATERAL, color_table, space_kernel, tap_table
from ._build import (check_color_image, check_smem, check_table, check_taps, kernel_wrapper,
                     launch, plan)

launches = 0
# not named *launches: the benchmark counts those as launches
blocked_calls = 0
unrolled_calls = 0

# the kernel's paths (vip_bilateral_path): four adjacent columns a thread,
# four pixels 32 apart, one pixel a thread, the unrolled circle
BLOCKED, FOUR_PIXELS, ONE_PIXEL, UNROLLED = 1, 2, 3, 4
UNROLLED_MAX_RADIUS = 4  # the unrolled path takes radius 1 to 4, k = 3 to 9

BORDERS = {"replicate": 0, "reflect101": 1}
ROUNDINGS = {"trunc": 0, "rint": 1}


@functools.lru_cache(maxsize=256)
def _launch_plan(radius: int, joint: bool, height: int) -> tuple[int, int]:
    """(shared memory of a block in bytes, the path) of a launch at this
    radius and frame height."""
    return (plan("vip_bilateral_smem_bytes", radius, int(joint), height),
            plan("vip_bilateral_path", radius, int(joint), height))


def count_path(path: int, n: int = 1) -> None:
    """Raise the counter of ``path`` by the ``n`` launches that took it."""
    global blocked_calls, unrolled_calls
    if path == BLOCKED:
        blocked_calls += n
    elif path == UNROLLED:
        unrolled_calls += n


@kernel_wrapper("bilateral")
def joint_bilateral(src: torch.Tensor, guide, taps: torch.Tensor,
                    lut: torch.Tensor, radius: int, border: str = "replicate",
                    rounding: str = "trunc") -> torch.Tensor:
    """Launch the kernel.  guide=None is the self filter (range weights keyed
    off src).  The taps must be in (ky, kx) order, each (dy, dx) once, as
    core.luts.tap_table gives them; at radius 1 to 4 every tap must lie in
    the window's inscribed circle, (dy - r)² + (dx - r)² <= r², as
    core.luts.space_kernel keeps them: the unrolled path adds the circle's
    taps and no other."""
    check_color_image("src", src)
    if guide is not None:
        check_color_image("guide", guide)
        if guide.shape != src.shape or guide.device != src.device:
            raise ValueError(f"guide {tuple(guide.shape)} on {guide.device} must match "
                             f"src {tuple(src.shape)} on {src.device}")
    check_taps(taps, src.device)
    check_table("lut", lut, torch.float32, (COLOR_TABLE_SIZE_BILATERAL,), src.device)
    if border not in BORDERS or rounding not in ROUNDINGS:
        raise ValueError(f"border must be one of {tuple(BORDERS)} and rounding one of "
                         f"{tuple(ROUNDINGS)}, got {border!r}, {rounding!r}")
    height, width, _ = src.shape
    smem, path = _launch_plan(radius, guide is not None, height)
    check_smem("bilateral", 2 * radius + 1, smem)
    out = torch.empty_like(src)
    launch("vip_bilateral_u8", "bilateral", src, src.data_ptr(),
           None if guide is None else guide.data_ptr(), out.data_ptr(), height, width,
           taps.data_ptr(), taps.shape[0], lut.data_ptr(), radius, BORDERS[border],
           ROUNDINGS[rounding])
    count_path(path)
    return out


def check_circle(space: np.ndarray) -> None:
    """A (k, k) space kernel the kernel takes: at k = 3 to 9 zero outside
    the inscribed circle, as core.luts.space_kernel makes it, since the
    unrolled path adds the circle's taps and no other."""
    r = space.shape[0] // 2
    ky, kx = np.mgrid[-r:r + 1, -r:r + 1]
    if 1 <= r <= UNROLLED_MAX_RADIUS and np.any(space[ky * ky + kx * kx > r * r] != 0):
        raise ValueError(f"a ({2 * r + 1}, {2 * r + 1}) space_kernel must be 0 outside its "
                         "inscribed circle (kx² + ky² > r²), as core.luts.space_kernel makes it")


@functools.lru_cache(maxsize=64)
def device_tables(ksize: int, sigma_space: float, sigma_color: float,
                  device: torch.device):
    """(taps, lut) for one parameter set, built on the host once and kept on
    the device."""
    taps = torch.from_numpy(tap_table(space_kernel(ksize, sigma_space))).to(device)
    lut = torch.from_numpy(color_table(sigma_color)).to(device)
    return taps, lut


def bilateral(src: torch.Tensor, guide, ksize: int, sigma_space: float,
              sigma_color: float, border: str = "replicate",
              rounding: str = "trunc") -> torch.Tensor:
    taps, lut = device_tables(ksize, sigma_space, sigma_color, src.device)
    return joint_bilateral(src, guide, taps, lut, ksize // 2, border, rounding)
