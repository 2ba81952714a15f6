"""Wrappers of the Hopper bilateral-texture-filter stage kernels
(csrc/bilateral_texture.cu): blur + mRTV, and the guide; and of the whole
filter, every kernel of its iterations enqueued by one C call
(csrc/btf_pipeline.cu).

Each takes CUDA tensors in the layouts the kernels read, allocates the
outputs and launches on PyTorch's current stream.  Every odd window is
taken: where a halo tile does not fit in one block's shared memory, the
kernel streams it through in bands.  Anything the kernels do not take
raises; a launch the runtime refuses raises.
``blur_rtv_launches`` and ``guide_launches`` count successful launches, so a
run can show its main path went through the kernels; a call is the span
``cuda_wrappers.<kernel>`` around ``enqueue.<kernel>``, kernel ``blur_rtv``
or ``guide``.  ``texture_filter`` is the span ``cuda_wrappers.btf`` around
``enqueue.btf``; it raises each launch counter of the kernels it enqueued
(``gradient.launches``, ``bilateral.launches``, and ``blocked_calls`` or
``unrolled_calls`` where the joint filter takes that path),
and ``single_calls`` by one.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...core.luts import COLOR_TABLE_SIZE_BILATERAL
from ...utils.profiling import SPANS
from . import _build
from . import bilateral as cuda_bilateral
from . import gradient as cuda_gradient
from ._build import (check_color_image, check_smem, check_table, check_taps, check_tensor,
                     kernel_wrapper, launch, launch_error, plan, stream_of)

blur_rtv_launches = 0
guide_launches = 0
single_calls = 0  # texture_filter's C calls; not named *launches: the benchmark counts those

# an iteration's kernels in the order vip_btf_u8 launches them
KERNELS = ("gradient", "blur_rtv", "guide", "bilateral")
# the workspace's regions start on 256-byte boundaries, so every kernel
# takes the same vector and word paths as on tensors of their own
ALIGN = 256

# include/cpp/bilateral_texture_filter.hpp:15, as an f32 value made on the host
EPSILON = np.float32(1e-9)


def sigma_alpha(ksize: int) -> np.float32:
    """f32(1) / f32(5 k), as the reference computes it in f32."""
    return np.float32(1.0) / np.float32(5 * ksize)


def _check_pair(image: torch.Tensor, plane: torch.Tensor, ksize: int) -> None:
    if image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got shape {tuple(image.shape)}")
    if tuple(plane.shape) != tuple(image.shape[:2]) or plane.device != image.device:
        raise ValueError(f"(H, W) plane {tuple(plane.shape)} on {plane.device} must match "
                         f"the image {tuple(image.shape)} on {image.device}")
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"ksize must be a positive odd integer, got {ksize}")


@kernel_wrapper("blur_rtv", "blur_rtv_launches")
def blur_and_rtv(img: torch.Tensor, magnitude: torch.Tensor, ksize: int):
    """(H, W, 3) u8 image + (H, W) f32 magnitude →
    ((H, W, 3) f32 blurred, (H, W) f32 rtv)."""
    check_tensor("img", img, (torch.uint8,), (3,))
    check_tensor("magnitude", magnitude, (torch.float32,), (2,))
    _check_pair(img, magnitude, ksize)
    check_smem("blur_rtv", ksize, plan("vip_blur_rtv_smem_bytes", ksize // 2))
    height, width, _ = img.shape
    blurred = torch.empty((height, width, 3), dtype=torch.float32, device=img.device)
    rtv = torch.empty((height, width), dtype=torch.float32, device=img.device)
    launch("vip_blur_rtv", "blur_rtv", img, img.data_ptr(), magnitude.data_ptr(),
           blurred.data_ptr(), rtv.data_ptr(), height, width, ksize, float(EPSILON))
    return blurred, rtv


@kernel_wrapper("guide", "guide_launches")
def guide(blurred: torch.Tensor, rtv: torch.Tensor, ksize: int) -> torch.Tensor:
    """((H, W, 3) f32 blurred, (H, W) f32 rtv) → (H, W, 3) u8 guide."""
    check_tensor("blurred", blurred, (torch.float32,), (3,))
    check_tensor("rtv", rtv, (torch.float32,), (2,))
    _check_pair(blurred, rtv, ksize)
    check_smem("guide", ksize, plan("vip_guide_smem_bytes", ksize // 2))
    height, width, _ = blurred.shape
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=blurred.device)
    launch("vip_guide", "guide", blurred, blurred.data_ptr(), rtv.data_ptr(), out.data_ptr(),
           height, width, ksize, float(sigma_alpha(ksize)))
    return out


@functools.lru_cache(maxsize=256)
def workspace_layout(height: int, width: int) -> tuple[tuple[int, ...], int]:
    """The byte offsets of the magnitude (f32 H·W), blurred (f32 H·W·3),
    rtv (f32 H·W), guide (u8 H·W·3) and image (u8 H·W·3) regions of one
    ``texture_filter`` call's workspace, each a multiple of ALIGN, and the
    workspace's size: the end of the last region."""
    pixels = height * width
    offsets, end = [], 0
    for size in (4 * pixels, 12 * pixels, 4 * pixels, 3 * pixels, 3 * pixels):
        offsets.append(-(-end // ALIGN) * ALIGN)
        end = offsets[-1] + size
    return tuple(offsets), end


@functools.lru_cache(maxsize=256)
def _texture_plan(ksize: int, height: int) -> tuple[int, float]:
    """(the bilateral kernel's path for the joint filter, the guide's
    sigma_alpha) of a BTF of window ``ksize`` at this frame height, once the
    blur, guide and joint filter plans are checked to fit in shared
    memory."""
    check_smem("blur_rtv", ksize, plan("vip_blur_rtv_smem_bytes", ksize // 2))
    check_smem("guide", ksize, plan("vip_guide_smem_bytes", ksize // 2))
    smem, path = cuda_bilateral._launch_plan(ksize - 1, True, height)
    check_smem("bilateral", 2 * ksize - 1, smem)
    return path, float(sigma_alpha(ksize))


@kernel_wrapper("btf", None)
def texture_filter(src: torch.Tensor, ksize: int, nitr: int, taps: torch.Tensor,
                   lut: torch.Tensor, border: str = "replicate",
                   rounding: str = "trunc") -> torch.Tensor:
    """``nitr`` >= 1 iterations of the bilateral texture filter of window
    ``ksize`` on an (H, W, 3) u8 image → (H, W, 3) u8: the four kernels of
    each iteration as ``ops.bilateral_texture.btf_iteration`` launches them,
    all enqueued by one call of ``vip_btf_u8``.  ``taps`` and ``lut`` are the
    closing joint filter's (``ops.bilateral_texture.jbf_tables``)."""
    check_color_image("src", src)
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"ksize must be a positive odd integer, got {ksize}")
    if nitr < 1:
        raise ValueError(f"nitr must be >= 1, got {nitr}")
    check_taps(taps, src.device)
    check_table("lut", lut, torch.float32, (COLOR_TABLE_SIZE_BILATERAL,), src.device)
    if border not in cuda_bilateral.BORDERS or rounding not in cuda_bilateral.ROUNDINGS:
        raise ValueError(f"border must be one of {tuple(cuda_bilateral.BORDERS)} and rounding "
                         f"one of {tuple(cuda_bilateral.ROUNDINGS)}, got {border!r}, "
                         f"{rounding!r}")
    height, width, _ = src.shape
    path, alpha = _texture_plan(ksize, height)
    (mag, blur, rtv, gd, img), size = workspace_layout(height, width)
    out = torch.empty_like(src)
    workspace = torch.empty(size, dtype=torch.uint8, device=src.device)
    base = workspace.data_ptr()
    args = (src.data_ptr(), out.data_ptr(), base + mag, base + blur, base + rtv, base + gd,
            base + img, height, width, ksize, nitr, taps.data_ptr(), taps.shape[0],
            lut.data_ptr(), cuda_bilateral.BORDERS[border], cuda_bilateral.ROUNDINGS[rounding],
            float(EPSILON), alpha, stream_of(src), ctypes.c_int())
    with torch.cuda.device(src.device):
        _enqueue_texture_filter(args, path)
    return out


def _enqueue_texture_filter(args: tuple, path: int) -> None:
    """``vip_btf_u8(*args)``, the span ``enqueue.btf``; ``args[-1]`` is the
    ctypes int it writes the count of kernels enqueued to.  The launch
    counters rise by the kernels that went in, and the counter of the joint
    filter's ``path`` by its launches; a failed launch raises, naming its
    kernel."""
    global single_calls, blur_rtv_launches, guide_launches
    s = SPANS.open("enqueue.btf") if SPANS.on else -1
    try:
        err = _build.load_library().vip_btf_u8(*args)
    finally:
        if s >= 0:
            SPANS.close(s)
    n = args[-1].value
    single_calls += 1
    cuda_gradient.launches += (n + 3) // 4
    blur_rtv_launches += (n + 2) // 4
    guide_launches += (n + 1) // 4
    cuda_bilateral.launches += n // 4
    cuda_bilateral.count_path(path, n // 4)
    if err != 0:
        raise launch_error(KERNELS[n % 4], err)
