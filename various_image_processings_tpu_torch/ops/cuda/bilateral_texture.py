"""Wrappers of the Hopper bilateral-texture-filter stage kernels
(csrc/bilateral_texture.cu): blur + mRTV, and the guide.

Each takes CUDA tensors in the layouts the kernels read, allocates the
outputs and launches on PyTorch's current stream.  Every odd window is
taken: where a halo tile does not fit in one block's shared memory, the
kernel streams it through in bands.  Anything the kernels do not take
raises; a launch the runtime refuses raises.
``blur_rtv_launches`` and ``guide_launches`` count successful launches, so a
run can show its main path went through the kernels; a call is the span
``cuda_wrappers.<kernel>`` around ``enqueue.<kernel>``, kernel ``blur_rtv``
or ``guide``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.profiling import SPANS
from ._build import check_smem, check_tensor, enqueue, load_library, stream_of

blur_rtv_launches = 0
guide_launches = 0

# include/cpp/bilateral_texture_filter.hpp:15, as an f32 value made on the host
EPSILON = np.float32(1e-9)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library()
    for name in ("vip_blur_rtv_smem_bytes", "vip_guide_smem_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    for name in ("vip_blur_rtv_band", "vip_guide_band"):
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    lib.vip_blur_rtv.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,             # img, magnitude
        ctypes.c_void_p, ctypes.c_void_p,             # blurred, rtv
        ctypes.c_int, ctypes.c_int, ctypes.c_int,     # height, width, ksize
        ctypes.c_float, ctypes.c_void_p,              # epsilon, stream
    ]
    lib.vip_blur_rtv.restype = ctypes.c_int
    lib.vip_guide.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # blurred, rtv, guide
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # height, width, ksize
        ctypes.c_float, ctypes.c_void_p,                     # sigma_alpha, stream
    ]
    lib.vip_guide.restype = ctypes.c_int
    return lib


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


def blur_and_rtv(img: torch.Tensor, magnitude: torch.Tensor, ksize: int):
    """(H, W, 3) u8 image + (H, W) f32 magnitude →
    ((H, W, 3) f32 blurred, (H, W) f32 rtv)."""
    global blur_rtv_launches
    w = SPANS.open("cuda_wrappers.blur_rtv") if SPANS.on else -1
    check_tensor("img", img, (torch.uint8,), (3,))
    check_tensor("magnitude", magnitude, (torch.float32,), (2,))
    _check_pair(img, magnitude, ksize)
    smem = _lib().vip_blur_rtv_smem_bytes(ksize // 2)
    check_smem("blur_rtv", ksize, smem)
    height, width, _ = img.shape
    blurred = torch.empty((height, width, 3), dtype=torch.float32, device=img.device)
    rtv = torch.empty((height, width), dtype=torch.float32, device=img.device)
    args = (img.data_ptr(), magnitude.data_ptr(), blurred.data_ptr(), rtv.data_ptr(), height,
            width, ksize, float(EPSILON), stream_of(img))
    with torch.cuda.device(img.device):
        enqueue("enqueue.blur_rtv", _lib().vip_blur_rtv, args, "blur_rtv")
    blur_rtv_launches += 1
    if w >= 0:
        SPANS.close(w)
    return blurred, rtv


def guide(blurred: torch.Tensor, rtv: torch.Tensor, ksize: int) -> torch.Tensor:
    """((H, W, 3) f32 blurred, (H, W) f32 rtv) → (H, W, 3) u8 guide."""
    global guide_launches
    w = SPANS.open("cuda_wrappers.guide") if SPANS.on else -1
    check_tensor("blurred", blurred, (torch.float32,), (3,))
    check_tensor("rtv", rtv, (torch.float32,), (2,))
    _check_pair(blurred, rtv, ksize)
    smem = _lib().vip_guide_smem_bytes(ksize // 2)
    check_smem("guide", ksize, smem)
    height, width, _ = blurred.shape
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=blurred.device)
    args = (blurred.data_ptr(), rtv.data_ptr(), out.data_ptr(), height, width, ksize,
            float(sigma_alpha(ksize)), stream_of(blurred))
    with torch.cuda.device(blurred.device):
        enqueue("enqueue.guide", _lib().vip_guide, args, "guide")
    guide_launches += 1
    if w >= 0:
        SPANS.close(w)
    return out
