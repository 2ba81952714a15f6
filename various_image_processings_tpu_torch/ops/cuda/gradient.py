"""Wrapper of the Hopper gradient-magnitude kernel (csrc/gradient.cu).

Takes an (H, W, C) u8 or f32 CUDA tensor, allocates the (H, W) f32 output
and launches on PyTorch's current stream.  The source picks the kernel by
dtype, channel count, width and alignment (u8 rows of whole words take the
word kernel; everything else the general one), never by catching an error.
Anything the kernels do not take raises; a launch the runtime refuses
raises.  ``launches`` counts successful
launches, so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, check_tensor, load_library, stream_of

launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library()
    lib.vip_gradient.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,             # src, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,     # height, width, channels
        ctypes.c_int, ctypes.c_void_p,                # is_float, stream
    ]
    lib.vip_gradient.restype = ctypes.c_int
    return lib


def gradient(src: torch.Tensor) -> torch.Tensor:
    """(H, W, C) u8|f32 → (H, W) f32 gradient magnitude."""
    global launches
    check_tensor("src", src, (torch.uint8, torch.float32), (3,))
    height, width, channels = src.shape
    out = torch.empty((height, width), dtype=torch.float32, device=src.device)
    with torch.cuda.device(src.device):
        err = _lib().vip_gradient(src.data_ptr(), out.data_ptr(), height, width, channels,
                                  int(src.dtype == torch.float32), stream_of(src))
    check_launch(err, "gradient")
    launches += 1
    return out
