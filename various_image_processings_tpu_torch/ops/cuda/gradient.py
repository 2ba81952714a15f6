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

import ctypes
import functools

import torch

from ...utils.profiling import SPANS
from ._build import check_tensor, enqueue, load_library, stream_of

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
    w = SPANS.open("cuda_wrappers.gradient") if SPANS.on else -1
    check_tensor("src", src, (torch.uint8, torch.float32), (3,))
    height, width, channels = src.shape
    out = torch.empty((height, width), dtype=torch.float32, device=src.device)
    args = (src.data_ptr(), out.data_ptr(), height, width, channels,
            int(src.dtype == torch.float32), stream_of(src))
    with torch.cuda.device(src.device):
        enqueue("enqueue.gradient", _lib().vip_gradient, args, "gradient")
    launches += 1
    if w >= 0:
        SPANS.close(w)
    return out
