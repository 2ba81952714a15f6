"""Wrapper of the Hopper bilateral kernel (csrc/bilateral.cu).

Takes (H, W, 3) u8 CUDA tensors and the filter's tables (core.luts.tap_table
and the 768-entry range LUT) on the same device, allocates the output and
launches on PyTorch's current stream.  Anything the kernel does not take
raises; a launch the runtime refuses raises.  ``launches`` counts successful
launches, so a run can show its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.luts import COLOR_TABLE_SIZE_BILATERAL, color_table, space_kernel, tap_table
from ._build import load_library

launches = 0

BORDERS = {"replicate": 0, "reflect101": 1}
ROUNDINGS = {"trunc": 0, "rint": 1}
# shared memory one block can use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library()
    lib.vip_bilateral_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.vip_bilateral_smem_bytes.restype = ctypes.c_longlong
    lib.vip_bilateral_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # src, guide, out
        ctypes.c_int, ctypes.c_int,                          # height, width
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,      # taps, n_taps, lut
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # radius, border, rounding
        ctypes.c_longlong, ctypes.c_void_p,                  # smem bytes, stream
    ]
    lib.vip_bilateral_u8.restype = ctypes.c_int
    lib.vip_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vip_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_image(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8 (u8 BGR), got {t.dtype}")
    if t.ndim != 3 or t.shape[2] != 3:
        raise ValueError(f"{name} must be an (H, W, 3) color image, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_table(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def joint_bilateral(src: torch.Tensor, guide, taps: torch.Tensor,
                    lut: torch.Tensor, radius: int, border: str = "replicate",
                    rounding: str = "trunc") -> torch.Tensor:
    """Launch the kernel.  guide=None is the self filter (range weights keyed
    off src, one tile in shared memory instead of two)."""
    global launches
    _check_image("src", src)
    if guide is not None:
        _check_image("guide", guide)
        if guide.shape != src.shape or guide.device != src.device:
            raise ValueError(f"guide {tuple(guide.shape)} on {guide.device} must match "
                             f"src {tuple(src.shape)} on {src.device}")
    if taps.ndim != 2 or taps.shape[0] < 1:
        raise ValueError(f"taps must be an (n, 4) tap table, got shape {tuple(taps.shape)}")
    _check_table("taps", taps, torch.int32, (taps.shape[0], 4), src.device)
    if taps.data_ptr() % 16 != 0:
        raise ValueError("taps must be 16-byte aligned (the kernel reads one int4 per tap)")
    _check_table("lut", lut, torch.float32, (COLOR_TABLE_SIZE_BILATERAL,), src.device)
    if border not in BORDERS or rounding not in ROUNDINGS:
        raise ValueError(f"border must be one of {tuple(BORDERS)} and rounding one of "
                         f"{tuple(ROUNDINGS)}, got {border!r}, {rounding!r}")
    smem = _lib().vip_bilateral_smem_bytes(radius, int(guide is not None))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ksize {2 * radius + 1}: the kernel's halo tile needs {smem} bytes "
                         f"of shared memory, above the {MAX_SMEM_BYTES} a block can use")
    height, width, _ = src.shape
    out = torch.empty_like(src)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _lib().vip_bilateral_u8(
            src.data_ptr(), None if guide is None else guide.data_ptr(), out.data_ptr(),
            height, width, taps.data_ptr(), taps.shape[0], lut.data_ptr(),
            radius, BORDERS[border], ROUNDINGS[rounding], smem, stream)
    if err != 0:
        msg = _lib().vip_cuda_error_string(err).decode()
        raise RuntimeError(f"bilateral kernel launch failed: {msg} (cudaError_t {err})")
    launches += 1
    return out


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
