"""Class-style filter API.

Counterpart of ``various_image_processings_tpu/models/filters.py`` and the
reference's ``CudaBilateralFilter`` (include/cuda/bilateral_filter.hpp:7-31),
``CudaAdaptiveBilateralFilter`` (include/cuda/adaptive_bilateral_filter.hpp:7-26)
and ``CudaBilateralTextureFilter``
(include/cuda/bilateral_texture_filter.hpp:7-19): the constructor fixes the
image size and parameters and builds the tables once, on ``device`` (the GPU
unless the caller passes ``device="cpu"``); calls then run without per-call
setup; ``warmup()`` makes the first call ahead of time.  The tap table and
range LUT are registered buffers, so ``.to(device)`` moves them with the
module.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.luts import (COLOR_TABLE_SIZE_ADAPTIVE, COLOR_TABLE_SIZE_BILATERAL, color_table,
                         pre_compute_kernels, space_kernel, tap_table)
from ..ops import _validate
from ..ops._dispatch import check_impl, resolve_impl
from ..ops.adaptive_bilateral import _abf_taps_math
from ..ops.bilateral import _taps_math
from ..ops.bilateral_texture import _btf, check_nitr, jbf_numpy_tables
from ..ops.cuda import adaptive_bilateral as cuda_abf
from ..ops.cuda import bilateral as cuda_bilateral


def _check_tables(space_kernel: np.ndarray, color_table: np.ndarray,
                  table_size: int = COLOR_TABLE_SIZE_BILATERAL):
    """Host-built tables as the module stores them: the (k, k) f32 space
    kernel and the (table_size,) f32 range table."""
    space = np.asarray(space_kernel, np.float32)
    table = np.asarray(color_table, np.float32)
    if space.ndim != 2 or space.shape[0] != space.shape[1]:
        raise ValueError(f"space_kernel must be square, got shape {space.shape}")
    if table.shape != (table_size,):
        raise ValueError(f"color_table must have shape ({table_size},), got {table.shape}")
    return space, table


class _TableFilter(nn.Module):
    """A shape-specialized filter whose state is a space kernel's tap table
    (``taps``, core.luts.tap_table) and a range table of ``table_size``
    entries (``lut``)."""

    table_size = COLOR_TABLE_SIZE_BILATERAL

    def __init__(self, height: int, width: int, impl: str, device,
                 space: np.ndarray, table: np.ndarray):
        super().__init__()
        check_impl(impl)
        device = _validate.check_device(device)
        self.height = int(height)
        self.width = int(width)
        self.impl = impl
        self.register_buffer("taps", torch.empty((0, 4), dtype=torch.int32, device=device))
        self.register_buffer("lut", torch.empty(0, dtype=torch.float32, device=device))
        self._set_tables(space, table)

    def _set_tables(self, space: np.ndarray, table: np.ndarray) -> None:
        space, table = _check_tables(space, table, self.table_size)
        self.taps = torch.from_numpy(tap_table(space)).to(self.taps.device)
        self.lut = torch.from_numpy(table.copy()).to(self.lut.device)

    def _check(self, img) -> torch.Tensor:
        img = _validate.as_tensor(img, self.lut.device)
        if tuple(img.shape) != (self.height, self.width, 3) or img.dtype != torch.uint8:
            raise ValueError(
                f"expected ({self.height}, {self.width}, 3) u8, got "
                f"{tuple(img.shape)} {img.dtype}")
        if img.device != self.lut.device:
            raise ValueError(f"input on {img.device}, filter on {self.lut.device}")
        return img.contiguous()

    def warmup(self):
        """One call on a zeros image of the module's shape, then a
        synchronize: on the card this builds the kernels ahead of the first
        real call.  Returns ``self``."""
        self(torch.zeros((self.height, self.width, 3), dtype=torch.uint8,
                         device=self.lut.device))
        if self.lut.is_cuda:
            torch.cuda.synchronize(self.lut.device)
        return self


class BilateralFilter(_TableFilter):
    """Bilateral / joint bilateral filter for (height, width, 3) u8 images."""

    def __init__(self, height: int, width: int, ksize: int = 9,
                 sigma_space: float = 10.0, sigma_color: float = 30.0,
                 impl: str = "auto", device="cuda"):
        _validate.check_ksize(ksize)
        super().__init__(height, width, impl, device,
                         space_kernel(ksize, sigma_space), color_table(sigma_color))
        self.radius = int(ksize) // 2

    @classmethod
    def from_numpy_tables(cls, space_kernel: np.ndarray, color_table: np.ndarray,
                          height: int, width: int, impl: str = "auto",
                          device="cuda") -> "BilateralFilter":
        """A filter from host-built tables: the (k, k) f32 space kernel and the
        (768,) f32 range table, e.g. those of the JAX package's
        ``core.luts.pre_compute_kernels``.  They are the filter's whole state.
        At k = 3 to 9 the space kernel is 0 outside its inscribed circle, as
        that function makes it."""
        space, table = _check_tables(space_kernel, color_table)
        module = cls(height, width, space.shape[0], impl=impl, device=device)
        cuda_bilateral.check_circle(space)
        module._set_tables(space, table)
        return module

    def _filter(self, src: torch.Tensor, guide) -> torch.Tensor:
        if resolve_impl(self.impl, src) == "cuda":
            return cuda_bilateral.joint_bilateral(src, guide, self.taps, self.lut, self.radius)
        return _taps_math(src, src if guide is None else guide, self.taps, self.lut,
                          self.radius)

    def forward(self, src) -> torch.Tensor:
        return self._filter(self._check(src), None)

    # reference method names
    def bilateral_filter(self, src) -> torch.Tensor:
        return self.forward(src)

    def joint_bilateral_filter(self, src, guide) -> torch.Tensor:
        return self._filter(self._check(src), self._check(guide))


class AdaptiveBilateralFilter(_TableFilter):
    """Adaptive bilateral filter for (height, width, 3) u8 images."""

    table_size = COLOR_TABLE_SIZE_ADAPTIVE

    def __init__(self, height: int, width: int, ksize: int = 9,
                 sigma_space: float = 10.0, sigma_color: float = 30.0,
                 impl: str = "auto", device="cuda"):
        _validate.check_ksize(ksize)
        super().__init__(height, width, impl, device,
                         *pre_compute_kernels(ksize, sigma_space, sigma_color,
                                              COLOR_TABLE_SIZE_ADAPTIVE))
        self.radius = int(ksize) // 2

    @classmethod
    def from_numpy_tables(cls, space_kernel: np.ndarray, color_table: np.ndarray,
                          height: int, width: int, impl: str = "auto",
                          device="cuda") -> "AdaptiveBilateralFilter":
        """A filter from host-built tables: the (k, k) f32 space kernel and the
        (1536,) f32 range table, e.g. the JAX package's
        ``core.luts.pre_compute_kernels(k, σs, σc, COLOR_TABLE_SIZE_ADAPTIVE)``.
        They are the filter's whole state."""
        space, table = _check_tables(space_kernel, color_table, cls.table_size)
        module = cls(height, width, space.shape[0], impl=impl, device=device)
        module._set_tables(space, table)
        return module

    def forward(self, src) -> torch.Tensor:
        src = self._check(src)
        if resolve_impl(self.impl, src) == "cuda":
            return cuda_abf.adaptive_bilateral_taps(src, self.taps, self.lut, self.radius)
        return _abf_taps_math(src, self.taps, self.lut, self.radius)

    # reference method name
    def adaptive_bilateral_filter(self, src) -> torch.Tensor:
        return self.forward(src)


class BilateralTextureFilter(_TableFilter):
    """Bilateral texture filter for (height, width, 3) u8 images: ``nitr``
    iterations of window ``ksize``, each closed by a joint bilateral filter
    of ksize 2k−1, σ_space k−1, σ_color √3 (the reference's CUDA pipeline:
    replicate border, u8(x + 0.5f))."""

    def __init__(self, height: int, width: int, ksize: int = 9, nitr: int = 3,
                 impl: str = "auto", device="cuda"):
        _validate.check_ksize(ksize)
        check_nitr(nitr)
        super().__init__(height, width, impl, device, *jbf_numpy_tables(ksize))
        self.ksize = int(ksize)
        self.nitr = int(nitr)

    @classmethod
    def from_numpy_tables(cls, space_kernel: np.ndarray, color_table: np.ndarray,
                          height: int, width: int, nitr: int = 3, impl: str = "auto",
                          device="cuda") -> "BilateralTextureFilter":
        """A filter from the host-built tables of its joint bilateral stage: the
        (2k−1, 2k−1) f32 space kernel and the (768,) f32 range table, e.g. the
        JAX package's ``core.luts.pre_compute_kernels(2k−1, k−1, √3)``.  The
        window k follows from the space kernel's size.  At k = 2 to 5 the
        space kernel is 0 outside its inscribed circle, as that function
        makes it."""
        space, table = _check_tables(space_kernel, color_table)
        if (space.shape[0] + 1) % 4 != 2:
            raise ValueError(f"space_kernel must be (2k-1, 2k-1) for an odd window k, "
                             f"got shape {space.shape}")
        module = cls(height, width, (space.shape[0] + 1) // 2, nitr, impl, device)
        cuda_bilateral.check_circle(space)
        module._set_tables(space, table)
        return module

    def forward(self, src) -> torch.Tensor:
        src = self._check(src)
        return _btf(src, self.ksize, self.nitr, resolve_impl(self.impl, src), "cuda",
                    self.taps, self.lut)

    # reference method name
    def execute(self, src) -> torch.Tensor:
        return self.forward(src)
