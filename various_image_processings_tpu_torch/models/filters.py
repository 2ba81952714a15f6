"""Class-style filter API.

Counterpart of ``various_image_processings_tpu/models/filters.py`` and the
reference's ``CudaBilateralFilter`` (include/cuda/bilateral_filter.hpp:7-31):
the constructor fixes the image size and parameters and builds the tables
once; calls then run without per-call setup.  The tap table and range LUT
are registered buffers, so ``.to(device)`` moves them with the module.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.luts import COLOR_TABLE_SIZE_BILATERAL, color_table, space_kernel, tap_table
from ..ops import _validate
from ..ops._dispatch import check_impl, resolve_impl
from ..ops.bilateral import _taps_math
from ..ops.cuda import bilateral as cuda_bilateral


class BilateralFilter(nn.Module):
    """Bilateral / joint bilateral filter for (height, width, 3) u8 images."""

    def __init__(self, height: int, width: int, ksize: int = 9,
                 sigma_space: float = 10.0, sigma_color: float = 30.0,
                 impl: str = "auto"):
        super().__init__()
        _validate.check_ksize(ksize)
        check_impl(impl)
        self.height = int(height)
        self.width = int(width)
        self.radius = int(ksize) // 2
        self.impl = impl
        self.register_buffer("taps", torch.from_numpy(tap_table(space_kernel(ksize, sigma_space))))
        self.register_buffer("lut", torch.from_numpy(color_table(sigma_color)))

    @classmethod
    def from_numpy_tables(cls, space_kernel: np.ndarray, color_table: np.ndarray,
                          height: int, width: int, impl: str = "auto") -> "BilateralFilter":
        """A filter from host-built tables: the (k, k) f32 space kernel and the
        (768,) f32 range table, e.g. those of the JAX package's
        ``core.luts.pre_compute_kernels``.  They are the filter's whole state."""
        space = np.asarray(space_kernel, np.float32)
        table = np.asarray(color_table, np.float32)
        if space.ndim != 2 or space.shape[0] != space.shape[1]:
            raise ValueError(f"space_kernel must be square, got shape {space.shape}")
        if table.shape != (COLOR_TABLE_SIZE_BILATERAL,):
            raise ValueError(f"color_table must have shape ({COLOR_TABLE_SIZE_BILATERAL},), "
                             f"got {table.shape}")
        module = cls(height, width, space.shape[0], impl=impl)
        module.taps = torch.from_numpy(tap_table(space))
        module.lut = torch.from_numpy(table.copy())
        return module

    def _check(self, img) -> torch.Tensor:
        img = _validate.as_tensor(img, self.lut.device)
        if tuple(img.shape) != (self.height, self.width, 3) or img.dtype != torch.uint8:
            raise ValueError(
                f"expected ({self.height}, {self.width}, 3) u8, got "
                f"{tuple(img.shape)} {img.dtype}")
        if img.device != self.lut.device:
            raise ValueError(f"input on {img.device}, filter on {self.lut.device}")
        return img.contiguous()

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
