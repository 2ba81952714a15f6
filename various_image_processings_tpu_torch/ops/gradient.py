"""Sobel-style gradient magnitude.

PyTorch counterpart of ``various_image_processings_tpu/ops/gradient.py``
(reference: include/cpp/gradient.hpp:89, include/cuda/gradient.hpp:13):
clamped central differences (the reference's one-sided forms at the borders
are exactly central differences on a replicate-padded image), squared and
summed over the channels in order, sqrt → (H, W) f32.  u8 and f32 inputs
with any number of channels.

Both the plain version (``impl="torch"``) and the CUDA kernel
(``impl="cuda"``, csrc/gradient.cu) round every op on its own, so they are
bit-equal to each other, and for u8 input to the golden layer.
"""

from __future__ import annotations

import torch

from ..core.pad import replicate_pad
from ..utils.profiling import SPANS
from . import _validate
from ._dispatch import resolve_impl
from .cuda import gradient as cuda_gradient


def _gradient_math(s: torch.Tensor) -> torch.Tensor:
    """s: (H, W, C) f32 → (H, W) f32."""
    p = replicate_pad(s, 1, 1, 1, 1)
    vdiff = p[2:, 1:-1] - p[:-2, 1:-1]
    hdiff = p[1:-1, 2:] - p[1:-1, :-2]
    square = hdiff * hdiff + vdiff * vdiff
    # the channel sum in sequence, so the order is the kernel's on every device
    total = square[:, :, 0]
    for c in range(1, s.shape[2]):
        total = total + square[:, :, c]
    # PyTorch's f32 sqrt on the CPU is not correctly rounded (about 0.6% of
    # values are one ulp off); the f64 sqrt rounded to f32 is, on every
    # device, and so equals IEEE sqrtf, golden's np.sqrt and the kernel's.
    return torch.sqrt(total.double()).to(torch.float32)


def _gradient(s: torch.Tensor, impl: str) -> torch.Tensor:
    """s: (H, W, C) u8|f32 tensor → (H, W) f32, on s's device; ``impl`` is
    resolved already."""
    if impl == "cuda":
        return cuda_gradient.gradient(s.contiguous())
    return _gradient_math(s.to(torch.float32))


def gradient(src, impl: str = "auto", device="cuda") -> torch.Tensor:
    """(H, W) or (H, W, C) u8|f32 → (H, W) f32 gradient magnitude.

    A tensor is processed on its own device; any other array is first
    copied to ``device`` (the GPU unless the caller passes ``device="cpu"``).
    The call is the span ``ops.gradient``."""
    s = SPANS.open("ops.gradient") if SPANS.on else -1
    try:
        v = SPANS.open("ops.validate") if SPANS.on else -1
        src = _validate.as_tensor(src, device)
        if src.dtype not in (torch.uint8, torch.float32):
            raise TypeError(f"gradient supports u8/f32, got {src.dtype}")
        if src.ndim not in (2, 3):
            raise ValueError(f"src must be (H, W) or (H, W, C), got shape {tuple(src.shape)}")
        impl = resolve_impl(impl, src)
        if v >= 0:
            SPANS.close(v)
        return _gradient(src if src.ndim == 3 else src[:, :, None], impl)
    finally:
        if s >= 0:
            SPANS.close(s)
