"""Wexler exemplar-based inpainting: the functional wrapper of
``models/inpainting.py::WexlerInpainting``.

Counterpart of ``various_image_processings_tpu/ops/inpainting.py`` (reference:
``inpainting_wexler``, include/cpp/wexler_inpainting.hpp:336).
"""

from __future__ import annotations

import torch

from ..utils.profiling import SPANS


def inpainting_wexler(src, mask, impl: str = "auto", device="cuda", **kwargs):
    """(H, W, 3) u8 image + (H, W) u8 mask (hole > 0) → (H, W, 3) u8 tensor.

    A tensor is filled on its own device; any other array is first copied to
    ``device`` (the GPU unless the caller passes ``device="cpu"``).  kwargs go
    to ``WexlerInpainting`` (max_loop, pyramid_bottom_size, verbose,
    checkpoint_dir, multi_start).  The call is the span
    ``ops.inpainting_wexler``; ``ops.validate`` is the model's set-up, which
    checks ``impl`` and ``device``."""
    from ..models.inpainting import WexlerInpainting
    s = SPANS.open("ops.inpainting_wexler") if SPANS.on else -1
    try:
        v = SPANS.open("ops.validate") if SPANS.on else -1
        if isinstance(src, torch.Tensor):
            device = src.device
        model = WexlerInpainting(impl=impl, device=device, **kwargs)
        if v >= 0:
            SPANS.close(v)
        return model(src, mask)
    finally:
        if s >= 0:
            SPANS.close(s)
