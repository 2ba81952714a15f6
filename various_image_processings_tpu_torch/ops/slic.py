"""SLIC superpixels: the functional wrapper over ``models/slic.py``.

Counterpart of ``superpixel_slic`` (reference: include/cpp/slic.hpp:482) and
of the JAX package's ``ops/slic.py``.
"""

from __future__ import annotations

import torch

from ..utils.profiling import SPANS
from . import _validate


def superpixel_slic(image, superpixel_size: int = 30, num_iteration: int = 10,
                    color_scale: float = 20.0, metric: str = "euclidean",
                    device="cuda") -> torch.Tensor:
    """(H, W, 3) u8 BGR → (H, W) int32 superpixel labels, on the image's
    device (a NumPy image goes to ``device``, the GPU unless the caller
    passes ``device="cpu"``).

    metric: "euclidean" (the reference default, L scaled by 2.55),
    "ciede2000" (correct CIEDE2000, carried by the reference but never
    selectable there) or "ciede2000_ref" (the reference's π-scaled variant,
    core/ciede2000.py).

    There is no ``impl`` parameter, as in the JAX package: the k-means takes
    ``models/slic.py::slic_device``'s ``"auto"`` route, the hand-written
    kernels (``csrc/slic_kmeans.cu``) for an image on the GPU with any of
    the three metrics, the plain PyTorch version on the CPU.  The
    connectivity pass runs on the card for the euclidean metric on the GPU
    (``csrc/components.cu``: the labels never leave it, and the call reads
    the device once), else on the host (native C++; for the ΔE metrics,
    native components and a Python merge).  The call is the span
    ``ops.superpixel_slic``; ``ops.validate`` takes in the model's set-up."""
    from ..models.slic import SuperpixelSLIC
    s = SPANS.open("ops.superpixel_slic") if SPANS.on else -1
    try:
        v = SPANS.open("ops.validate") if SPANS.on else -1
        img = _validate.as_tensor(image, device)
        _validate.check_u8_color("image", img)
        slic = SuperpixelSLIC(img.shape[0], img.shape[1], superpixel_size, num_iteration,
                              color_scale, metric, device=img.device)
        if v >= 0:
            SPANS.close(v)
        return slic.apply(img)
    finally:
        if s >= 0:
            SPANS.close(s)
