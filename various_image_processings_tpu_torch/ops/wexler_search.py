"""Wexler exemplar search: for each target, the least masked-SSD energy over
the candidate windows that miss the hole, and the first candidate reaching it.

PyTorch counterpart of the search in
``various_image_processings_tpu/models/inpainting.py::_ring_targets_search``
(:342-365): its conv branch and the Pallas kernel
``ops/pallas/wexler_search.py::search_min_pallas``.  Inputs:

- ``p117`` (H, n_cx, 117) bf16, the kx-packed candidate planes
  (``models/inpainting.py::_build_p117``), n_cx = W − 12;
- ``f13`` (13, 117, T) bf16, the per-target filters;
- ``valid`` (n_cy, n_cx) bool, n_cy = H − 12: candidate windows that miss
  the hole.

Returns (emin (T,) f32, idx (T,) int32): the minimum of
``E'[c, t] = Σ_ky Σ_ch p117[cy+ky, cx, ch] · f13[ky, ch, t]`` over the valid
candidates c, and the lowest raster flat index ``cy·n_cx + cx`` reaching it.
Where no candidate is valid, emin is +inf and idx 0 (the conv path's
convention; the Pallas path clamps its sentinel to ncand − 1 there, and its
docstring says 0).  Those targets are never written by the fill.

``_search_min_math`` is the plain version (im2col, an f32 product of f32
copies of the bf16 inputs, +inf at invalid candidates, the first argmin);
``impl="cuda"`` runs the Hopper kernel (csrc/wexler_search.cu).
"""

from __future__ import annotations

import torch

from ._dispatch import resolve_impl
from .cuda import wexler_search as cuda_search

plain_searches = 0  # searches that took the plain version


def _search_min_math(p117: torch.Tensor, f13: torch.Tensor,
                     valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version, on p117's device.  The product is taken in f32:
    a bf16 matmul would round the energies to 8 bits."""
    window, channels, t = f13.shape
    n_cy, n_cx = valid.shape
    a = p117.to(torch.float32).unfold(0, window, 1)  # (n_cy, n_cx, C, ky)
    a = a.permute(0, 1, 3, 2).reshape(n_cy * n_cx, window * channels)
    e = a @ f13.to(torch.float32).reshape(window * channels, t)
    e = torch.where(valid.reshape(-1, 1), e, torch.inf)
    idx = torch.argmin(e, dim=0)  # the first minimum: raster order of window top-lefts
    return e.gather(0, idx[None])[0], idx.to(torch.int32)


def search_min(p117: torch.Tensor, f13: torch.Tensor, valid: torch.Tensor,
               impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """(emin (T,) f32, idx (T,) int32); see the module docstring."""
    global plain_searches
    if p117.ndim != 3 or f13.ndim != 3 or p117.shape[2] != f13.shape[1]:
        raise ValueError(f"p117 (H, n_cx, C) and f13 (k, C, T) do not match: "
                         f"{tuple(p117.shape)}, {tuple(f13.shape)}")
    n_cy = p117.shape[0] - (f13.shape[0] - 1)
    n_cx = p117.shape[1]
    if n_cy < 1 or n_cx < 1:
        raise ValueError(f"the image is smaller than the {f13.shape[0]}x{f13.shape[0]} search "
                         f"window: no candidate (p117 {tuple(p117.shape)})")
    if tuple(valid.shape) != (n_cy, n_cx):
        raise ValueError(f"valid must have shape {(n_cy, n_cx)}, got {tuple(valid.shape)}")
    if resolve_impl(impl, p117) == "cuda":
        return cuda_search.search_min(p117.contiguous(), f13.contiguous(), valid.contiguous())
    plain_searches += 1
    return _search_min_math(p117, f13, valid)
