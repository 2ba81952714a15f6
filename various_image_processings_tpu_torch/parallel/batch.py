"""Batch fan-out over the mesh.

Counterpart of ``various_image_processings_tpu/parallel/batch.py``: a batch
of images is split over the mesh's batch axis, each image runs the
single-image op on its row's device, and the outputs are gathered into one
tensor on the mesh's first device.  Batch row i of the mesh takes images
[i·B/nb, (i+1)·B/nb) and runs them on that row's first device; the JAX
program computes the same images again on each spatial peer, which changes
no result.  With a 1×1 mesh and inputs already on its device, nothing
crosses a device: the only copy is the gather into the preallocated output.
SLIC runs each batch row's images as one sub-batch, as the JAX function
vmaps its k-means (``superpixel_slic_batched``).

Not carried over, because eager PyTorch compiles nothing: the JAX module's
``lru_cache`` runner caches, and its fresh-closure churn detector
(``_RUNNER_MISSES_BY_CODE``, ``_churn_key`` and the RuntimeWarning they
raise).  They exist because ``jax.jit`` retraces a fresh closure on every
call; here a fresh lambda per call costs nothing, so there is nothing to
cache or warn about.  The layer carries no weights or state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.colors import bgr2lab_u8_exact
from ..models import slic as mslic
from ..ops import _validate
from ..ops._dispatch import check_impl
from ..ops.adaptive_bilateral import adaptive_bilateral_filter
from ..ops.bilateral import bilateral_filter, joint_bilateral_filter
from ..ops.bilateral_texture import bilateral_texture_filter
from ..ops.gradient import gradient
from .mesh import BATCH_AXIS, SPATIAL_AXIS, Mesh, make_mesh
from .spatial import copy_into, gather_rows, stencil_rows, to_device


def _check_batch(b: int, mesh: Mesh) -> int:
    """→ images a batch row."""
    nbatch = mesh.shape[BATCH_AXIS]
    if b % nbatch != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nbatch}")
    if b == 0:
        raise ValueError("empty batch")
    return b // nbatch


def _fan_out(fn, arrays, mesh: Mesh) -> torch.Tensor:
    """fn(*image j of each array) for every j, on its batch row's first
    device → (B, ...) on the mesh's first device, filled as each output
    comes (a batch is never held twice)."""
    arrays = [_validate.as_tensor(a, mesh.first_device) for a in arrays]
    b = arrays[0].shape[0]
    per = _check_batch(b, mesh)
    out = None
    for j in range(b):
        dev = mesh.devices[j // per, 0]
        one = fn(*(to_device(a[j], dev) for a in arrays))
        if out is None:
            out = torch.empty((b,) + tuple(one.shape), dtype=one.dtype, device=mesh.first_device)
        copy_into(out[j], one)
    return out


def batched_apply(fn, images, mesh: Mesh):
    """Apply a single-image op to a batch split over the mesh's batch axis.

    fn: (H, W, ...) tensor → output tensor (any rank); images: (B, H, W, ...)
    with B divisible by the mesh's batch-axis size.  Any callable will do,
    a fresh lambda per call included: nothing is traced or cached."""
    return _fan_out(fn, [images], mesh)


def _mesh(mesh):
    return make_mesh() if mesh is None else mesh


def bilateral_filter_batched(images, ksize: int = 9, sigma_space: float = 10.0,
                             sigma_color: float = 30.0, mesh: Mesh | None = None,
                             impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8, batch-split over the mesh."""
    check_impl(impl)
    return batched_apply(
        lambda img: bilateral_filter(img, ksize, sigma_space, sigma_color, impl=impl),
        images, _mesh(mesh))


def bilateral_texture_filter_batched(images, ksize: int = 9, nitr: int = 3,
                                     mesh: Mesh | None = None,
                                     impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8, batch-split over the mesh."""
    check_impl(impl)
    return batched_apply(lambda img: bilateral_texture_filter(img, ksize, nitr, impl=impl),
                         images, _mesh(mesh))


def adaptive_bilateral_filter_batched(images, ksize: int = 9,
                                      sigma_space: float = 10.0,
                                      sigma_color: float = 30.0,
                                      mesh: Mesh | None = None,
                                      impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8, batch-split over the mesh."""
    check_impl(impl)
    return batched_apply(
        lambda img: adaptive_bilateral_filter(img, ksize, sigma_space, sigma_color, impl=impl),
        images, _mesh(mesh))


def gradient_batched(images, mesh: Mesh | None = None, impl: str = "auto"):
    """(B, H, W[, C]) u8|f32 → (B, H, W) f32, batch-split over the mesh."""
    check_impl(impl)
    return batched_apply(lambda img: gradient(img, impl=impl), images, _mesh(mesh))


def joint_bilateral_filter_batched(images, guides, ksize: int = 9,
                                   sigma_space: float = 10.0,
                                   sigma_color: float = 30.0,
                                   mesh: Mesh | None = None,
                                   impl: str = "auto"):
    """(B, H, W, 3) u8 images + guides → (B, H, W, 3) u8, batch-split."""
    mesh = _mesh(mesh)
    check_impl(impl)
    if images.shape != guides.shape:
        raise ValueError("images and guides shapes differ")
    return _fan_out(
        lambda img, gd: joint_bilateral_filter(img, gd, ksize, sigma_space, sigma_color,
                                               impl=impl),
        [images, guides], mesh)


def superpixel_slic_batched(images, superpixel_size: int = 30,
                            num_iteration: int = 10, color_scale: float = 20.0,
                            metric: str = "euclidean", mesh: Mesh | None = None):
    """(B, H, W, 3) u8 BGR → (B, H, W) int32 labels on the mesh's first
    device, each equal to ``superpixel_slic`` of its image.

    As the JAX function runs one vmapped k-means a shard, each batch row of
    the mesh takes its images as one sub-batch on its device: Lab, then
    ``slic_device_batched`` (on a GPU the k-means kernels, every metric,
    with the sub-batch in the same launches: ``num_iteration`` of each
    kernel in all, each image stopping where its own run would), then one
    device→host copy; the connectivity pass runs per image on the host, and
    the stacked labels reach the mesh's first device in one copy.  The JAX
    function warns once a batch where a center drifted past 2 cells (its 5×5
    gather then misses windows); the port's association widens with the
    drift (``models/slic.py``), so nothing warns."""
    mesh = _mesh(mesh)
    mslic.check_params(superpixel_size, metric)
    images = _validate.as_tensor(images, mesh.first_device)
    b, h, w = images.shape[:3]
    per = _check_batch(b, mesh)
    _validate.check_u8_color("image", images[0])
    raw, lab = [], []
    for row in range(b // per):
        sub = to_device(images[row * per:(row + 1) * per], mesh.devices[row, 0])
        lab_row = bgr2lab_u8_exact(sub.contiguous())
        labels, _, _, drift_row = mslic.slic_device_batched(
            lab_row, h, w, int(superpixel_size), int(num_iteration), float(color_scale), metric)
        raw_host, lab_host, _ = mslic._download(labels, lab_row, drift_row)
        raw.extend(raw_host)
        lab.extend(lab_host)
    final = np.stack([mslic.enforce_connectivity(r, lab_j, int(superpixel_size), metric)
                      for r, lab_j in zip(raw, lab)])
    return torch.from_numpy(final).to(mesh.first_device)


def inpainting_wexler_batched(images, masks, **kwargs):
    """(B, H, W, 3) u8 + (B, H, W) u8 masks → (B, H, W, 3) u8 fills.

    Sequential per image, as in the JAX package: each fill is already a
    whole-device loop of full-image searches, and the fills share no state.
    kwargs go to ``WexlerInpainting`` (``impl`` and ``device`` included)."""
    from ..models.inpainting import WexlerInpainting

    if images.shape[:1] != masks.shape[:1]:
        raise ValueError("images and masks batch sizes differ")
    model = WexlerInpainting(**kwargs)
    return torch.stack([model(images[i], masks[i]) for i in range(images.shape[0])])


def _batch_spatial(fn, arrays, radius: int, mesh: Mesh) -> torch.Tensor:
    """Both axes: image j runs on batch row j // (B/nb), its rows sharded
    over that row's spatial devices with halo exchange; → (B, ...) on the
    mesh's first device."""
    b = arrays[0].shape[0]
    per = b // mesh.shape[BATCH_AXIS]
    out = None
    for j in range(b):
        parts = stencil_rows(fn, [a[j] for a in arrays], radius, list(mesh.devices[j // per]))
        if out is None:
            rows = sum(p.shape[0] for p in parts)
            out = torch.empty((b, rows) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype,
                              device=mesh.first_device)
        gather_rows(parts, out[j])
    return out


def _check_batch_spatial(images, ksize: int, mesh: Mesh) -> int:
    nbatch = mesh.shape[BATCH_AXIS]
    d = mesh.shape[SPATIAL_AXIS]
    b, h = images.shape[0], images.shape[1]
    if b % nbatch != 0:
        raise ValueError(f"batch {b} not divisible by mesh batch axis {nbatch}")
    if h % d != 0:
        raise ValueError(f"image rows {h} not divisible by spatial axis {d}")
    radius = int(ksize) // 2
    if h // d < radius:
        raise ValueError(f"shard height {h // d} smaller than halo {radius}")
    return radius


def bilateral_filter_batch_spatial(images, ksize: int = 9,
                                   sigma_space: float = 10.0,
                                   sigma_color: float = 30.0,
                                   mesh: Mesh | None = None,
                                   impl: str = "auto"):
    """(B, H, W, 3) u8 → (B, H, W, 3) u8 over BOTH mesh axes in one call:
    the batch splits over the mesh's batch axis and each image's rows shard
    over its batch row's spatial devices, with halo exchange.
    Bit-identical to the single-device op."""
    mesh = _mesh(mesh)
    check_impl(impl)
    images = _validate.as_tensor(images, mesh.first_device)
    radius = _check_batch_spatial(images, ksize, mesh)
    return _batch_spatial(
        lambda blk: bilateral_filter(blk, ksize, sigma_space, sigma_color, impl=impl),
        [images], radius, mesh)


def joint_bilateral_filter_batch_spatial(images, guides, ksize: int = 9,
                                         sigma_space: float = 10.0,
                                         sigma_color: float = 30.0,
                                         mesh: Mesh | None = None,
                                         impl: str = "auto"):
    """(B, H, W, 3) u8 images + guides → (B, H, W, 3) u8 over BOTH mesh
    axes in one call: image and guide rows are both halo-exchanged.
    Bit-identical to the single-device op."""
    mesh = _mesh(mesh)
    check_impl(impl)
    if images.shape != guides.shape:
        raise ValueError("images and guides shapes differ")
    images = _validate.as_tensor(images, mesh.first_device)
    guides = _validate.as_tensor(guides, mesh.first_device)
    radius = _check_batch_spatial(images, ksize, mesh)
    return _batch_spatial(
        lambda blk, gd: joint_bilateral_filter(blk, gd, ksize, sigma_space, sigma_color,
                                               impl=impl),
        [images, guides], radius, mesh)
