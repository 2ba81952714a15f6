"""Spatial sharding with halo exchange.

Counterpart of ``various_image_processings_tpu/parallel/spatial.py``.  An
image's rows are cut into equal blocks over the mesh's spatial axis; each
block is extended by the rows its stencil reaches (its neighbours' edge rows,
copied to its device), filtered on its device by the single-device op, and
cropped back.  The global top and bottom replicate their own edge row, which
is the single-device op's replicate border, so the result is bit-identical
to the single-device op.  Only replicate-border ops are sharded: a
reflect-101 border does not commute with the exchange.

The layer is single-controller, as the JAX one is: one process runs the
shards one after another, in their devices' current streams.  On a mesh
whose batch axis is longer than 1 the image is sharded over the first batch
row; the JAX program computes the same rows again on every batch row, which
changes no result.

Not carried over from the JAX module: its ``lru_cache`` runner caches.  They
keep ``jax.jit`` from retracing a fresh closure; eager PyTorch compiles
nothing, so there is nothing to cache.
"""

from __future__ import annotations

import torch

from ..ops import _validate
from ..ops import bilateral_texture as obt
from ..ops._dispatch import check_impl, resolve_impl
from ..ops.adaptive_bilateral import adaptive_bilateral_filter
from ..ops.bilateral import bilateral_filter, joint_bilateral_filter
from ..ops.gradient import gradient
from .mesh import SPATIAL_AXIS, Mesh, cuda_devices, make_mesh


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (itself if it is there already).

    Between two CUDA devices ATen runs the copy on the source's current
    stream, behind the work that produced ``t``, and makes the destination's
    current stream wait for it (an event barrier each way in its
    device-to-device copy).  Every stage here runs on its device's current
    stream, so the copy may be non-blocking: no host sync is needed for the
    consumer to see finished rows.  A copy from or to the host stays
    blocking."""
    if t.device == device:
        return t
    return t.to(device, non_blocking=t.is_cuda and device.type == "cuda")


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst[...] = src across devices, ordered as ``to_device`` orders it."""
    dst.copy_(src, non_blocking=src.is_cuda and dst.is_cuda)


def halo_exchange_rows(blocks, radius: int) -> list[torch.Tensor]:
    """[(Hl, W, ...)] row blocks of one spatial axis, top to bottom →
    [(Hl + 2r, W, ...)]: each block with ``radius`` rows of its neighbours
    above and below, copied to the block's device; the global top and bottom
    replicate their own edge row.

    The JAX function ``halo_exchange_rows(block, radius, axis_name,
    num_devices)`` is the SPMD body of one device and pulls its halo with
    ``ppermute``.  torch has no SPMD body, so this function takes the whole
    axis at once: the signature differs on purpose."""
    blocks = list(blocks)
    if radius == 0:
        return blocks
    n = len(blocks)
    if n > 1 and min(b.shape[0] for b in blocks) < radius:
        raise ValueError(f"shard height {min(b.shape[0] for b in blocks)} smaller than "
                         f"halo {radius}")
    out = []
    for i, block in enumerate(blocks):
        edge = (radius,) + tuple(block.shape[1:])
        top = (block[:1].expand(edge) if i == 0
               else to_device(blocks[i - 1][-radius:], block.device))
        bottom = (block[-1:].expand(edge) if i == n - 1
                  else to_device(blocks[i + 1][:radius], block.device))
        out.append(torch.cat([top, block, bottom]))
    return out


def split_rows(t: torch.Tensor, devices) -> list[torch.Tensor]:
    """``t``'s rows in len(devices) equal blocks, block i on devices[i]."""
    hl = t.shape[0] // len(devices)
    return [to_device(t[i * hl : (i + 1) * hl], dev) for i, dev in enumerate(devices)]


def gather_rows(parts, out: torch.Tensor) -> torch.Tensor:
    """Copy the row blocks ``parts`` into ``out``, top to bottom."""
    row = 0
    for part in parts:
        copy_into(out[row : row + part.shape[0]], part)
        row += part.shape[0]
    return out


def gather(parts, device: torch.device) -> torch.Tensor:
    """The row blocks ``parts`` as one tensor on ``device``."""
    rows = sum(p.shape[0] for p in parts)
    out = torch.empty((rows,) + tuple(parts[0].shape[1:]), dtype=parts[0].dtype,
                      device=device)
    return gather_rows(parts, out)


def stage_rows(fn, radius: int, *planes):
    """One stencil stage on every shard: each plane (a list of row blocks,
    one a shard) is exchanged with ``radius`` halo rows, ``fn(*blocks)``
    runs shard by shard on its shard's device, and its output (a tensor or
    a tuple of them) is cropped back to the shard's rows → a list of row
    blocks, or a tuple of such lists."""
    extended = [halo_exchange_rows(p, radius) for p in planes]
    outs = []
    for own, shard in zip(planes[0], zip(*extended)):
        out = fn(*shard)
        crop = slice(radius, radius + own.shape[0])
        outs.append(tuple(o[crop] for o in out) if isinstance(out, tuple) else out[crop])
    return tuple(map(list, zip(*outs))) if isinstance(outs[0], tuple) else outs


def stencil_rows(fn_full, arrays, radius: int, devices) -> list[torch.Tensor]:
    """Shard ``arrays`` (row-aligned) over ``devices`` and run ``fn_full``
    as one stage → the output row blocks, each on its shard's device."""
    return stage_rows(fn_full, radius, *(split_rows(a, devices) for a in arrays))


def spatial_devices(mesh: Mesh) -> list[torch.device]:
    return list(mesh.devices[0])


def _check_shardable(h: int, radius: int, mesh: Mesh):
    d = mesh.shape[SPATIAL_AXIS]
    if h % d != 0:
        raise ValueError(f"image rows {h} not divisible by spatial axis {d}")
    if h // d < radius:
        raise ValueError(f"shard height {h // d} smaller than halo {radius}")


def stencil_apply_sharded(fn_full, image, radius: int, mesh: Mesh,
                          out_ndim: int | None = None, extras=()):
    """Run a replicate-padded stencil op on a row-sharded image.

    fn_full: the single-device op ((H', W, C) → output with leading row dim,
    computing with its own internal replicate padding).  Each shard receives
    its rows plus exchanged halos, runs fn_full on the extended block, and
    crops the halo back off — exact for any op whose output pixel depends
    only on the (2r+1)² input window.  out_ndim: rank of fn_full's output
    (defaults to the image's rank; another rank raises).  extras: additional
    row-aligned arrays (e.g. a guide image) sharded and halo-exchanged the
    same way, passed to fn_full after the image.  → one tensor on the mesh's
    first device."""
    image = _validate.as_tensor(image, mesh.first_device)
    extras = [_validate.as_tensor(e, mesh.first_device) for e in extras]
    if any(e.shape[0] != image.shape[0] for e in extras):
        raise ValueError("extras must have the image's rows")
    _check_shardable(image.shape[0], radius, mesh)
    parts = stencil_rows(fn_full, [image, *extras], radius, spatial_devices(mesh))
    want = out_ndim or image.ndim
    if parts[0].ndim != want:
        raise ValueError(f"fn_full returned rank {parts[0].ndim}, out_ndim is {want}")
    return gather(parts, mesh.first_device)


def _default_mesh(mesh):
    """JAX's default: batch 1, spatial = every device (here every CUDA
    device; without one, make_mesh raises)."""
    if mesh is None:
        mesh = make_mesh(batch=1, spatial=len(cuda_devices()))
    return mesh


def bilateral_filter_sharded(image, ksize: int = 9, sigma_space: float = 10.0,
                             sigma_color: float = 30.0, mesh: Mesh | None = None,
                             impl: str = "auto"):
    """(H, W, 3) u8 → (H, W, 3) u8, rows sharded over the mesh's spatial
    axis with halo exchange. Bit-identical to the single-device op."""
    mesh = _default_mesh(mesh)
    check_impl(impl)
    image = _validate.as_tensor(image, mesh.first_device)
    _validate.check_u8_color("src", image)
    _validate.check_ksize(ksize)
    return stencil_apply_sharded(
        lambda blk: bilateral_filter(blk, ksize, sigma_space, sigma_color, impl=impl),
        image, ksize // 2, mesh)


def joint_bilateral_filter_sharded(image, guide, ksize: int = 9,
                                   sigma_space: float = 10.0,
                                   sigma_color: float = 30.0,
                                   mesh: Mesh | None = None,
                                   impl: str = "auto"):
    """Row-sharded joint bilateral filter: image and guide shard together,
    both halo-exchanged. Bit-identical to the single-device op."""
    mesh = _default_mesh(mesh)
    check_impl(impl)
    image = _validate.as_tensor(image, mesh.first_device)
    guide = _validate.as_tensor(guide, mesh.first_device)
    if image.shape[:2] != guide.shape[:2]:
        raise ValueError("image and guide sizes differ")
    _validate.check_u8_color("src", image)
    _validate.check_u8_color("guide", guide)
    _validate.check_ksize(ksize)
    return stencil_apply_sharded(
        lambda blk, gd: joint_bilateral_filter(blk, gd, ksize, sigma_space, sigma_color,
                                               impl=impl),
        image, ksize // 2, mesh, extras=(guide,))


def adaptive_bilateral_filter_sharded(image, ksize: int = 9,
                                      sigma_space: float = 10.0,
                                      sigma_color: float = 30.0,
                                      mesh: Mesh | None = None,
                                      impl: str = "auto"):
    """Row-sharded adaptive bilateral filter (halo = radius: both the box
    mean and the range window span the same (2r+1)² neighbourhood)."""
    mesh = _default_mesh(mesh)
    check_impl(impl)
    image = _validate.as_tensor(image, mesh.first_device)
    _validate.check_u8_color("src", image)
    _validate.check_ksize(ksize)
    return stencil_apply_sharded(
        lambda blk: adaptive_bilateral_filter(blk, ksize, sigma_space, sigma_color,
                                              impl=impl),
        image, ksize // 2, mesh)


def gradient_sharded(image, mesh: Mesh | None = None, impl: str = "auto"):
    """Row-sharded gradient magnitude (halo = 1) → (H, W) f32."""
    mesh = _default_mesh(mesh)
    check_impl(impl)
    return stencil_apply_sharded(lambda blk: gradient(blk, impl=impl), image, 1, mesh,
                                 out_ndim=2)


def _btf_iteration_sharded(blocks, ksize: int, impl: str):
    """One BTF iteration over row blocks, a halo exchange before each stage
    (the stages of ``ops.bilateral_texture.btf_iteration``, cuda variant);
    ``impl`` is resolved shard by shard, from the shard's device."""
    r = ksize // 2
    border, rounding = obt.VARIANTS["cuda"]

    def impl_of(t: torch.Tensor) -> str:
        return resolve_impl(impl, t)

    magnitude = stage_rows(lambda img: obt.gradient_stage(img, impl_of(img)), 1, blocks)
    blurred, rtv = stage_rows(
        lambda img, mag: obt.blur_rtv_stage(img, mag, ksize, impl_of(img)), r, blocks, magnitude)
    guide = stage_rows(lambda b, v: obt.guide_stage(b, v, ksize, impl_of(b)), r, blurred, rtv)
    # the JBF's tables are built on each shard's own device
    return stage_rows(
        lambda img, g: obt.jbf_stage(img, g, *obt.jbf_tables(ksize, img.device), ksize,
                                     border, rounding, impl_of(img)),
        ksize - 1, blocks, guide)


def bilateral_texture_filter_sharded(image, ksize: int = 9, nitr: int = 3,
                                     mesh: Mesh | None = None,
                                     impl: str = "auto"):
    """Row-sharded bilateral texture filter, bit-identical everywhere.

    A multi-stage pipeline does not commute with one-shot pre-padding (stage
    2 of a replicate-padded input ≠ replicate-padding stage 2's output), so
    this exchanges halos PER STAGE inside each iteration: gradient (halo 1),
    blur + mRTV (r, image and magnitude), guide (r, blurred and rtv), joint
    bilateral k′ = 2k−1 (k−1, image and guide), each on the freshly
    exchanged rows.  ``halo_exchange_rows`` replicates the current stage's
    own edge rows at the global top and bottom — exactly the single-device
    op's per-stage clamping — so every row matches the single-device op
    (cuda variant) bit for bit.  The u8 image is what is exchanged: the
    stages take u8, and u8 → f32 is exact.

    ``impl`` selects the stage kernels exactly like the single-device op,
    shard by shard ("auto": the kernels on a CUDA shard, the plain versions
    on a CPU shard)."""
    mesh = _default_mesh(mesh)
    check_impl(impl)
    image = _validate.as_tensor(image, mesh.first_device)
    _validate.check_u8_color("src", image)
    _validate.check_ksize(ksize)
    obt.check_nitr(nitr)
    d = mesh.shape[SPATIAL_AXIS]
    radius = ksize // 2
    jbf_radius = (2 * ksize - 1) // 2
    h = image.shape[0]
    if h % d != 0:
        raise ValueError(f"image rows {h} not divisible by spatial axis {d}")
    if h // d < max(1, radius, jbf_radius):
        raise ValueError(
            f"shard height {h // d} smaller than the widest stage halo "
            f"{max(1, radius, jbf_radius)}")
    blocks = split_rows(image.contiguous(), spatial_devices(mesh))
    for _ in range(nitr):
        blocks = _btf_iteration_sharded(blocks, ksize, impl)
    return gather(blocks, mesh.first_device)
