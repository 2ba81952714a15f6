"""Wrappers of the Hopper SLIC k-means kernels (csrc/slic_kmeans.cu): one
iteration is ``associate``, ``snap_keys`` and ``update``, in that order.
``associate`` and ``snap_keys`` take the colour metric (``METRICS``), which
picks the kernels' instantiation; ``delta_e`` runs the kernels' CIEDE2000
function on arrays of pairs, so it can be held to core/ciede2000.py alone.

They take the k-means state of a batch of B images of one shape (B = 1
for a single image) as CUDA tensors in the layouts the kernels read, and
update it in place on PyTorch's current stream; nothing is read back to the
host.  ``lab`` is (B, H, W, 3) u8 and every other tensor has the batch as
its first dimension.  ``state`` is an int32 (B, num_iteration + 2, 2)
tensor: image b's row 0 holds its (max drift in cells, iterations run), its
row 1 + it iteration it's (active, changed) flags, so a kernel of an
iteration that is not active for an image returns at once for it (the
early exit on the device, image by image, as the JAX package's vmapped loop
masks it).  Anything the kernels do not take raises; a launch the runtime
refuses raises.  ``association_launches``, ``snap_keys_launches`` and
``update_launches`` count successful launches (one a batch), so a run can
show its main path went through the kernels; ``metric_launches`` counts the
association and snap-key launches by (kernel, metric), and
``delta_e_launches`` the pair kernel's.  A call is the span
``cuda_wrappers.<kernel>`` around ``enqueue.<kernel>``, kernel
``slic_association``, ``slic_snap_keys``, ``slic_update`` or ``slic_delta_e``.
"""

from __future__ import annotations

from collections import Counter

import torch

from ._build import check_table, check_tensor, kernel_wrapper, launch, load_library, plan

association_launches = 0
snap_keys_launches = 0
update_launches = 0
delta_e_launches = 0
metric_launches: Counter = Counter()  # (kernel, metric) -> launches

# the metric ids of the C entry points, one kernel instantiation each
METRICS = {"euclidean": 0, "ciede2000": 1, "ciede2000_ref": 2}

# the snap keys pack an image's raster index in 32 bits; the width bound is
# the kernels' contract; a launch takes at most MAX_BATCH images (the grid's
# y extent)
MAX_WIDTH = 1 << 27
MAX_PIXELS = (1 << 31) - 1
MAX_BATCH = 65535


def _grid(lab: torch.Tensor, sp_size: int) -> tuple[int, int, int, int, int]:
    """(batch, height, width, per_col, per_row) of a k-means on ``lab``."""
    check_tensor("lab", lab, (torch.uint8,), (4,))
    batch, height, width, channels = lab.shape
    if channels != 3:
        raise ValueError(f"lab must be a (B, H, W, 3) batch, got shape {tuple(lab.shape)}")
    if not 1 <= batch <= MAX_BATCH:
        raise ValueError(f"SLIC kernels take 1 to {MAX_BATCH} images a launch, got {batch}")
    if sp_size < 2:
        raise ValueError("superpixel_size must be >= 2")
    if width >= MAX_WIDTH or height * width > MAX_PIXELS:
        raise ValueError(f"SLIC kernels take width < {MAX_WIDTH} and fewer than 2^31 pixels "
                         f"an image, got {height}x{width}")
    return batch, height, width, -(-height // sp_size), -(-width // sp_size)


def _metric_id(metric: str) -> int:
    if metric not in METRICS:
        raise ValueError(f"unknown SLIC metric {metric!r}: the kernels take {tuple(METRICS)}")
    return METRICS[metric]


def _check_state(lab, centers, state, batch: int, n: int) -> None:
    dev = lab.device
    check_table("centers", centers, torch.float32, (batch, n, 5), dev)
    if state.ndim != 3 or state.shape[1] < 3:
        raise ValueError(f"state must be a (B, iterations + 2, 2) table, got "
                         f"{tuple(state.shape)}")
    check_table("state", state, torch.int32, (batch, state.shape[1], 2), dev)


def _flags(state: torch.Tensor, iteration: int) -> tuple[int, int]:
    """(address of image 0's (active, changed) pair of iteration
    ``iteration``, int32 values from one image's state to the next)."""
    if not 0 <= iteration < state.shape[1] - 2:
        raise ValueError(f"iteration {iteration} outside the state's {state.shape[1] - 2}")
    return state.data_ptr() + (1 + iteration) * 8, state.shape[1] * 2


@kernel_wrapper("slic_association", "association_launches")
def associate(lab: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
              dists: torch.Tensor, sums: torch.Tensor, state: torch.Tensor, iteration: int,
              sp_size: int, space_norm: float, color_norm: float,
              metric: str = "euclidean") -> None:
    """Association with in-scan sums: updates ``labels`` (B, H, W) int32 and
    ``dists`` (B, H, W) f32, adds to ``sums`` (B, N, 6) int64 of x, y, l, a,
    b and count, and sets an image's changed flag of the iteration if one of
    its distances fell.  An image whose state row 0 holds a drift of two
    cells or more takes its candidates from the (2 drift + 3)² cells around
    each pixel's, not the 5 × 5."""
    metric_id = _metric_id(metric)
    batch, height, width, per_col, per_row = _grid(lab, sp_size)
    n = per_col * per_row
    _check_state(lab, centers, state, batch, n)
    check_table("labels", labels, torch.int32, (batch, height, width), lab.device)
    check_table("dists", dists, torch.float32, (batch, height, width), lab.device)
    check_table("sums", sums, torch.int64, (batch, n, 6), lab.device)
    flags, stride = _flags(state, iteration)
    launch("vip_slic_association", "slic_association", lab, lab.data_ptr(), centers.data_ptr(),
           labels.data_ptr(), dists.data_ptr(), sums.data_ptr(), flags, state.data_ptr(),
           stride, batch, height, width, sp_size, per_col, per_row, space_norm, color_norm,
           metric_id)
    metric_launches["association", metric] += 1


@kernel_wrapper("slic_snap_keys", "snap_keys_launches")
def snap_keys(lab: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
              sums: torch.Tensor, keys: torch.Tensor, state: torch.Tensor, iteration: int,
              sp_size: int, metric: str = "euclidean") -> None:
    """Means and snap keys: takes into ``keys`` (B, N) int64 each center's
    least floor(distance to its mean) * 2^32 + raster index (in its image)
    over its pixels."""
    metric_id = _metric_id(metric)
    batch, height, width, per_col, per_row = _grid(lab, sp_size)
    n = per_col * per_row
    _check_state(lab, centers, state, batch, n)
    check_table("labels", labels, torch.int32, (batch, height, width), lab.device)
    check_table("sums", sums, torch.int64, (batch, n, 6), lab.device)
    check_table("keys", keys, torch.int64, (batch, n), lab.device)
    launch("vip_slic_snap_keys", "slic_snap_keys", lab, lab.data_ptr(), centers.data_ptr(),
           labels.data_ptr(), sums.data_ptr(), keys.data_ptr(), *_flags(state, iteration), batch,
           height, width, sp_size, per_col, per_row, metric_id)
    metric_launches["snap_keys", metric] += 1


@kernel_wrapper("slic_update", "update_launches")
def update(lab: torch.Tensor, centers: torch.Tensor, keys: torch.Tensor, sums: torch.Tensor,
           state: torch.Tensor, iteration: int, sp_size: int) -> None:
    """Center update: snaps ``centers`` (B, N, 5) f32, takes each image's
    drift max and iteration count into its state row 0, sets its next
    iteration's active flag to this one's changed flag, and clears ``sums``
    and ``keys``."""
    batch, height, width, per_col, per_row = _grid(lab, sp_size)
    n = per_col * per_row
    _check_state(lab, centers, state, batch, n)
    check_table("sums", sums, torch.int64, (batch, n, 6), lab.device)
    check_table("keys", keys, torch.int64, (batch, n), lab.device)
    flags, stride = _flags(state, iteration)
    launch("vip_slic_update", "slic_update", lab, lab.data_ptr(), centers.data_ptr(),
           keys.data_ptr(), sums.data_ptr(), state.data_ptr(), flags, flags + 8, stride, batch,
           n, height, width, sp_size, per_row, iteration)


def association_shape(height: int, width: int, metric: str = "euclidean") -> tuple[int, int]:
    """(blocks an image, blocks an SM can hold) of the association kernel of
    ``metric`` on an image of this shape: its launch shape, for reports."""
    return (plan("vip_slic_association_blocks", height, width),
            load_library().vip_slic_association_occupancy(_metric_id(metric)))


@kernel_wrapper("slic_delta_e", None)
def delta_e(l1: torch.Tensor, a1: torch.Tensor, b1: torch.Tensor, l2: torch.Tensor,
            a2: torch.Tensor, b2: torch.Tensor, metric: str = "ciede2000") -> torch.Tensor:
    """The squared ΔE of ``metric`` ("ciede2000" or "ciede2000_ref") of each
    pair (l1, a1, b1)[i], (l2, a2, b2)[i]: six f32 CUDA tensors of one shape,
    through the kernels' device function → f32 of that shape."""
    global delta_e_launches
    metric_id = _metric_id(metric)
    if metric_id == METRICS["euclidean"]:
        raise ValueError("the pair kernel computes the CIEDE2000 metrics only")
    planes = (l1, a1, b1, l2, a2, b2)
    for name, t in zip(("l1", "a1", "b1", "l2", "a2", "b2"), planes):
        check_tensor(name, t, (torch.float32,), (t.ndim,))
        check_table(name, t, torch.float32, tuple(l1.shape), l1.device)
    out = torch.empty_like(l1)
    if out.numel():
        launch("vip_slic_delta_e", "slic_delta_e", l1, *(t.data_ptr() for t in planes),
               out.data_ptr(), out.numel(), metric_id)
        delta_e_launches += 1
    return out
