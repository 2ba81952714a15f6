"""Wrappers of the Hopper SLIC k-means kernels (csrc/slic_kmeans.cu): one
iteration is ``associate``, ``snap_keys`` and ``update``, in that order.
``associate`` and ``snap_keys`` take the colour metric (``METRICS``), which
picks the kernels' instantiation; ``delta_e`` runs the kernels' CIEDE2000
function on arrays of pairs, so it can be held to core/ciede2000.py alone.

They take the k-means state as CUDA tensors in the layouts the kernels
read and update it in place on PyTorch's current stream; nothing is read
back to the host.  ``state`` is an int32 (num_iteration + 2, 2) tensor: row 0
holds (max drift in cells, iterations run), row 1 + it iteration it's
(active, changed) flags, so a kernel of an iteration that is not active
returns at once (the early exit on the device).  Anything the kernels do not
take raises; a launch the runtime refuses raises.  ``association_launches``,
``snap_keys_launches`` and ``update_launches`` count successful launches, so
a run can show its main path went through the kernels; ``metric_launches``
counts the association and snap-key launches by (kernel, metric), and
``delta_e_launches`` the pair kernel's.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from ._build import check_launch, check_table, check_tensor, load_library, stream_of

association_launches = 0
snap_keys_launches = 0
update_launches = 0
delta_e_launches = 0
metric_launches: Counter = Counter()  # (kernel, metric) -> launches

# the metric ids of the C entry points, one kernel instantiation each
METRICS = {"euclidean": 0, "ciede2000": 1, "ciede2000_ref": 2}

# the kernels sum 32 pixels' x in 32 bits and pack a raster index in 32
MAX_WIDTH = 1 << 27
MAX_PIXELS = (1 << 31) - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vip_slic_association.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,          # lab, centers, labels, dists, sums, flags
        i32, i32, i32, i32, i32,               # height, width, S, per_col, per_row
        ctypes.c_float, ctypes.c_float, i32,   # space_norm, color_norm, metric
        ptr,                                   # stream
    ]
    lib.vip_slic_snap_keys.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,          # lab, centers, labels, sums, keys, flags
        i32, i32, i32, i32, i32,               # height, width, S, per_col, per_row
        i32, ptr,                              # metric, stream
    ]
    lib.vip_slic_update.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,     # lab, centers, keys, sums, stats, flags, next
        i32, i32, i32, i32, i32, ptr,          # n, width, S, per_row, iteration, stream
    ]
    lib.vip_slic_delta_e.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,     # l1, a1, b1, l2, a2, b2, out
        ctypes.c_longlong, i32, ptr,           # n, metric, stream
    ]
    for name in ("vip_slic_association", "vip_slic_snap_keys", "vip_slic_update",
                 "vip_slic_delta_e"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _grid(lab: torch.Tensor, sp_size: int) -> tuple[int, int, int, int]:
    """(height, width, per_col, per_row) of a k-means on ``lab``."""
    check_tensor("lab", lab, (torch.uint8,), (3,))
    height, width, channels = lab.shape
    if channels != 3:
        raise ValueError(f"lab must be an (H, W, 3) image, got shape {tuple(lab.shape)}")
    if sp_size < 2:
        raise ValueError("superpixel_size must be >= 2")
    if width >= MAX_WIDTH or height * width > MAX_PIXELS:
        raise ValueError(f"SLIC kernels take width < {MAX_WIDTH} and fewer than 2^31 pixels, "
                         f"got {height}x{width}")
    return height, width, -(-height // sp_size), -(-width // sp_size)


def _metric_id(metric: str) -> int:
    if metric not in METRICS:
        raise ValueError(f"unknown SLIC metric {metric!r}: the kernels take {tuple(METRICS)}")
    return METRICS[metric]


def _check_state(lab, centers, state, n: int) -> None:
    dev = lab.device
    check_table("centers", centers, torch.float32, (n, 5), dev)
    if state.ndim != 2 or state.shape[0] < 3:
        raise ValueError(f"state must be an (iterations + 2, 2) table, got {tuple(state.shape)}")
    check_table("state", state, torch.int32, (state.shape[0], 2), dev)


def _flags(state: torch.Tensor, iteration: int) -> int:
    """Address of iteration ``iteration``'s (active, changed) pair."""
    if not 0 <= iteration < state.shape[0] - 2:
        raise ValueError(f"iteration {iteration} outside the state's {state.shape[0] - 2}")
    return state.data_ptr() + (1 + iteration) * 8


def associate(lab: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
              dists: torch.Tensor, sums: torch.Tensor, state: torch.Tensor, iteration: int,
              sp_size: int, space_norm: float, color_norm: float,
              metric: str = "euclidean") -> None:
    """Association with in-scan sums: updates ``labels`` (H, W) int32 and
    ``dists`` (H, W) f32, adds to ``sums`` (N, 6) int64 of x, y, l, a, b and
    count, and sets the iteration's changed flag if a distance fell."""
    global association_launches
    metric_id = _metric_id(metric)
    height, width, per_col, per_row = _grid(lab, sp_size)
    n = per_col * per_row
    _check_state(lab, centers, state, n)
    check_table("labels", labels, torch.int32, (height, width), lab.device)
    check_table("dists", dists, torch.float32, (height, width), lab.device)
    check_table("sums", sums, torch.int64, (n, 6), lab.device)
    with torch.cuda.device(lab.device):
        err = _lib().vip_slic_association(
            lab.data_ptr(), centers.data_ptr(), labels.data_ptr(), dists.data_ptr(),
            sums.data_ptr(), _flags(state, iteration), height, width, sp_size, per_col,
            per_row, space_norm, color_norm, metric_id, stream_of(lab))
    check_launch(err, "SLIC association")
    association_launches += 1
    metric_launches["association", metric] += 1


def snap_keys(lab: torch.Tensor, centers: torch.Tensor, labels: torch.Tensor,
              sums: torch.Tensor, keys: torch.Tensor, state: torch.Tensor, iteration: int,
              sp_size: int, metric: str = "euclidean") -> None:
    """Means and snap keys: takes into ``keys`` (N,) int64 each center's
    least floor(distance to its mean) * 2^32 + raster index over its pixels."""
    global snap_keys_launches
    metric_id = _metric_id(metric)
    height, width, per_col, per_row = _grid(lab, sp_size)
    n = per_col * per_row
    _check_state(lab, centers, state, n)
    check_table("labels", labels, torch.int32, (height, width), lab.device)
    check_table("sums", sums, torch.int64, (n, 6), lab.device)
    check_table("keys", keys, torch.int64, (n,), lab.device)
    with torch.cuda.device(lab.device):
        err = _lib().vip_slic_snap_keys(
            lab.data_ptr(), centers.data_ptr(), labels.data_ptr(), sums.data_ptr(),
            keys.data_ptr(), _flags(state, iteration), height, width, sp_size, per_col,
            per_row, metric_id, stream_of(lab))
    check_launch(err, "SLIC snap keys")
    snap_keys_launches += 1
    metric_launches["snap_keys", metric] += 1


def update(lab: torch.Tensor, centers: torch.Tensor, keys: torch.Tensor, sums: torch.Tensor,
           state: torch.Tensor, iteration: int, sp_size: int) -> None:
    """Center update: snaps ``centers`` (N, 5) f32, takes the drift's max
    and the iteration count into state row 0, sets the next iteration's
    active flag to this one's changed flag, and clears ``sums`` and ``keys``."""
    global update_launches
    _, width, per_col, per_row = _grid(lab, sp_size)
    n = per_col * per_row
    _check_state(lab, centers, state, n)
    check_table("sums", sums, torch.int64, (n, 6), lab.device)
    check_table("keys", keys, torch.int64, (n,), lab.device)
    flags = _flags(state, iteration)
    with torch.cuda.device(lab.device):
        err = _lib().vip_slic_update(
            lab.data_ptr(), centers.data_ptr(), keys.data_ptr(), sums.data_ptr(),
            state.data_ptr(), flags, flags + 8, n, width, sp_size, per_row, iteration,
            stream_of(lab))
    check_launch(err, "SLIC update")
    update_launches += 1


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
    if out.numel() == 0:
        return out
    with torch.cuda.device(l1.device):
        err = _lib().vip_slic_delta_e(*(t.data_ptr() for t in planes), out.data_ptr(),
                                      out.numel(), metric_id, stream_of(l1))
    check_launch(err, "SLIC delta E")
    delta_e_launches += 1
    return out
