"""Device mesh: a (batch × spatial) grid of ``torch.device``.

Counterpart of ``various_image_processings_tpu/parallel/mesh.py``.  The JAX
layer is single-controller: one process drives a ``jax.sharding.Mesh``.  So
is this one: one process holds the grid and moves shards between its
devices as tensor copies; no process group is involved.  A grid may list a
device more than once (logical shards): the CPU tests run 8 shards on
``cpu``, and one GPU can hold several shards of one image.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._validate import check_device

BATCH_AXIS = "batch"
SPATIAL_AXIS = "y"


class Mesh:
    """``devices``: a (batch, spatial) object array of ``torch.device``;
    ``shape``: ``{"batch": b, "y": s}``, as ``mesh.shape[...]`` reads in JAX."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (batch, spatial) grid, got shape "
                             f"{devices.shape}")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: self.devices.shape[0], SPATIAL_AXIS: self.devices.shape[1]}

    @property
    def first_device(self) -> torch.device:
        """Where the batched and sharded functions gather their outputs."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        rows = "; ".join(", ".join(str(d) for d in row) for row in self.devices)
        return f"Mesh({self.shape[BATCH_AXIS]}x{self.shape[SPATIAL_AXIS]}: [{rows}])"


def _concrete(device) -> torch.device:
    """A device with its index (cuda:0, not cuda), comparable with a tensor's."""
    device = check_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def cuda_devices() -> list[torch.device]:
    """Every CUDA device.  Raises without one: the mesh never falls back to
    the CPU (pass ``devices=`` for a CPU mesh)."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh needs a CUDA GPU and none is available; pass "
                           "devices=[torch.device('cpu')] * n for a CPU mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(batch: int | None = None, spatial: int = 1, devices=None) -> Mesh:
    """(batch × spatial) mesh over ``devices`` (default: every CUDA device).

    batch=None uses all remaining devices on the batch axis.  ``devices`` may
    repeat a device."""
    devices = cuda_devices() if devices is None else [_concrete(d) for d in devices]
    n = len(devices)
    if batch is None:
        if n % spatial != 0:
            raise ValueError(f"{n} devices not divisible by spatial={spatial}")
        batch = n // spatial
    if batch * spatial > n:
        raise ValueError(f"mesh {batch}x{spatial} needs {batch * spatial} "
                         f"devices, have {n}")
    grid = np.empty(batch * spatial, dtype=object)
    grid[:] = devices[: batch * spatial]
    return Mesh(grid.reshape(batch, spatial))


def single_device_mesh() -> Mesh:
    """The 1×1 mesh on the first CUDA device."""
    return make_mesh(batch=1, spatial=1)
