"""Wrapper of SLIC's connectivity pass on the card (csrc/components.cu): the
4-connected components of a label map, their sizes and truncated Lab means,
the merge of the small ones and the regions' numbering, all enqueued by one
C call on PyTorch's current stream.  Nothing is read back to the host.

``pass_launches`` counts the kernels that went in (``KERNELS``, in launch
order), so the benchmark's launch count and its trace's device operations
stay one for one.  A call is the span ``cuda_wrappers.cc_pass`` around
``enqueue.cc_pass``.  The kernels' names hold no ``slic_``: the benchmark's
k-means roofline reads the operations so named.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils.profiling import SPANS
from . import _build
from ._build import check_tensor, kernel_wrapper, launch_error, plan, stream_of

pass_launches = 0

KERNELS = ("cc_tiles", "cc_border", "cc_roots", "cc_scan", "cc_sums", "cc_small", "cc_scan",
           "cc_edges", "cc_clusters", "cc_merge_warps", "cc_merge_blocks", "cc_region_roots",
           "cc_region_flags", "cc_scan", "cc_relabel")

# the header's int32 slots (csrc/components.cu, enum Slot); the first
# HEADER_READ are what a caller reads back
HEADER_INTS = 16
HEADER = ("components", "small_components", "merge_clusters", "largest_merge_cluster",
          "regions", "list_entries", "merge_rounds", "arena_overflows")
HEADER_READ = len(HEADER)

# component ids and list offsets are int32: the pass takes fewer than 2^29 pixels
MAX_PIXELS = (1 << 29) - 1


@kernel_wrapper("cc_pass", None)
def connectivity(labels: torch.Tensor, lab: torch.Tensor,
                 min_area: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) int32 labels + (H, W, 3) u8 Lab on the card → ((H, W) int32
    region ids in raster first-encounter order, the (16,) int32 header:
    ``HEADER``'s counts, then the pass's own), both on the card, neither
    ready before the stream reaches them."""
    global pass_launches
    check_tensor("labels", labels, (torch.int32,), (2,))
    check_tensor("lab", lab, (torch.uint8,), (3,))
    height, width = labels.shape
    if tuple(lab.shape) != (height, width, 3) or lab.device != labels.device:
        raise ValueError(f"lab {tuple(lab.shape)} on {lab.device} must be the (H, W, 3) image "
                         f"of labels {tuple(labels.shape)} on {labels.device}")
    if not 0 < height * width <= MAX_PIXELS:
        raise ValueError(f"the connectivity pass takes 1 to {MAX_PIXELS} pixels, got "
                         f"{height}x{width}")
    dev = labels.device
    out = torch.empty((height, width), dtype=torch.int32, device=dev)
    header = torch.empty(HEADER_INTS, dtype=torch.int32, device=dev)
    workspace = torch.empty(plan("vip_cc_workspace_bytes", height, width), dtype=torch.uint8,
                            device=dev)
    launched = ctypes.c_int()
    args = (labels.data_ptr(), lab.data_ptr(), out.data_ptr(), header.data_ptr(),
            workspace.data_ptr(), height, width, int(min_area), stream_of(labels), launched)
    s = SPANS.open("enqueue.cc_pass") if SPANS.on else -1
    try:
        with torch.cuda.device(dev):
            err = _build.load_library().vip_cc_pass(*args)
    finally:
        if s >= 0:
            SPANS.close(s)
    pass_launches += launched.value
    if err != 0:
        raise launch_error(KERNELS[launched.value], err)
    return out, header
