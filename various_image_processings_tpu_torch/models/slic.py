"""SLIC superpixels.

PyTorch counterpart of ``various_image_processings_tpu/models/slic.py``
(reference: ``SuperpixelSLIC``, include/cpp/slic.hpp:114-480).  The
reference's sequential per-center window scans become a race-free k-means
whose results do not depend on the order of floating-point reductions:

- **association** (reference :236-281): every pixel takes its candidate
  centers from the (2R + 1)² grid-cell neighbourhood of its own cell, in
  ascending center order, against the *persistent* distance map (the
  reference's map carries across iterations), strictly-smaller winning, so
  the lowest center index wins ties.  A center D cells from its home cell
  scans pixels up to D + 1 cells from it, so R = max(2, 1 + D), D the
  centers' drift (``last_max_drift_cells`` reports its largest), holds
  every center whose ±S window holds the pixel, whatever the drift.  The
  JAX package keeps R = 2, the 5×5 neighbourhood: the two agree while no
  center has drifted two cells, and differ after (photographs at S = 10
  drift three or four).
- **center means**, accumulated at each center's own turn as the reference
  does (:262-269): a pixel stolen by a later center still counts in the
  earlier center's mean.  Means are ``floor(f32(sum) / f32(count))`` (the
  reference's int ClusterCenter fields, :273-277); a center that loses every
  pixel keeps its state.
- **snap** (reference :283-306): each center moves to the first raster
  pixel whose ``floor(distance)`` to the new mean is the least among its
  members (the reference keeps its running minimum in an int).
- **early exit** (reference :143-147): the next iteration runs only if a
  pixel changed.  On the kernel path the card decides it: every iteration
  is enqueued and its kernels return at once when its active flag is clear,
  so a call reads nothing back.  On the plain path the host reads the flag
  after each iteration; ``host_syncs`` counts those reads.
- **connectivity** (reference :386-458): 4-connected components, the
  merge of those smaller than S²/20 and the regions' numbering.  For the
  euclidean metric on a CUDA image it runs on the card
  (``connectivity_device``: the kernels of ``csrc/components.cu``, the
  merge run in parallel over clusters of adjacent small components, or
  their plain twin ``_connectivity_plain``), and the labels never leave it.
  Elsewhere ``enforce_connectivity`` runs it on the host: the native C++
  pass (``utils/native.py``) for the euclidean metric, staged native
  components and a Python merge for the ΔE metrics, and the NumPy/scipy
  path when the caller asks for ``impl="numpy"``.

The host pieces of a ``SuperpixelSLIC.apply`` call are spans of
``utils/profiling.py``'s ``SPANS``: ``models.slic.connectivity`` (on the
card the pass's enqueues, on the host ``enforce_connectivity``) and
``models.slic.download`` (the wait for the device, then its one device→host
copy: on the card's pass a header of counts, on the host route the raw
labels and Lab), and on the host route ``models.slic.upload`` (the final
labels' copy to the device).  Every connectivity pass also adds its host
time to ``connectivity_ns`` and one to ``connectivity_calls``, whether the
recorder is on or off; a pass on the card adds to
``device_connectivity_calls``, and its header to ``small_components``,
``merge_clusters`` and ``largest_merge_cluster`` when the call reads it.

Two routes compute the same bits on the card (``slic_device``'s
``impl``).  The kernels (``ops/cuda/slic.py``, ``csrc/slic_kmeans.cu``:
association with in-scan sums, means and snap keys, center update; three
launches an iteration) take a CUDA tensor with any of the three metrics,
each an instantiation of the kernels, and a batch of images of one shape in
the same launches (``slic_device_batched``, the counterpart of the JAX
package's ``jax.vmap`` of its k-means: each image stops where its own run
would; ``slic_device`` is a batch of one).  The plain version, ``_Grid``, takes
a CPU tensor, and a CUDA one when the caller asks: the image lives in a
blocked layout, (per_col, S, per_row, S) after padding to whole
cells, so a center's values broadcast over its cell and per-cell sums are
reductions of integer planes: nothing moves between cells and pixels through
a floating-point product.  Each distance is written op by op (``d * d``, no
fused ops), so each product and sum rounds alone: for the euclidean metric
the CPU and the card give the same bits (the ΔE metrics' transcendentals
differ by ulps between them).
"""

from __future__ import annotations

import ctypes
import functools
from time import perf_counter_ns

import numpy as np
import torch

from ..core.colors import bgr2lab_u8_exact
from ..core.pad import cdiv, reflect101_indices
from ..ops import _validate
from ..ops._dispatch import check_impl, resolve_impl
from ..utils.profiling import SPANS

METRICS = ("euclidean", "ciede2000", "ciede2000_ref")
_BIG = float(np.finfo(np.float32).max)
_BIG_KEY = torch.iinfo(torch.int64).max


def _offsets(reach: int) -> list[tuple[int, int]]:
    """The (dy, dx) of a (2·reach + 1)² cell neighbourhood, in ascending center id."""
    return [(dy, dx) for dy in range(-reach, reach + 1) for dx in range(-reach, reach + 1)]


host_syncs = 0  # device-to-host reads made by SLIC since the last reset
iterations = 0  # k-means iterations run since the last reset
# the iterations the last kernel-path call ran, an int32 tensor on its device
# (0-d after ``slic_device``, (B,) after ``slic_device_batched``; None after a
# plain call): the card decides the early exit, so the host learns the count
# only from ``_download``, which adds it to ``iterations``
device_iterations: torch.Tensor | None = None
# the host's time in a connectivity pass (ns: ``enforce_connectivity``, or
# the enqueues of ``connectivity_device``) and the completed passes, since
# the module was loaded: never reset by a call
connectivity_ns = 0
connectivity_calls = 0
# the passes run on the card; from the headers ``SuperpixelSLIC.apply`` read:
# the small components and their clusters (running totals) and the largest
# cluster (the most seen)
device_connectivity_calls = 0
small_components = 0
merge_clusters = 0
largest_merge_cluster = 0


def _host(t: torch.Tensor):
    """``t`` on the host (a Python scalar for a 0-d tensor), counted."""
    global host_syncs
    host_syncs += 1
    return t.item() if t.ndim == 0 else t.cpu().numpy()


def _norms(sp_size: int, color_scale: float) -> tuple[float, float]:
    """(1 / S², 1 / m²) as f32 values: the distance's spatial and colour weights."""
    return (float(np.float32(1.0) / np.float32(sp_size * sp_size)),
            float(np.float32(1.0) / np.float32(color_scale * color_scale)))


def _color_dist_euclid(l1, a1, b1, l2, a2, b2):
    """Reference euclidean_distance (include/cpp/slic.hpp:8-13): L scaled 2.55."""
    dl = (l1 - l2) * 2.55
    da = a1 - a2
    db = b1 - b2
    return dl * dl + da * da + db * db


def _color_dist_fn(metric: str):
    if metric == "euclidean":
        return _color_dist_euclid
    if metric == "ciede2000":
        from ..core.ciede2000 import ciede2000_square
        return ciede2000_square
    if metric == "ciede2000_ref":  # the reference's π-scaled variant
        from ..core.ciede2000 import ciede2000_ref_square
        return ciede2000_ref_square
    raise ValueError(f"unknown SLIC metric {metric!r}")


def _init_centers(lab_f: torch.Tensor, height: int, width: int, sp_size: int,
                  per_col: int, per_row: int):
    """Grid seeds, each with the color of the least 4-neighbour Laplacian
    pixel of its 3×3 window, centre first (reference :165-223: only the
    color is re-sampled; the position stays at the cell center).
    ``lab_f``: (..., H, W, 3) f32, an image or a batch of them.
    Returns (cx (N,), cy (N,), colors (..., N, 3)), f32."""
    dev = lab_f.device
    gy = torch.arange(per_col, device=dev)
    gx = torch.arange(per_row, device=dev)
    cy = (gy * sp_size + torch.clamp(gy * sp_size + sp_size - 1, max=height - 1)) // 2
    cx = (gx * sp_size + torch.clamp(gx * sp_size + sp_size - 1, max=width - 1)) // 2
    cyy = cy.repeat_interleave(per_row)  # (N,) row-major over cells
    cxx = cx.repeat(per_col)

    # Laplacian of the Lab image with reflect-101 borders (cv::Laplacian
    # ksize=1), summed over channels; integer-valued, so exact in any order
    lead = lab_f.shape[:-3]
    ry = torch.from_numpy(reflect101_indices(height, 1, 1)).to(dev)
    rx = torch.from_numpy(reflect101_indices(width, 1, 1)).to(dev)
    grad = torch.zeros((*lead, height, width), dtype=torch.float32, device=dev)
    for ch in range(3):
        c = lab_f[..., ch]
        p = c[..., ry, :][..., rx]
        grad = grad + (p[..., :-2, 1:-1] + p[..., 2:, 1:-1] + p[..., 1:-1, :-2]
                       + p[..., 1:-1, 2:] - 4.0 * c)

    offsets = [(0, 0)] + [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    idxs = torch.stack([torch.clamp(cyy + dy, 0, height - 1) * width
                        + torch.clamp(cxx + dx, 0, width - 1) for dy, dx in offsets])
    vals = grad.reshape(*lead, -1)[..., idxs]     # (..., 10, N)
    best = torch.argmin(vals, dim=-2)             # documented: the first minimum
    pick = torch.gather(idxs.expand(vals.shape), -2, best.unsqueeze(-2)).squeeze(-2)
    colors = torch.take_along_dim(lab_f.reshape(*lead, -1, 3), pick[..., None], dim=-2)
    return cxx.to(torch.float32), cyy.to(torch.float32), colors


class _Grid:
    """One SLIC problem in the blocked layout: image planes padded to whole
    cells and viewed as (per_col, S, per_row, S); center state as
    (5, per_col, per_row) grids of x, y, l, a, b."""

    def __init__(self, lab_u8: torch.Tensor, height: int, width: int, sp_size: int,
                 color_scale: float, metric: str):
        s = sp_size
        self.h, self.w, self.s = height, width, s
        self.pc, self.pr = cdiv(height, s), cdiv(width, s)
        self.n = self.pc * self.pr
        dev = self.device = lab_u8.device
        self.space_norm, self.color_norm = _norms(s, color_scale)
        self.color_dist = _color_dist_fn(metric)

        lab_i = lab_u8.to(torch.int32).permute(2, 0, 1)
        self.lab_i = self.to_blocks(lab_i, 0)       # (3, pc, S, pr, S) int32
        self.pix = self.lab_i.to(torch.float32)
        self.lab_flat = lab_u8.reshape(-1, 3).to(torch.float32)
        xs_i = torch.arange(self.pr * s, device=dev).view(1, 1, self.pr, s)
        ys_i = torch.arange(self.pc * s, device=dev).view(self.pc, s, 1, 1)
        self.xs_i, self.ys_i = xs_i, ys_i
        self.xs, self.ys = xs_i.to(torch.float32), ys_i.to(torch.float32)
        self.valid_x, self.valid_y = xs_i < width, ys_i < height
        self.flat_index = ys_i * width + xs_i      # raster index, int64
        self.center_id = torch.arange(self.n, dtype=torch.int32, device=dev).view(self.pc, self.pr)

    def to_blocks(self, x: torch.Tensor, fill) -> torch.Tensor:
        """(..., H, W) → (..., per_col, S, per_row, S), padded with ``fill``."""
        s = self.s
        out = torch.full((*x.shape[:-2], self.pc * s, self.pr * s), fill, dtype=x.dtype,
                         device=x.device)
        out[..., :self.h, :self.w] = x
        return out.view(*x.shape[:-2], self.pc, s, self.pr, s)

    def from_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """(..., per_col, S, per_row, S) → (..., H, W)."""
        s = self.s
        return x.reshape(*x.shape[:-4], self.pc * s, self.pr * s)[..., :self.h, :self.w]

    def init_centers(self) -> torch.Tensor:
        lab_f = self.from_blocks(self.pix).permute(1, 2, 0)
        cx, cy, colors = _init_centers(lab_f, self.h, self.w, self.s, self.pc, self.pr)
        return torch.cat([cx[None], cy[None], colors.T]).view(5, self.pc, self.pr)

    def association(self, centers: torch.Tensor, labels: torch.Tensor, dists: torch.Tensor,
                    reach: int = 2):
        """One association pass with in-scan mean accumulation over the
        candidates of each pixel's (2·reach + 1)² cell neighbourhood (reach
        ≥ 1 + the centers' drift in cells: every center whose window holds
        the pixel).  ``labels`` and ``dists`` are blocked; returns (labels,
        dists, any pixel changed (0-d bool), per-center sums (6, per_col,
        per_row) int64 of x, y, l, a, b and count)."""
        s, pc, pr, r = self.s, self.pc, self.pr, reach
        pad = torch.nn.functional.pad(centers, (r, r, r, r))
        # center ids on the cell grid padded by r cells (-1 past the edge):
        # slicing it at (r + dy, r + dx) gives each cell its neighbour
        # (gy + dy, gx + dx)
        center_id_pad = torch.nn.functional.pad(self.center_id, (r, r, r, r), value=-1)
        acc = torch.zeros((6, pc + 2 * r, pr + 2 * r), dtype=torch.int64, device=self.device)
        run_d, run_l = dists, labels
        for dy, dx in _offsets(r):
            cells = (slice(r + dy, r + dy + pc), slice(r + dx, r + dx + pr))
            c = pad[:, cells[0], cells[1]].reshape(5, pc, 1, pr, 1)
            lbl = center_id_pad[cells].reshape(pc, 1, pr, 1)
            dxs = self.xs - c[0]                                   # (pc, 1, pr, S)
            dys = self.ys - c[1]                                   # (pc, S, pr, 1)
            # the reference's window: |x - cx| <= S and |y - cy| <= S (:243-246)
            cov_x = (dxs.abs() <= s) & self.valid_x & (lbl >= 0)
            cov_y = (dys.abs() <= s) & self.valid_y
            scanned = cov_x & cov_y
            spatial = dxs * dxs + dys * dys
            d = self.space_norm * spatial + self.color_norm * self.color_dist(
                c[2], c[3], c[4], self.pix[0], self.pix[1], self.pix[2])
            d = torch.where(scanned, d, _BIG)
            better = d < run_d  # strict: the lowest center index wins ties
            run_d = torch.where(better, d, run_d)
            run_l = torch.where(better, lbl, run_l)
            # membership at this center's turn: scanned and labelled with it
            member = scanned & (run_l == lbl)
            per_col = member.sum(dim=1)                            # (pc, pr, S)
            per_row = member.sum(dim=3)                            # (pc, S, pr)
            cell = torch.stack([
                (per_col * self.xs_i.view(1, pr, s)).sum(-1),
                (per_row * self.ys_i.view(pc, s, 1)).sum(1),
                *torch.where(member, self.lab_i, 0).sum(dim=(2, 4)),
                per_col.sum(-1)])
            # cell (gy, gx) adds to center (gy + dy, gx + dx); cells whose
            # neighbour is past the edge have no members
            acc[:, cells[0], cells[1]] += cell
        # run_d only falls, and falls only where a pixel changed
        changed = (run_d < dists).any()
        return run_l, run_d, changed, acc[:, r:r + pc, r:r + pr]

    @staticmethod
    def center_means(centers: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
        """floor(f32 sum / f32 count), as the JAX package computes it (an f32
        quotient just below an integer may round up before the floor)."""
        counts = sums[5].to(torch.float32)
        means = torch.floor(sums[:5].to(torch.float32) / counts.clamp_min(1.0))
        return torch.where(counts > 0, means, centers)

    def snap_centers(self, centers: torch.Tensor, means: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
        """Each center moves to the first raster pixel among its members
        whose floor(color distance) to the mean is the least: one min over
        (floor key, raster index) packed into an int64, by scatter (the
        result does not depend on the order).  A pixel's label is always a
        center whose window held it (association assigns no other), so its
        label alone says whose member it is."""
        return self.move_centers(centers, self.snap_keys(means, labels))

    def snap_keys(self, means: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """(N,) int64: each center's least floor(color distance to its
        mean) * 2^32 + raster index over its pixels (a ΔE² that rounds below
        0 floors to -1), int64 max if it has none."""
        member = labels >= 0
        lbl = labels.clamp_min(0).to(torch.int64)
        m = means.reshape(5, self.n)
        key = torch.floor(self.color_dist(m[2][lbl], m[3][lbl], m[4][lbl],
                                          self.pix[0], self.pix[1], self.pix[2]))
        packed = torch.where(member, key.to(torch.int64) * (1 << 32) + self.flat_index,
                             _BIG_KEY)
        best = torch.full((self.n,), _BIG_KEY, dtype=torch.int64, device=self.device)
        best.scatter_reduce_(0, lbl.reshape(-1), packed.reshape(-1), "amin")
        return best

    def move_centers(self, centers: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
        """Each center with pixels to the pixel of its least key, with that
        pixel's color; the others keep their state."""
        has_pixels = best < _BIG_KEY
        first = torch.where(has_pixels, best & 0xFFFFFFFF, 0)
        snapped = torch.cat([(first % self.w).to(torch.float32)[None],
                             (first // self.w).to(torch.float32)[None],
                             self.lab_flat[first].T])
        return torch.where(has_pixels, snapped, centers.reshape(5, self.n)).view(
            5, self.pc, self.pr)

    def cell_drift(self, centers: torch.Tensor) -> torch.Tensor:
        """Max Chebyshev distance, in cells, of the centers' current cells
        from their home cells (integer division of exact coordinates)."""
        ccx = centers[0].to(torch.int32) // self.s
        ccy = centers[1].to(torch.int32) // self.s
        home_x = torch.arange(self.pr, device=self.device)
        home_y = torch.arange(self.pc, device=self.device)[:, None]
        return torch.maximum((ccx - home_x).abs(), (ccy - home_y).abs()).max().to(torch.float32)


def slic_device(lab_u8: torch.Tensor, height: int, width: int, sp_size: int,
                num_iteration: int, color_scale: float, metric: str = "euclidean",
                impl: str = "auto"):
    """Init and the assign/update loop on ``lab_u8``'s device →
    (labels (H, W) int32, centers (N, 5) f32 of x, y, l, a, b,
    distances (H, W) f32, max_drift_cells 0-d f32).

    ``max_drift_cells`` is the running maximum over iterations and centers
    of the Chebyshev distance (in cells) between a center's current cell and
    its home cell; the association's neighbourhood widens with it (the
    module's docstring).  Values ≤ 1 mean the JAX package's 5×5 gather gives
    the same labels.

    ``impl``: ``"cuda"`` runs the k-means on the kernels (a CUDA tensor
    only), ``"torch"`` the plain version on the tensor's device, ``"auto"``
    the kernels for a CUDA tensor and the plain version for a CPU one, for
    every metric.  The grid seeds (``_init_centers``) are plain torch on
    both routes.  The kernel route reads nothing back to the host; the
    iterations it ran wait in ``device_iterations`` for ``_download``.
    A batch of one of ``slic_device_batched``."""
    global device_iterations
    out = slic_device_batched(lab_u8[None], height, width, sp_size, num_iteration,
                              color_scale, metric, impl)
    if device_iterations is not None:
        device_iterations = device_iterations[0]
    return tuple(t[0] for t in out)


def slic_device_batched(lab_u8: torch.Tensor, height: int, width: int, sp_size: int,
                        num_iteration: int, color_scale: float, metric: str = "euclidean",
                        impl: str = "auto"):
    """``slic_device`` of each image of a (B, H, W, 3) u8 Lab batch →
    (labels (B, H, W) int32, centers (B, N, 5) f32, distances (B, H, W) f32,
    max_drift_cells (B,) f32), each image's equal to its own call.

    The counterpart of the JAX package's ``jax.vmap`` of its k-means: on
    the kernels (a CUDA tensor) the batch runs in the same launches, three
    an iteration, each image's early exit its own, and nothing is read
    back; the iterations each image ran wait in ``device_iterations``, (B,),
    for ``_download``.  The plain version (a CPU tensor, or ``impl="torch"``)
    runs image by image: the reference the kernels are held to."""
    global device_iterations
    check_impl(impl)
    device_iterations = None
    if lab_u8.ndim != 4:
        raise ValueError(f"lab must be a (B, H, W, 3) batch, got shape {tuple(lab_u8.shape)}")
    if resolve_impl(impl, lab_u8) == "cuda":
        return _kmeans_cuda(lab_u8, height, width, sp_size, num_iteration, color_scale, metric)
    runs = [_kmeans_plain(lab, height, width, sp_size, num_iteration, color_scale, metric)
            for lab in lab_u8]
    return tuple(torch.stack(parts) for parts in zip(*runs))


def _kmeans_plain(lab_u8: torch.Tensor, height: int, width: int, sp_size: int,
                  num_iteration: int, color_scale: float, metric: str):
    """The plain version: ``_Grid``'s torch ops, the host reading the early
    exit and the centers' drift (the next association's reach) in one read
    after every iteration but the last."""
    global iterations
    grid = _Grid(lab_u8, height, width, sp_size, color_scale, metric)
    centers = grid.init_centers()
    labels = torch.full(grid.pix.shape[1:], -1, dtype=torch.int32, device=grid.device)
    dists = torch.full(grid.pix.shape[1:], _BIG, dtype=torch.float32, device=grid.device)
    drift = torch.zeros((), dtype=torch.float32, device=grid.device)
    reach = 2
    for it in range(num_iteration):
        labels, dists, changed, sums = grid.association(centers, labels, dists, reach)
        means = grid.center_means(centers, sums)
        centers = grid.snap_centers(centers, means, labels)
        now = grid.cell_drift(centers)
        drift = torch.maximum(drift, now)
        iterations += 1
        if it + 1 == num_iteration:
            break
        more, now = _host(torch.stack([changed.to(torch.int32), now.to(torch.int32)]))
        reach = max(2, 1 + int(now))
        if not more:
            break
    return (grid.from_blocks(labels), centers.reshape(5, -1).T.contiguous(),
            grid.from_blocks(dists), drift)


def _kmeans_cuda(lab_u8: torch.Tensor, height: int, width: int, sp_size: int,
                 num_iteration: int, color_scale: float, metric: str):
    """The kernel route on a (B, H, W, 3) batch: every iteration enqueued,
    three launches each for the whole batch, each image's early exit and its
    association's reach decided on the card (``ops/cuda/slic.py``)."""
    global device_iterations
    from ..ops.cuda import slic as kslic

    lab = lab_u8.contiguous()
    centers, labels, dists, sums, keys, state = kmeans_state(lab, height, width, sp_size,
                                                             num_iteration)
    space_norm, color_norm = _norms(sp_size, color_scale)
    for it in range(num_iteration):
        kslic.associate(lab, centers, labels, dists, sums, state, it, sp_size, space_norm,
                        color_norm, metric)
        kslic.snap_keys(lab, centers, labels, sums, keys, state, it, sp_size, metric)
        kslic.update(lab, centers, keys, sums, state, it, sp_size)
    device_iterations = state[:, 0, 1]
    return labels, centers, dists, state[:, 0, 0].to(torch.float32)


def kmeans_state(lab: torch.Tensor, height: int, width: int, sp_size: int,
                 num_iteration: int):
    """The kernel route's state before its first iteration for a (B, H, W,
    3) batch, on ``lab``'s device, one set of torch ops for the batch:
    (centers (B, N, 5) f32 from the plain ``_init_centers``, labels (B, H,
    W) int32 all -1, dists (B, H, W) f32 all f32 max, sums (B, N, 6) int64
    zeros, keys (B, N) int64 all int64 max, state (B, num_iteration + 2, 2)
    int32: image b's row 0 (max drift in cells, iterations run), its row
    1 + it iteration it's (active, changed), the first iteration active)."""
    dev = lab.device
    b = lab.shape[0]
    per_col, per_row = cdiv(height, sp_size), cdiv(width, sp_size)
    n = per_col * per_row
    cx, cy, colors = _init_centers(lab.to(torch.float32), height, width, sp_size, per_col,
                                   per_row)
    centers = torch.cat([torch.stack([cx, cy], 1).expand(b, n, 2), colors], 2)
    labels = torch.full((b, height, width), -1, dtype=torch.int32, device=dev)
    dists = torch.full((b, height, width), _BIG, dtype=torch.float32, device=dev)
    sums = torch.zeros((b, n, 6), dtype=torch.int64, device=dev)
    keys = torch.full((b, n), _BIG_KEY, dtype=torch.int64, device=dev)
    state = torch.zeros((b, num_iteration + 2, 2), dtype=torch.int32, device=dev)
    state[:, 1, 0] = 1
    return centers, labels, dists, sums, keys, state


# ---------------------------------------------------------------------------
# connectivity (host)
# ---------------------------------------------------------------------------

def _components(labels: np.ndarray, impl: str = "native"):
    """4-connected components of the label map, numbered in raster
    first-encounter order → (comp_map, sizes, ncomp).  ``impl="native"``:
    the C++ union-find; ``"numpy"``: a scipy sparse-graph formulation."""
    if impl == "native":
        from ..utils import native
        comp, ncomp = native.ccl_4conn(labels)
        return comp, np.bincount(comp.reshape(-1), minlength=ncomp), ncomp

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = labels.shape
    idx = np.arange(h * w).reshape(h, w)
    same_h = labels[:, 1:] == labels[:, :-1]
    same_v = labels[1:, :] == labels[:-1, :]
    src = np.concatenate([idx[:, :-1][same_h], idx[:-1, :][same_v]])
    dst = np.concatenate([idx[:, 1:][same_h], idx[1:, :][same_v]])
    graph = coo_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(h * w, h * w))
    ncomp, comp = connected_components(graph, directed=False)
    _, first_pos, inverse = np.unique(comp, return_index=True, return_inverse=True)
    comp = np.argsort(np.argsort(first_pos))[inverse].reshape(h, w)
    return comp, np.bincount(comp.reshape(-1), minlength=ncomp), ncomp


def _compact(mapping: np.ndarray, comp: np.ndarray) -> np.ndarray:
    """Merged roots → consecutive region ids in raster first-encounter order:
    a region's first pixel belongs to its lowest component id (component ids
    are raster-ordered), so ranking roots by first occurrence is O(ncomp)."""
    _, first_idx, inv = np.unique(mapping, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first_idx)).astype(np.int32)
    return rank[inv][comp]


def _pair_distances(metric: str, means: np.ndarray):
    """dist(us, vs) → the metric between the means of components ``us`` and
    ``vs`` (id arrays), pair by pair, as the reference's metric computes it."""
    if metric == "euclidean":
        def dist(us, vs):
            d = means[us] - means[vs]
            dl = d[:, 0] * 2.55
            return dl * dl + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    elif metric == "ciede2000_ref":
        from ..core.ciede2000 import ciede2000_ref_square_np

        def dist(us, vs):
            return ciede2000_ref_square_np(*means[us].T, *means[vs].T)
    else:
        from ..core.ciede2000 import ciede2000_square

        def dist(us, vs):
            return ciede2000_square(*torch.from_numpy(means[us].T),
                                    *torch.from_numpy(means[vs].T)).numpy()
    return dist


# glibc's mallopt parameters (malloc.h)
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
KEEP_BYTES = 1 << 30


@functools.cache
def _keep_freed_memory() -> None:
    """SLIC's host pass owns the process's allocator policy: once, glibc is
    told to serve blocks of up to ``KEEP_BYTES`` from its heap and to keep up
    to that much freed at the heap's top, so one call's temporaries are
    reused by the next.  A 4K call allocates ~0.4 GB of them (the download's
    host copy; the native pass's runs, edges and tables, which
    ``native/src/vip_native.cpp`` allocates per call); with glibc's defaults
    (a block above a dynamic threshold of at most 32 MiB mapped alone, the
    heap's free top trimmed) every call mapped and zeroed them anew.  The
    policy holds for every later allocation of the process, whatever makes
    it.  Nothing where the C library has no ``mallopt``."""
    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)
    if mallopt is not None:
        mallopt(M_MMAP_THRESHOLD, KEEP_BYTES)
        mallopt(M_TRIM_THRESHOLD, KEEP_BYTES)


def enforce_connectivity(labels: np.ndarray, lab: np.ndarray, sp_size: int,
                         metric: str = "euclidean", impl: str = "native") -> np.ndarray:
    """Reference: include/cpp/slic.hpp:386-458 — relabel 4-connected
    components, then merge components smaller than S²/20, in raster order,
    into the neighbouring region with the closest mean color (ties to the
    lowest id).  (H, W) int32 labels + (H, W, 3) u8 Lab → (H, W) int32.

    ``impl="native"`` (the default) runs the euclidean pass as one C++ call
    and, for the ΔE metrics, native components and sums with the merge in
    Python; ``impl="numpy"`` runs scipy components, NumPy sums and the
    Python merge.  Both give the same labels.

    A call that returns adds its host time to ``connectivity_ns`` and one to
    ``connectivity_calls`` (the native library's build, on a checkout's
    first call, comes before the clock starts).  The first call sets the C
    library's allocator policy for the process (``_keep_freed_memory``)."""
    global connectivity_ns, connectivity_calls
    _keep_freed_memory()
    if impl == "native":
        from ..utils import native
        native.load_library()
    start = perf_counter_ns()
    out = _connectivity(labels, lab, sp_size, metric, impl)
    connectivity_ns += perf_counter_ns() - start
    connectivity_calls += 1
    return out


def _connectivity(labels: np.ndarray, lab: np.ndarray, sp_size: int, metric: str,
                  impl: str) -> np.ndarray:
    """``enforce_connectivity``'s pass."""
    if impl not in ("native", "numpy"):
        raise ValueError(f"impl must be 'native' or 'numpy', got {impl!r}")
    if metric not in METRICS:
        raise ValueError(f"unknown SLIC metric {metric!r}")
    labels = np.ascontiguousarray(labels, np.int32)
    lab = np.ascontiguousarray(lab, np.uint8)
    min_area = (sp_size * sp_size) // 20
    if impl == "native":
        from ..utils import native
        if metric == "euclidean":
            return native.slic_connectivity(labels, lab, min_area)
        comp, ncomp = native.ccl_4conn(labels)
        sums = native.component_sums(comp, lab, ncomp)
        sizes = sums[:, 5]
        means = sums[:, 2:5] // sizes[:, None]  # int truncation (:415-421)
    else:
        comp, sizes, ncomp = _components(labels, "numpy")
        flat = comp.reshape(-1)
        means = np.stack([np.bincount(flat, weights=lab[:, :, c].reshape(-1).astype(np.int64),
                                      minlength=ncomp).astype(np.int64) for c in range(3)], 1)
        means //= sizes[:, None]

    # component adjacency (4-connectivity), from the edges between them
    horiz = comp[:, :-1] != comp[:, 1:]
    vert = comp[:-1, :] != comp[1:, :]
    ea = np.concatenate([comp[:, :-1][horiz], comp[:-1, :][vert]])
    eb = np.concatenate([comp[:, 1:][horiz], comp[1:, :][vert]])
    edges = np.unique(np.stack([np.concatenate([ea, eb]), np.concatenate([eb, ea])], 1), axis=0)
    neighbors: dict[int, set] = {c: set() for c in range(ncomp)}
    for u, v in edges:
        neighbors[int(u)].add(int(v))

    mapping = np.arange(ncomp)

    def find(c):
        while mapping[c] != c:
            mapping[c] = mapping[mapping[c]]
            c = mapping[c]
        return c

    pair_dist = _pair_distances(metric, means)
    # neighbour sets follow the merges (root → set of neighbour roots),
    # which keeps the pass near-linear on fragmented label maps
    for c in range(ncomp):  # raster order of first pixels
        cur = find(c)
        if sizes[cur] >= min_area:
            continue
        nbrs = {find(v) for v in neighbors[cur]} - {cur}
        if not nbrs:
            continue  # the reference prints "Failed to extract neighbors." (:435-438)
        order = np.array(sorted(nbrs))
        # the first minimum: ties go to the lowest id
        best = int(order[np.argmin(pair_dist(np.full(len(order), cur), order))])
        mapping[cur] = best
        neighbors[best] |= nbrs - {best}
        neighbors[cur] = set()

    final = np.array([find(c) for c in range(ncomp)])
    return _compact(final, comp)


# ---------------------------------------------------------------------------
# connectivity (device)
# ---------------------------------------------------------------------------

def connectivity_device(labels: torch.Tensor, lab: torch.Tensor, sp_size: int,
                        impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """The euclidean connectivity pass on the labels' device: (H, W) int32
    k-means labels + (H, W, 3) u8 Lab → ((H, W) int32 region ids, equal to
    ``enforce_connectivity``'s, and a (16,) int32 header whose first slots
    are ``ops/cuda/connectivity.py``'s ``HEADER``: components, small ones,
    clusters, the largest cluster's members, regions and list entries; the
    kernels' own counters after), both on that device.

    ``impl``: ``"cuda"`` the kernels (a CUDA tensor only, nothing read back),
    ``"torch"`` the plain twin on any device, ``"auto"`` the kernels for a
    CUDA tensor.  A call adds its host time to ``connectivity_ns`` and one
    to ``connectivity_calls``; on the kernels one to
    ``device_connectivity_calls`` too (the library's first build comes
    before the clock starts)."""
    global connectivity_ns, connectivity_calls, device_connectivity_calls
    check_impl(impl)
    if labels.ndim != 2 or tuple(lab.shape) != (*labels.shape, 3):
        raise ValueError(f"labels {tuple(labels.shape)} and Lab {tuple(lab.shape)} must be "
                         f"(H, W) and (H, W, 3)")
    min_area = (sp_size * sp_size) // 20
    cuda = resolve_impl(impl, labels) == "cuda"
    if cuda:
        from ..ops.cuda import _build
        from ..ops.cuda import connectivity as kcc
        _build.load_library()
    start = perf_counter_ns()
    if cuda:
        out = kcc.connectivity(labels.contiguous(), lab.contiguous(), min_area)
    else:
        out = _connectivity_plain(labels, lab, min_area)
    connectivity_ns += perf_counter_ns() - start
    connectivity_calls += 1
    device_connectivity_calls += cuda
    return out


def _hook(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """The least index of each node's component in the graph of edges (a,
    b) over n nodes: hook the larger root of every edge under the smaller,
    jump pointers to their roots, until nothing changes."""
    parent = torch.arange(n, device=a.device)
    while True:
        ra, rb = parent[a], parent[b]
        hooked = parent.clone()
        hooked.scatter_reduce_(0, torch.maximum(ra, rb), torch.minimum(ra, rb), "amin")
        while True:
            jumped = hooked[hooked]
            if torch.equal(jumped, hooked):
                break
            hooked = jumped
        if torch.equal(hooked, parent):
            return parent
        parent = hooked


def _connectivity_plain(labels: torch.Tensor, lab: torch.Tensor,
                        min_area: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the kernels, stage by stage in torch ops on the
    labels' device, the merge a Python loop over the clusters (each
    cluster's members in ascending id, the sequential rule)."""
    h, w = labels.shape
    dev = labels.device
    # components: numbered by their least (first) pixel
    idx = torch.arange(h * w, device=dev).view(h, w)
    across = labels[:, 1:] == labels[:, :-1]
    down = labels[1:, :] == labels[:-1, :]
    root = _hook(torch.cat([idx[:, :-1][across], idx[:-1, :][down]]),
                 torch.cat([idx[:, 1:][across], idx[1:, :][down]]), h * w)
    is_root = root == torch.arange(h * w, device=dev)
    rank = torch.cumsum(is_root, 0) - 1
    comp = rank[root].view(h, w)
    ncomp = int(is_root.sum())
    # sizes and truncated means, exact integers
    flat = comp.reshape(-1)
    sizes = torch.bincount(flat, minlength=ncomp)
    sums = torch.zeros((ncomp, 3), dtype=torch.int64, device=dev)
    sums.index_add_(0, flat, lab.reshape(-1, 3).to(torch.int64))
    means = sums // sizes[:, None]
    small = sizes < min_area
    # neighbours of the small components, and their clusters
    u = torch.cat([comp[:, :-1].reshape(-1), comp[:-1, :].reshape(-1)])
    v = torch.cat([comp[:, 1:].reshape(-1), comp[1:, :].reshape(-1)])
    differ = u != v
    pairs = torch.unique(torch.stack([torch.cat([u[differ], v[differ]]),
                                      torch.cat([v[differ], u[differ]])], 1), dim=0)
    pairs = pairs[small[pairs[:, 0]]]
    both = pairs[small[pairs[:, 1]]]
    cluster = _hook(both[:, 0], both[:, 1], ncomp)
    nsmall = int(small.sum())
    members = torch.nonzero(small).reshape(-1)
    roots, count = torch.unique(cluster[members], return_counts=True)
    # the merge, one cluster at a time
    means_h = means.cpu().tolist()
    neighbours: dict[int, list[int]] = {}
    for a, b in pairs.cpu().tolist():
        neighbours.setdefault(a, []).append(b)
    by_cluster: dict[int, list[int]] = {}
    for c, k in zip(members.cpu().tolist(), cluster[members].cpu().tolist()):
        by_cluster.setdefault(k, []).append(c)
    small_h = set(members.cpu().tolist())
    parent: dict[int, int] = {}

    def find(c: int) -> int:
        while c in parent:
            c = parent[c]
        return c

    def distance(c1: int, c2: int) -> float:
        m1, m2 = means_h[c1], means_h[c2]
        dl = float(m1[0] - m2[0]) * 2.55
        da = float(m1[1] - m2[1])
        db = float(m1[2] - m2[2])
        return dl * dl + da * da + db * db

    for cluster_members in by_cluster.values():
        pending: dict[int, set[int]] = {}
        for c in cluster_members:  # ascending: c is its own root at its turn
            near = {find(x) for x in neighbours.get(c, ())} | {find(x) for x in
                                                                 pending.pop(c, ())}
            near.discard(c)
            if not near:
                continue  # the reference prints "Failed to extract neighbors." (:435-438)
            best = min(near, key=lambda r: (distance(c, r), r))
            parent[c] = best
            if best in small_h:  # its turn is still to come
                pending.setdefault(best, set()).update(near - {best})
    # regions: each numbered by the rank of its least member
    region_root = torch.tensor([find(c) for c in range(ncomp)], dtype=torch.int64, device=dev)
    least = torch.full((ncomp,), ncomp, dtype=torch.int64, device=dev)
    least.scatter_reduce_(0, region_root, torch.arange(ncomp, device=dev), "amin")
    first = least[region_root] == torch.arange(ncomp, device=dev)
    region_rank = torch.cumsum(first, 0) - 1
    out = region_rank[least[region_root]][comp].to(torch.int32)
    header = torch.zeros(16, dtype=torch.int32, device=dev)
    header[:6] = torch.tensor([ncomp, nsmall, len(roots), int(count.max()) if len(count) else 0,
                               int(first.sum()), int((2 * sizes[small] + 2).sum())],
                              dtype=torch.int32)
    return out, header


def _download(labels: torch.Tensor, lab: torch.Tensor, drift: torch.Tensor):
    """Raw labels, Lab image and drift to the host in ONE device→host copy,
    for one image (drift 0-d → a float) or a batch (labels (B, H, W), Lab
    (B, H, W, 3), drift (B,) → a (B,) array).  After a kernel-route call the
    copy carries the iterations each image ran too, whose sum is added to
    ``iterations``: what one call an image would add."""
    global device_iterations, iterations
    parts = [labels.reshape(-1).view(torch.uint8), lab.reshape(-1),
             drift.reshape(-1).view(torch.uint8)]
    ran, device_iterations = device_iterations, None
    if ran is not None:  # a column of the state: strided for a batch
        parts.append(ran.reshape(-1).contiguous().view(torch.uint8))
    host = _host(torch.cat(parts))
    n, end = labels.numel(), 7 * labels.numel() + 4 * drift.numel()
    if ran is not None:
        iterations += int(host[end:].view(np.int32).sum())
    drifts = host[7 * n:end].view(np.float32)
    return (host[:4 * n].view(np.int32).reshape(labels.shape),
            host[4 * n:7 * n].reshape(lab.shape),
            float(drifts[0]) if drift.ndim == 0 else drifts.reshape(drift.shape))


def check_params(superpixel_size: int, metric: str) -> None:
    if superpixel_size < 2:
        raise ValueError("superpixel_size must be >= 2")
    if metric not in METRICS:
        raise ValueError(f"unknown SLIC metric {metric!r}")


class SuperpixelSLIC:
    """Counterpart of the reference class (include/cpp/slic.hpp:114) and of
    the JAX package's ``SuperpixelSLIC``: takes (height, width) directly (the
    reference's constructor and wrapper swap them twice).  Lab and the
    k-means run on ``device`` (the GPU unless the caller passes
    ``device="cpu"``; on the GPU the k-means runs on the kernels,
    ``slic_device``'s ``"auto"``); the connectivity pass runs on the card
    for the euclidean metric on the GPU (``connectivity_device``), else on
    the host; ``apply`` returns the final int32 labels as a tensor on
    ``device``, with one device→host read a call on the kernel route."""

    def __init__(self, height: int, width: int, superpixel_size: int = 30,
                 num_iteration: int = 10, color_scale: float = 20.0,
                 metric: str = "euclidean", device="cuda"):
        check_params(superpixel_size, metric)
        self.height = int(height)
        self.width = int(width)
        self.superpixel_size = int(superpixel_size)
        self.num_iteration = int(num_iteration)
        self.color_scale = float(color_scale)
        self.metric = metric
        # a concrete device (cuda:0, not cuda), comparable with a tensor's
        self.device = torch.empty(0, device=_validate.check_device(device)).device
        self._labels = None
        self.last_max_drift_cells: float | None = None

    def apply(self, image_bgr_u8) -> torch.Tensor:
        image = _validate.as_tensor(image_bgr_u8, self.device)
        if tuple(image.shape[:2]) != (self.height, self.width):
            raise ValueError(f"image shape {tuple(image.shape[:2])} does not match "
                             f"({self.height}, {self.width})")
        _validate.check_u8_color("image", image)
        if image.device != self.device:
            raise ValueError(f"image on {image.device}, SLIC on {self.device}")
        lab = bgr2lab_u8_exact(image.contiguous())
        labels, _, _, drift = slic_device(lab, self.height, self.width, self.superpixel_size,
                                          self.num_iteration, self.color_scale, self.metric)
        if image.is_cuda and self.metric == "euclidean":
            return self._apply_device(labels, lab, drift)
        s = SPANS.open("models.slic.download") if SPANS.on else -1
        raw, lab_host, self.last_max_drift_cells = _download(labels, lab, drift)
        if s >= 0:
            SPANS.close(s)
        s = SPANS.open("models.slic.connectivity") if SPANS.on else -1
        final = enforce_connectivity(raw, lab_host, self.superpixel_size, self.metric)
        if s >= 0:
            SPANS.close(s)
        s = SPANS.open("models.slic.upload") if SPANS.on else -1
        self._labels = torch.from_numpy(final).to(self.device)
        if s >= 0:
            SPANS.close(s)
        return self._labels

    def _apply_device(self, labels: torch.Tensor, lab: torch.Tensor,
                      drift: torch.Tensor) -> torch.Tensor:
        """The connectivity pass on the card, then the call's one read: the
        drift, the iterations the k-means ran and the pass's header."""
        global iterations, device_iterations, small_components, merge_clusters
        global largest_merge_cluster
        s = SPANS.open("models.slic.connectivity") if SPANS.on else -1
        final, header = connectivity_device(labels, lab, self.superpixel_size, "cuda")
        if s >= 0:
            SPANS.close(s)
        s = SPANS.open("models.slic.download") if SPANS.on else -1
        ran, device_iterations = device_iterations, None
        host = _host(torch.cat([drift.reshape(1).view(torch.int32), ran.reshape(1),
                                header[:6]]))
        if s >= 0:
            SPANS.close(s)
        self.last_max_drift_cells = float(host[:1].view(np.float32)[0])
        iterations += int(host[1])
        small_components += int(host[3])
        merge_clusters += int(host[4])
        largest_merge_cluster = max(largest_merge_cluster, int(host[5]))
        self._labels = final
        return final

    def get_label(self) -> torch.Tensor:
        if self._labels is None:
            raise RuntimeError("apply() has not been called")
        return self._labels
