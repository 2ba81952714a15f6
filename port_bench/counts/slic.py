"""Work of the SLIC k-means kernels of one call (csrc/slic_kmeans.cu: the
association, snap-key and update kernels, ``num_iteration`` times), from the
parameters and the frame's shape alone: what ``kernels.slic_kmeans_roofline``
divides by those kernels' device time.  The Lab conversion, the seeds, the
copies and the connectivity pass are not counted.

Each iteration, every input read once and every output written once, as
``chip_smoke.py`` bounds each kernel, with the terms that depend on the frame
taken at their least or at the seeds:

- association: reads Lab, labels and distances (11 B a pixel) and the
  centers (20 B each), adds to the sums (48 B a center).  Labels and
  distances (8 B a pixel) are written where a distance fell: counted in the
  first iteration only, where every pixel takes its first label.  Each
  (pixel, candidate) pair of the 5 × 5 cell neighbourhood on the grid is a
  window test (4 operations), and each pair inside the window, at the
  seeds' positions, a distance (8) and a euclidean colour (8).
- snap keys: reads labels and Lab (7 B a pixel), sums and centers (68 B a
  center), writes keys (8 B a center); a pixel's key is its colour distance
  (8) with its floor and packing (2), a center's mean 12 operations.
- update: reads keys and centers (28 B a center) and the snapped pixel's
  colour (23 B), clears sums and keys (56 B); 6 operations a center.
"""

import math

REACH = 2  # the association's cell neighbourhood: (2 REACH + 1)^2 cells


def _pairs(extent: int, s: int) -> tuple[int, int]:
    """Along one axis of ``extent`` pixels: (pixel-cell pairs with the cell
    on the grid within REACH cells of the pixel's, those whose cell's seed
    lies within S of the pixel)."""
    cells = math.ceil(extent / s)
    seed = [(g * s + min(g * s + s - 1, extent - 1)) // 2 for g in range(cells)]
    on_grid = in_window = 0
    for p in range(extent):
        for g in range(max(0, p // s - REACH), min(cells, p // s + REACH + 1)):
            on_grid += 1
            in_window += abs(p - seed[g]) <= s
    return on_grid, in_window


def kernel_work(s: int, height: int, width: int) -> dict[str, tuple[float, float]]:
    """(operations, bytes) of each kernel in one iteration after the first."""
    p = height * width
    n = math.ceil(height / s) * math.ceil(width / s)
    (grid_y, window_y), (grid_x, window_x) = _pairs(height, s), _pairs(width, s)
    return {"association": (4.0 * grid_y * grid_x + 16.0 * window_y * window_x,
                            11.0 * p + 68.0 * n),
            "snap_keys": (10.0 * p + 12.0 * n, 7.0 * p + 76.0 * n),
            "update": (6.0 * n, 107.0 * n)}


def work(kwargs: dict, height: int, width: int, channels: int) -> tuple[float, float]:
    """(operations, bytes) of one call's k-means kernels."""
    if kwargs["metric"] != "euclidean":
        raise ValueError(f"the count is the euclidean metric's, got {kwargs['metric']!r}")
    per = kernel_work(kwargs["superpixel_size"], height, width).values()
    iterations = kwargs["num_iteration"]
    ops = iterations * sum(o for o, _ in per)
    first_labels = 8.0 * height * width if iterations else 0.0
    return float(ops), float(iterations * sum(b for _, b in per) + first_labels)
