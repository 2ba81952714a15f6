"""Plain reference of SLIC superpixels as the reference's ``SuperpixelSLIC``
computes them (include/cpp/slic.hpp:114-480) with its one distance, the
euclidean (:8-13, fixed at :138), written out here in plain torch and NumPy
so that the yardstick does not move with the program:

- Lab: OpenCV's fixed-point 8-bit BGR→Lab (cv::cvtColor, :166): integer
  tables of the sRGB gamma and the cube root, 12-bit XYZ coefficients over
  the D65 white point, rounding shifts.
- Seeds (:165-223): one center a cell of S × S pixels, at the cell's middle,
  with the Lab color of the pixel of its 3×3 window (the middle first, then
  in raster order, coordinates clamped) whose Laplacian (4-neighbour, summed
  over the channels, reflect-101 borders: cv::Laplacian with ksize 1) is the
  least; the position stays at the middle.
- Association (:236-281): the centers in id order, each scanning the pixels
  with |x − cx| ≤ S and |y − cy| ≤ S around where it is now, against a
  distance map that persists across iterations; a strictly smaller distance
  takes the pixel.  Distance = (dx² + dy²) · f32(1/S²) + color · f32(1/m²),
  color = ((dl² + da²) + db²) with dl = (l_c − l_p) · 2.55, every product and
  sum rounded on its own.  At its own turn a center adds to its sums every
  pixel of its window labelled with it.
- Update (:283-306): a center with pixels summed takes the mean floor(f32(sum)
  / f32(count)); every center moves to the first pixel in raster order, of
  those labelled with it, whose floor(color distance to the mean) is the
  least, and takes that pixel's color.  One with no pixel stays.
- The next iteration runs only if a pixel's distance fell (:143-147).
- Connectivity (:386-458): 4-connected components of the labels, numbered
  by their first pixel in raster order; in that order each component of
  fewer than S²/20 pixels merges into the neighbouring region whose root
  component's truncated mean Lab color is nearest (double arithmetic, ties
  to the lowest id; sizes and means are the components' own, never summed
  over a merge); then the regions are numbered by their first pixel.

The association takes, for each pixel, the centers whose home cell lies
within 1 + D cells of the pixel's (D: the centers' largest distance, in
cells, from their home cells at this iteration), in id order: every center
whose window can hold the pixel, whatever the drift.

``dtype`` computes the distances and keeps the distance map in that
precision: the control of the benchmark's check.
"""

import math

import numpy as np
import torch

# OpenCV's fixed-point Lab (modules/imgproc/src/color_lab.cpp)
GAMMA_SHIFT = 3
LAB_SHIFT = 12
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
SRGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
D65 = (0.950456, 1.0, 1.088754)
NO_KEY = torch.iinfo(torch.int64).max


def lab_tables():
    """(sRGB gamma table (256,), cube-root table (3072,), XYZ coefficients
    (3, 3) over RGB), int64, as OpenCV's initLabTabs builds them: float32
    values rounded half to even."""
    f32 = np.float32
    x = np.arange(256, dtype=f32) * f32(1.0 / 255.0)
    linear = np.where(x <= f32(0.04045), x / f32(12.92),
                      np.power((x + f32(0.055)) / f32(1.055), f32(2.4), dtype=f32))
    gamma = np.rint(f32(255.0 * (1 << GAMMA_SHIFT)) * linear)
    t = np.arange(256 * 3 // 2 * (1 << GAMMA_SHIFT), dtype=f32) * f32(
        1.0 / (255.0 * (1 << GAMMA_SHIFT)))
    f = np.where(t < f32(0.008856), t * f32(7.787) + f32(16.0 / 116.0), np.cbrt(t, dtype=f32))
    cbrt = np.rint(f32(1 << LAB_SHIFT2) * f)
    coeffs = np.rint(np.array(SRGB_TO_XYZ) * (1 << LAB_SHIFT) / np.array(D65)[:, None])
    return gamma.astype(np.int64), cbrt.astype(np.int64), coeffs.astype(np.int64)


def _descale(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v + (1 << (n - 1))) >> n


def bgr_to_lab(frame: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) u8 BGR → (H, W, 3) int64 Lab codes (0..255), on its device."""
    gamma, cbrt, coeffs = (torch.from_numpy(t).to(frame.device) for t in lab_tables())
    bgr = frame.to(torch.int64)
    b, g, r = gamma[bgr[..., 0]], gamma[bgr[..., 1]], gamma[bgr[..., 2]]
    fx, fy, fz = (cbrt[_descale(r * coeffs[k, 0] + g * coeffs[k, 1] + b * coeffs[k, 2],
                                LAB_SHIFT)] for k in range(3))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)
    light = _descale(l_scale * fy + l_shift, LAB_SHIFT2)
    a = _descale(500 * (fx - fy) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    bb = _descale(200 * (fy - fz) + 128 * (1 << LAB_SHIFT2), LAB_SHIFT2)
    return torch.stack([light, a, bb], dim=-1).clamp(0, 255)


def _reflect101(n: int) -> torch.Tensor:
    """Indices of 0..n-1 padded by one on each side, mirrored without the edge."""
    return torch.tensor([1 if n > 1 else 0, *range(n), n - 2 if n > 1 else 0])


def seeds(lab: torch.Tensor, s: int):
    """The grid seeds → (x (N,), y (N,), Lab (N, 3)), int64, N = ⌈H/S⌉·⌈W/S⌉
    in raster order of the cells."""
    h, w, _ = lab.shape
    dev = lab.device
    gy, gx = torch.arange(math.ceil(h / s), device=dev), torch.arange(math.ceil(w / s),
                                                                       device=dev)
    my = (gy * s + torch.clamp(gy * s + s - 1, max=h - 1)) // 2
    mx = (gx * s + torch.clamp(gx * s + s - 1, max=w - 1)) // 2
    y, x = torch.meshgrid(my, mx, indexing="ij")
    y, x = y.reshape(-1), x.reshape(-1)
    p = lab[_reflect101(h).to(dev)][:, _reflect101(w).to(dev)]
    laplacian = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4 * lab).sum(-1)
    window = [(0, 0)] + [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    ys = torch.stack([torch.clamp(y + dy, 0, h - 1) for dy, _ in window])
    xs = torch.stack([torch.clamp(x + dx, 0, w - 1) for _, dx in window])
    first = torch.argmin(laplacian[ys, xs], dim=0)  # the first least
    pick = torch.arange(len(y), device=dev)
    return x, y, lab[ys[first, pick], xs[first, pick]]


def color_distance(l1, a1, b1, l2, a2, b2):
    """The reference's euclidean_distance: L weighted 2.55, each op rounded."""
    dl = (l1 - l2) * 2.55
    da = a1 - a2
    db = b1 - b2
    return dl * dl + da * da + db * db


def kmeans(lab: torch.Tensor, s: int, num_iteration: int, color_scale: float,
           dtype: torch.dtype) -> torch.Tensor:
    """The labels (H, W) int64 after the iterations, every pixel labelled."""
    h, w, _ = lab.shape
    dev = lab.device
    per_col, per_row = math.ceil(h / s), math.ceil(w / s)
    n = per_col * per_row
    space_norm = float(np.float32(1.0) / np.float32(s * s))
    color_norm = float(np.float32(1.0) / np.float32(color_scale * color_scale))
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    pixel = [lab[..., k].to(dtype) for k in range(3)]
    fields = torch.stack([xs.expand(h, w), ys.expand(h, w), lab[..., 0], lab[..., 1],
                          lab[..., 2], torch.ones((h, w), dtype=torch.int64, device=dev)], -1)
    home_x = torch.arange(n, device=dev) % per_row
    home_y = torch.arange(n, device=dev) // per_row
    cx, cy, color = seeds(lab, s)
    labels = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    dists = torch.full((h, w), math.inf, dtype=dtype, device=dev)
    for it in range(num_iteration):
        drift = int(torch.maximum((cx // s - home_x).abs(), (cy // s - home_y).abs()).max())
        reach = 1 + drift
        run_l, run_d = labels.clone(), dists.clone()
        sums = torch.zeros((n, 6), dtype=torch.int64, device=dev)
        cc = color.to(dtype)
        for dy in range(-reach, reach + 1):  # candidates in ascending id
            cell_y = ys // s + dy
            for dx in range(-reach, reach + 1):
                cell_x = xs // s + dx
                inside = (cell_y >= 0) & (cell_y < per_col) & (cell_x >= 0) & (cell_x < per_row)
                c = (cell_y.clamp(0, per_col - 1) * per_row + cell_x.clamp(0, per_row - 1))
                ox, oy = xs - cx[c], ys - cy[c]
                scanned = inside & (ox.abs() <= s) & (oy.abs() <= s)
                if not bool(scanned.any()):
                    continue
                fx, fy = ox.to(dtype), oy.to(dtype)
                d = space_norm * (fx * fx + fy * fy) + color_norm * color_distance(
                    cc[c, 0], cc[c, 1], cc[c, 2], *pixel)
                d = torch.where(scanned, d, math.inf)
                better = d < run_d
                run_d = torch.where(better, d, run_d)
                run_l = torch.where(better, c, run_l)
                member = scanned & (run_l == c)
                sums.index_add_(0, c.expand(h, w)[member], fields[member])
        changed = bool((run_d < dists).any())
        labels, dists = run_l, run_d

        count = sums[:, 5]
        quotient = sums[:, 2:5].to(torch.float32) / count.clamp_min(1).to(torch.float32)[:, None]
        mean = torch.where((count > 0)[:, None], torch.floor(quotient), color.to(torch.float32))
        m = mean.to(dtype)[labels]
        key = torch.floor(color_distance(m[..., 0], m[..., 1], m[..., 2], *pixel))
        raster = ys * w + xs
        packed = key.to(torch.int64) * (1 << 32) + raster
        best = torch.full((n,), NO_KEY, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, labels.reshape(-1), packed.reshape(-1), "amin")
        has = best < NO_KEY
        first = torch.where(has, best & 0xFFFFFFFF, 0)
        cx = torch.where(has, first % w, cx)
        cy = torch.where(has, first // w, cy)
        color = torch.where(has[:, None], lab.reshape(-1, 3)[first], color)
        if not changed:
            break
    return labels


def components(labels: torch.Tensor) -> torch.Tensor:
    """The 4-connected components of equal labels → (H, W) int64 ids, numbered
    by their first pixel in raster order.  Each pixel points at a pixel of
    its component no later than itself; equal-label neighbours hook the
    later of their roots to the earlier, then the pointers are followed to
    their roots, until nothing changes: every root is its component's first
    pixel."""
    h, w = labels.shape
    idx = torch.arange(h * w, device=labels.device).view(h, w)
    across = labels[:, 1:] == labels[:, :-1]
    down = labels[1:, :] == labels[:-1, :]
    a = torch.cat([idx[:, :-1][across], idx[:-1, :][down]])
    b = torch.cat([idx[:, 1:][across], idx[1:, :][down]])
    parent = idx.reshape(-1).clone()
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
            break
        parent = hooked
    return torch.unique(parent, return_inverse=True)[1].view(h, w)


def connectivity(labels: torch.Tensor, lab: torch.Tensor, s: int) -> torch.Tensor:
    """The connectivity pass → (H, W) int64 region ids in raster order."""
    comp = components(labels)
    flat = comp.reshape(-1)
    ncomp = int(flat.max()) + 1
    sizes = torch.bincount(flat, minlength=ncomp)
    sums = torch.zeros((ncomp, 3), dtype=torch.int64, device=comp.device)
    sums.index_add_(0, flat, lab.reshape(-1, 3))
    means = (sums // sizes[:, None]).cpu().numpy()
    small = sizes < (s * s) // 20
    # edges between different components with a small one at either end
    pairs = []
    for u, v in ((comp[:, :-1], comp[:, 1:]), (comp[:-1, :], comp[1:, :])):
        keep = (u != v) & (small[u] | small[v])
        pairs += [torch.stack([u[keep], v[keep]], 1), torch.stack([v[keep], u[keep]], 1)]
    edges = torch.unique(torch.cat(pairs), dim=0).cpu().numpy()
    small = small.cpu().numpy()
    neighbours = {int(c): set() for c in np.flatnonzero(small)}
    for u, v in edges[small[edges[:, 0]]]:
        neighbours[int(u)].add(int(v))

    root = list(range(ncomp))

    def find(c: int) -> int:
        while root[c] != c:
            root[c] = root[root[c]]
            c = root[c]
        return c

    def distance(c1: int, c2: int) -> float:
        dl = float(means[c1, 0] - means[c2, 0]) * 2.55
        da = float(means[c1, 1] - means[c2, 1])
        db = float(means[c1, 2] - means[c2, 2])
        return dl * dl + da * da + db * db

    for c in sorted(neighbours):  # raster order; a small component is its own root at its turn
        near = {find(v) for v in neighbours[c]} - {c}
        if not near:
            continue  # the reference prints "Failed to extract neighbors." (:435-438)
        best = min(near, key=lambda r: (distance(c, r), r))
        root[c] = best
        if best in neighbours and best > c:  # its turn is still to come
            neighbours[best] |= near - {best}
    roots = np.array([find(c) for c in range(ncomp)])
    _, first, inverse = np.unique(roots, return_index=True, return_inverse=True)
    region = np.argsort(np.argsort(first))[inverse.reshape(-1)]
    return torch.from_numpy(region).to(comp.device)[comp]


def reference(frame: torch.Tensor, superpixel_size: int, num_iteration: int,
              color_scale: float, metric: str,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 3) u8 BGR → (H, W) int32 region labels, on the frame's device."""
    if metric != "euclidean":
        raise ValueError(f"the reference computes the euclidean distance only, got {metric!r}")
    lab = bgr_to_lab(frame)
    labels = kmeans(lab, int(superpixel_size), int(num_iteration), float(color_scale), dtype)
    return connectivity(labels, lab, int(superpixel_size)).to(torch.int32)
