"""The Wexler diffusion start's formulation on the card (csrc/wexler_fill.cu,
``wexler_diffusion_kernel``) on the CPU.

The kernel runs only on the card.  Here a NumPy f32 twin of its strip
decomposition: each channel's box split into row strips, one a CTA of a
thread-block cluster (min(bh, 16) of them); each strip holds two copies of
its rows with a halo row above and below where a neighbouring strip lies;
the box's mean from the strips' partial sums; each sweep computes a strip's
hole pixels from its own copy alone (the nine terms in (dy, dx) order,
clamped at the box's edges) and writes its edge rows' new values into the
neighbours' halo rows of the other copy, as the kernel does through
distributed shared memory before the cluster barrier; then the dither and
the clamp.  The twin is held bit-equal to the plain version,
``models/inpainting.py::_alt_init_device(..., impl="torch")``, with the
dither off and on, on boxes from 1x1 to 128x128 (one row, one column, a box
with fewer rows than 16 strips, a box at the image border), and with every
strip count from 1 to 16 the box's rows allow."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small planes: threads cost more than they give

from various_image_processings_tpu_torch.models import inpainting as W  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import wexler_fill as kfill  # noqa: E402

F32 = np.float32
NINTH = F32(1.0 / 9.0)
MAX_CLUSTER = 16                 # the kernel's kMaxCluster
THREADS = 1024                   # its kDiffuseThreads
MAX_OWNED = 64                   # its kMaxOwned: a thread's hole mask


def strips_of(bh, bw, cluster=None):
    """The kernel's strips_of: (cluster, rows_max, halos, tx, ty, cols, rows,
    smem bytes)."""
    cluster = min(bh, MAX_CLUSTER) if cluster is None else cluster
    rows_max = -(-bh // cluster)
    halos = min(cluster - 1, 2)
    tx = 1
    while tx < bw and tx < THREADS:
        tx *= 2
    ty = THREADS // tx
    return cluster, rows_max, halos, tx, ty, -(-bw // tx), -(-rows_max // ty), \
        2 * (rows_max + halos) * bw * 4


def strip_diffusion(src, rem0, box, dither, cluster=None):
    """The kernel's diffusion start on (H, W, 3) u8 ``src`` and (H, W) f32
    ``rem0`` → (H, W, 3) u8: a copy of src with the box's hole pixels
    written."""
    bh, bw, by0, bx0 = box
    nc = strips_of(bh, bw, cluster)[0]
    out = src.copy()
    for c in range(3):
        plane = src[by0:by0 + bh, bx0:bx0 + bw, c].astype(F32)
        rem = rem0[by0:by0 + bh, bx0:bx0 + bw]
        strips = []
        for rank in range(nc):
            r0, r1 = rank * bh // nc, (rank + 1) * bh // nc
            assert r1 > r0  # every strip has a row
            top, bottom = int(rank > 0), int(rank < nc - 1)
            copies = np.zeros((2, top + (r1 - r0) + bottom, bw), F32)
            copies[:, top:top + r1 - r0] = plane[r0:r1]
            strips.append({"r0": r0, "rows": r1 - r0, "top": top, "bottom": bottom,
                           "copies": copies, "hole": rem[r0:r1] > 0})
        # the box's mean of its known pixels: the strips' partial sums
        parts = [(np.sum(plane[s["r0"]:s["r0"] + s["rows"]]
                         * (F32(1) - rem[s["r0"]:s["r0"] + s["rows"]]), dtype=F32),
                  np.sum(F32(1) - rem[s["r0"]:s["r0"] + s["rows"]], dtype=F32)) for s in strips]
        total = np.sum([p[0] for p in parts], dtype=F32)
        known = np.sum([p[1] for p in parts], dtype=F32)
        mean = F32(total / max(known, F32(1)))

        def send(rank, copy, row):
            """Strip ``rank``'s row ``row`` of ``copy``, written into its
            neighbours' halo rows of that copy (where it feeds them)."""
            s = strips[rank]
            vals = s["copies"][copy, s["top"] + row]
            if row == 0 and s["top"]:
                up = strips[rank - 1]
                hole = s["hole"][0]
                up["copies"][copy, up["top"] + up["rows"]][hole] = vals[hole]
            if row == s["rows"] - 1 and s["bottom"]:
                down = strips[rank + 1]
                hole = s["hole"][row]
                down["copies"][copy, 0][hole] = vals[hole]

        for rank, s in enumerate(strips):  # the start, both copies of the halos
            own = s["copies"][0, s["top"]:s["top"] + s["rows"]]
            own[s["hole"]] = mean
            for copy in (0, 1):
                if s["top"]:
                    strips[rank - 1]["copies"][copy, strips[rank - 1]["top"]
                                               + strips[rank - 1]["rows"]] = own[0]
                if s["bottom"]:
                    strips[rank + 1]["copies"][copy, 0] = own[-1]
        xs = np.arange(bw)
        xl, xr = np.maximum(xs - 1, 0), np.minimum(xs + 1, bw - 1)
        for sweep in range(bh + bw):
            frm, to = sweep & 1, 1 - (sweep & 1)
            for s in strips:
                cur = s["copies"][frm]
                lr = np.arange(s["rows"])
                rm = lr + s["top"]
                ru = np.where((lr == 0) & (s["top"] == 0), rm, rm - 1)
                rd = np.where((lr == s["rows"] - 1) & (s["bottom"] == 0), rm, rm + 1)
                acc = np.zeros((s["rows"], bw), F32)
                for rows in (ru, rm, rd):
                    for cols in (xl, xs, xr):
                        acc = acc + cur[rows][:, cols]
                new = s["copies"][to, s["top"]:s["top"] + s["rows"]]
                new[s["hole"]] = (acc * NINTH)[s["hole"]]
            for rank, s in enumerate(strips):  # the edge rows, before the barrier
                send(rank, to, 0)
                send(rank, to, s["rows"] - 1)
        final = (bh + bw) & 1
        for s in strips:
            v = s["copies"][final, s["top"]:s["top"] + s["rows"]].copy()
            if dither:
                gy = (by0 + s["r0"] + np.arange(s["rows"]))[:, None].astype(np.uint32)
                gx = (bx0 + np.arange(bw))[None, :].astype(np.uint32)
                with np.errstate(over="ignore"):
                    h = (gy * np.uint32(92837111)) ^ (gx * np.uint32(689287499))
                v = v + (((h >> 8) % 25).astype(np.int32) - 12).astype(F32)
            v = np.clip(v, F32(0), F32(255)).astype(np.uint8)
            rows = slice(by0 + s["r0"], by0 + s["r0"] + s["rows"])
            region = out[rows, bx0:bx0 + bw, c]
            region[s["hole"]] = v[s["hole"]]
    return out


# (image h, w, box (bh, bw, by0, bx0)): 1x1, a row, a column, small and
# the coarsest 5a level's shapes, the largest box, a box with fewer rows than
# 16 strips, a box at the image border; the last two give a thread more
# than one pixel (the kernel's general sweep; the others take one a thread)
BOXES = [
    ("1x1", 9, 9, (1, 1, 4, 4)),
    ("1x128", 20, 140, (1, 128, 7, 5)),
    ("128x1", 140, 20, (128, 1, 5, 7)),
    ("7x13", 30, 40, (7, 13, 11, 17)),
    ("50x87", 64, 100, (50, 87, 6, 8)),
    ("128x128", 150, 160, (128, 128, 10, 20)),
    ("5x200 (fewer rows than 16 strips)", 20, 220, (5, 200, 6, 9)),
    ("border", 60, 70, (20, 33, 0, 37)),
    ("100x150 (two rows a thread)", 110, 160, (100, 150, 4, 5)),
    ("2x1030 (two columns a thread)", 6, 1040, (2, 1030, 2, 6)),
]


def case(h, w, box, seed=0):
    """A random u8 image and a hole that fills most of the box, with known
    pixels inside it (a hole-free column and a few islands)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    bh, bw, by0, bx0 = box
    hole = np.zeros((h, w), bool)
    hole[by0:by0 + bh, bx0:bx0 + bw] = rng.random((bh, bw)) < 0.85
    if bw > 4:
        hole[by0:by0 + bh, bx0 + bw // 3] = False
    hole[by0, bx0] = True
    return src, hole.astype(F32)


def plain(src, rem0, box, dither):
    bh, bw, by0, bx0 = box
    h, w = rem0.shape
    return W._alt_init_device(torch.from_numpy(src), torch.from_numpy(rem0), h, w, (bh, bw),
                              (by0, bx0), dither, impl="torch").numpy()


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("label,h,w,box", BOXES, ids=[b[0] for b in BOXES])
def test_strips_equal_the_plain_diffusion(label, h, w, box, dither):
    src, rem0 = case(h, w, box)
    np.testing.assert_array_equal(strip_diffusion(src, rem0, box, dither),
                                  plain(src, rem0, box, dither))


@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8, 13, 16])
def test_every_strip_count_gives_the_same_bits(cluster):
    """Strips of 1 to 16 CTAs over a 50x87 box (the twin with the cluster
    forced; the kernel takes min(bh, 16)): the halo exchange makes the split
    invisible."""
    h, w, box = 64, 100, (50, 87, 6, 8)
    src, rem0 = case(h, w, box, seed=cluster)
    np.testing.assert_array_equal(strip_diffusion(src, rem0, box, True, cluster),
                                  plain(src, rem0, box, True))


def test_an_all_hole_box_takes_mean_zero():
    """No known pixel in the box: the mean divides by max(0, 1)."""
    h, w, box = 12, 14, (6, 9, 3, 2)
    src = np.random.default_rng(3).integers(0, 256, (h, w, 3), dtype=np.uint8)
    rem0 = np.zeros((h, w), F32)
    rem0[3:9, 2:11] = 1.0
    np.testing.assert_array_equal(strip_diffusion(src, rem0, box, False),
                                  plain(src, rem0, box, False))


def test_launch_shapes_fit_the_kernel():
    """Every box the wrapper takes (bh * bw <= MAX_DIFFUSION_PIXELS) gets a
    cluster of min(bh, 16) strips, at most 64 pixels a thread (the hole
    mask's bits) and at most 128 KB of shared memory a CTA (the attribute
    the kernel sets once)."""
    limit = kfill.MAX_DIFFUSION_PIXELS
    for bh in range(1, limit + 1):
        for bw in {1, 2, 3, 5, 17, 33, 129, 257, limit // bh, max(1, limit // bh - 1)}:
            if bw < 1 or bh * bw > limit:
                continue
            cluster, _, _, _, _, cols, rows, smem = strips_of(bh, bw)
            assert cluster == min(bh, MAX_CLUSTER)
            assert rows * cols <= MAX_OWNED, (bh, bw)
            assert smem <= 2 * limit * 4, (bh, bw)
    assert strips_of(128, 128)[0] == 16 and strips_of(128, 128)[7] == 2 * 10 * 128 * 4
    one_each = [label for label, _, _, (bh, bw, _, _) in BOXES
                if strips_of(bh, bw)[5:7] == (1, 1)]
    assert len(one_each) == len(BOXES) - 2  # two boxes run the general sweep
