"""The SLIC association kernel's formulation (csrc/slic_kmeans.cu,
``slic_association_kernel``) on the CPU.

The kernel runs only on the card.  Here a NumPy twin written block by block
and warp by warp as the kernel is: 32 x 8 pixel tiles of 8 x 4 warp pieces;
the piece's prefilter (the candidate cells whose window may reach one of its
pixels, from the piece's pixel bounds: a superset of what each lane scans,
asserted); each pixel's window test against its candidates first; for the ΔE
metrics the warp's passing (pixel, candidate) pairs gathered k-major into a
list and their colour distances evaluated over it 32 at a time; then every
pixel's strict-< scan in ascending candidate id with the in-scan
membership; the members summed by the warp per slot in packed 32-bit fields,
by the block relative to its tile's origin in 32-bit accumulators, and added
to the int64 sums with count x origin.  The twin is held bit-equal to the
plain version, ``models/slic.py::_Grid.association``, over the kernel tests'
``CASES`` (images that are not whole cells, S = 2, S past the image, exact
ties, a constant image) with every metric, and with a center that loses
every pixel; the ΔE functions run through ``vector_loop`` on both sides, so
a value's bits do not depend on its place in a CPU vector loop.  The
packing and window bounds the kernel relies on are checked on the way."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one chunk a CPU op: ``vector_loop`` relies on it

from various_image_processings_tpu_torch.core import ciede2000  # noqa: E402
from various_image_processings_tpu_torch.core.pad import cdiv  # noqa: E402
from various_image_processings_tpu_torch.models import slic as P  # noqa: E402
from test_torch_slic_delta_e import FUNCTIONS, vector_loop  # noqa: E402
from test_torch_slic_kernel import CASES, F32, lab_image, twin_color  # noqa: E402

TILE_W, TILE_H = 32, 8          # a block's pixels
PIECE_W, PIECE_H = 8, 4         # a warp's
WINDOW_SLOTS = (TILE_W // 2 + 4) * (TILE_H // 2 + 4)  # kAssocSlots: 20 x 8
CANDIDATES = 25
METRICS = ["euclidean", "ciede2000", "ciede2000_ref"]


def lanes_of(x0, y0, warp):
    """(x, y) of each of a warp's 32 lanes: its 8 x 4 piece of the tile."""
    lane = np.arange(32)
    xr = (warp % (TILE_W // PIECE_W)) * PIECE_W + lane % PIECE_W
    yr = (warp // (TILE_W // PIECE_W)) * PIECE_H + lane // PIECE_W
    return x0 + xr, y0 + yr, xr, yr


def window_of(x0, y0, h, w, s):
    """(wy0, wx0, wh, ww): the tile's window of candidate cells."""
    wy0, wx0 = y0 // s - 2, x0 // s - 2
    wh = (min(y0 + TILE_H, h) - 1) // s + 3 - wy0
    ww = (min(x0 + TILE_W, w) - 1) // s + 3 - wx0
    return wy0, wx0, wh, ww


def piece_candidates(cen, x0, y0, warp, h, w, s, pc, pr, wy0, wx0, ww):
    """(25, 32) bool: candidate k of lane l may scan its pixel, by the
    kernel's prefilter: the piece's cells +- 2 (at most 6 x 8, a 64-bit mask
    of stride 8) whose center is on the grid and has fl(xb - cx) >= -S,
    fl(xa - cx) <= S and the same in y for the piece's pixel bounds
    [xa, xb] x [ya, yb]; a lane's candidates are its 5 x 5 block of that
    mask."""
    _, _, xr, yr = lanes_of(0, 0, warp)
    xa, ya = x0 + xr.min(), y0 + yr.min()
    cand = np.zeros((CANDIDATES, 32), bool)
    if xa >= w or ya >= h:
        return cand
    xb, yb = min(xa + PIECE_W, w) - 1, min(ya + PIECE_H, h) - 1
    cya, cxa = ya // s, xa // s
    uh, uw = yb // s - cya + 5, xb // s - cxa + 5
    assert uh <= 6 and uw <= 8
    i = np.arange(64)
    gy, gx = cya - 2 + i // 8, cxa - 2 + i % 8
    on = (i // 8 < uh) & (i % 8 < uw) & (gy >= 0) & (gy < pc) & (gx >= 0) & (gx < pr)
    slot = np.where(on, (gy - wy0) * ww + (gx - wx0), 0)
    ccx, ccy = cen[slot, 0], cen[slot, 1]
    sf = F32(s)
    near = on & (F32(xb) - ccx >= -sf) & (F32(xa) - ccx <= sf) \
        & (F32(yb) - ccy >= -sf) & (F32(ya) - ccy <= sf)
    x, y = x0 + xr, y0 + yr
    base = (np.minimum(y, h - 1) // s - cya) * 8 + (np.minimum(x, w - 1) // s - cxa)
    for k in range(CANDIDATES):
        cand[k] = near[base + (k // 5) * 8 + k % 5]
    return cand


def pairs_association(lab, centers, labels, dists, s, space_norm, color_norm, metric):
    """The kernel's association, block by block → (labels, dists, changed,
    sums (N, 6) int64, pairs evaluated densely, warp rounds of them, and
    the (warp, candidate) turns with a passing lane: the bodies a warp ran
    when it evaluated each candidate that any of its lanes passes, and the
    (warp, candidate) turns the prefilter leaves to the scan)."""
    h, w = labels.shape
    pc, pr = cdiv(h, s), cdiv(w, s)
    run_l, run_d = labels.copy(), dists.copy()
    sums = np.zeros((pc * pr, 6), np.int64)
    sf = F32(s)
    evaluated = rounds = turns = visited = 0
    for y0 in range(0, h, TILE_H):
        for x0 in range(0, w, TILE_W):
            wy0, wx0, wh, ww = window_of(x0, y0, h, w, s)
            assert wh * ww <= WINDOW_SLOTS
            gy, gx = np.divmod(np.arange(wh * ww), ww)
            gy, gx = gy + wy0, gx + wx0
            on = (gy >= 0) & (gy < pc) & (gx >= 0) & (gx < pr)
            cen = np.where(on[:, None], centers[np.where(on, gy * pr + gx, 0)], F32(0))
            acc = np.zeros((6, wh * ww), np.int64)  # the kernel's u32 sums
            for warp in range(8):
                x, y, xr, yr = lanes_of(x0, y0, warp)
                valid = (x < w) & (y < h)
                xc, yc = np.minimum(x, w - 1), np.minimum(y, h - 1)
                pix = lab[yc, xc].astype(np.int64)
                lf, af, bf = (pix[:, k].astype(F32) for k in range(3))
                cy, cx = y // s, x // s
                own = (cy - wy0) * ww + (cx - wx0)
                cand = piece_candidates(cen, x0, y0, warp, h, w, s, pc, pr, wy0, wx0, ww)
                cand &= valid[None, :]
                visited += int(cand.any(axis=1).sum())
                # the window test, all 25 candidates first
                scan = np.zeros((CANDIDATES, 32), bool)
                slot = np.zeros((CANDIDATES, 32), np.int64)
                ddx = np.zeros((CANDIDATES, 32), F32)
                ddy = np.zeros((CANDIDATES, 32), F32)
                for k in range(CANDIDATES):
                    dy, dx = k // 5 - 2, k % 5 - 2
                    ny, nx = cy + dy, cx + dx
                    ok = valid & (ny >= 0) & (ny < pc) & (nx >= 0) & (nx < pr)
                    slot[k] = np.where(ok, own + dy * ww + dx, 0)
                    assert ((slot[k] >= 0) & (slot[k] < wh * ww))[ok].all()
                    ddx[k] = xc.astype(F32) - cen[slot[k], 0]
                    ddy[k] = yc.astype(F32) - cen[slot[k], 1]
                    scan[k] = ok & (np.abs(ddx[k]) <= sf) & (np.abs(ddy[k]) <= sf)
                assert not (scan & ~cand).any()  # the prefilter drops no candidate that scans
                color = np.zeros((CANDIDATES, 32), F32)
                if metric == "euclidean":  # in place, candidate by candidate
                    for k in range(CANDIDATES):
                        c = cen[slot[k]]
                        color[k] = twin_color(c[:, 2], c[:, 3], c[:, 4], lf, af, bf)
                else:
                    # the k-major pair list, then the distances over it, 32 a round
                    ks, srcs = np.nonzero(scan)  # k-major: the candidates in ascending k
                    for e0 in range(0, len(ks), 32):
                        k, src = ks[e0:e0 + 32], srcs[e0:e0 + 32]
                        c = cen[slot[k, src]]
                        color[k, src] = twin_color(c[:, 2], c[:, 3], c[:, 4], lf[src], af[src],
                                                   bf[src], metric)
                        rounds += 1
                    evaluated += len(ks)
                    turns += int(scan.any(axis=1).sum())
                # the scan in ascending id over the candidates the prefilter
                # leaves (the ΔE kernel: those that scan), and the warp's
                # members of each slot
                for k in np.flatnonzero(cand.any(axis=1)):
                    cid = (cy + k // 5 - 2) * pr + (cx + k % 5 - 2)
                    spatial = ddx[k] * ddx[k] + ddy[k] * ddy[k]
                    d = F32(space_norm) * spatial + F32(color_norm) * color[k]
                    flat = yc * w + xc
                    rl, rd = run_l.reshape(-1)[flat], run_d.reshape(-1)[flat]
                    better = scan[k] & (d < rd)
                    rd = np.where(better, d, rd)
                    rl = np.where(better, cid, rl).astype(np.int32)
                    run_d.reshape(-1)[flat[valid]] = rd[valid]
                    run_l.reshape(-1)[flat[valid]] = rl[valid]
                    member = scan[k] & (rl == cid)
                    for target in np.unique(slot[k][member]):
                        mine = member & (slot[k] == target)
                        sxy = int(np.sum((xr | yr << 11 | 1 << 22)[mine]))
                        sla = int(np.sum((pix[:, 0] | pix[:, 1] << 13)[mine]))
                        sb = int(np.sum(pix[:, 2][mine]))
                        assert sxy < 1 << 32 and sla < 1 << 32
                        fields = (sxy & 0x7FF, sxy >> 11 & 0x7FF, sla & 0x1FFF, sla >> 13, sb,
                                  sxy >> 22)
                        assert fields[0] == xr[mine].sum() and fields[1] == yr[mine].sum()
                        assert fields[2] == pix[mine, 0].sum() and fields[3] == pix[mine, 1].sum()
                        assert fields[5] == mine.sum()
                        acc[:, target] += fields
            assert acc.max() < 1 << 16  # the kernel's 32-bit sums, with room to spare
            members = acc[5]
            for i in np.flatnonzero(members):
                c = (wy0 + i // ww) * pr + (wx0 + i % ww)
                sums[c] += (acc[0, i] + members[i] * x0, acc[1, i] + members[i] * y0,
                            *acc[2:, i])
    return run_l, run_d, bool((run_d < dists).any()), sums, evaluated, rounds, turns, visited


@pytest.fixture
def in_vector_loop(monkeypatch):
    """``_Grid`` and the twin both take the ΔE functions through ``vector_loop``."""
    stable = {m: vector_loop(fn) for m, fn in FUNCTIONS.items()}
    monkeypatch.setattr(ciede2000, "ciede2000_square", stable["ciede2000"])
    monkeypatch.setattr(ciede2000, "ciede2000_ref_square", stable["ciede2000_ref"])
    import test_torch_slic_kernel as kernel_tests
    monkeypatch.setattr(kernel_tests, "ciede2000_square", stable["ciede2000"])
    monkeypatch.setattr(kernel_tests, "ciede2000_ref_square", stable["ciede2000_ref"])


@pytest.mark.parametrize("displaced", [None, 0, 1])
@pytest.mark.parametrize("kind,h,w,s,iters,m", CASES)
@pytest.mark.parametrize("metric", METRICS)
def test_pair_association_equals_plain(in_vector_loop, metric, kind, h, w, s, iters, m,
                                       displaced):
    """Three associations from the init state (each from the plain version's
    labels, distances and centers of the last), the twin bit-equal to
    ``_Grid.association``; center 0 moved off the image before iteration
    ``displaced`` loses every pixel."""
    lab = lab_image(kind, h, w)
    grid = P._Grid(torch.from_numpy(lab), h, w, s, m, metric)
    centers_t = grid.init_centers()
    labels_t = torch.full(grid.pix.shape[1:], -1, dtype=torch.int32)
    dists_t = torch.full(grid.pix.shape[1:], P._BIG, dtype=torch.float32)
    for it in range(3):
        if it == displaced:
            centers_t[:2, 0, 0] = -3.0 * s
        labels = grid.from_blocks(labels_t).numpy().copy()
        dists = grid.from_blocks(dists_t).numpy().copy()
        centers = centers_t.reshape(5, -1).T.numpy().copy()
        labels_t, dists_t, changed_t, sums_t = grid.association(centers_t, labels_t, dists_t)
        got = pairs_association(lab, centers, labels, dists, s, grid.space_norm,
                                grid.color_norm, metric)
        np.testing.assert_array_equal(got[0], grid.from_blocks(labels_t).numpy())
        np.testing.assert_array_equal(got[1], grid.from_blocks(dists_t).numpy())
        assert got[2] == bool(changed_t)
        np.testing.assert_array_equal(got[3], sums_t.reshape(6, -1).T.numpy())
        if it == displaced:
            assert got[3][0, 5] == 0
        if metric != "euclidean":  # every pass evaluated once, in full rounds but the last
            assert got[5] * 32 >= got[4] > (got[5] - 8 * cdiv(h, TILE_H) * cdiv(w, TILE_W)) * 32
            assert got[5] <= got[6]
        centers_t = grid.move_centers(centers_t, grid.snap_keys(
            grid.center_means(centers_t, sums_t), labels_t))


@pytest.mark.parametrize("s", [2, 3, 4, 5, 7, 8, 9, 16, 26, 31, 32, 33, 64, 5000])
def test_window_fits_the_shared_slots(s):
    """Every tile's window of candidate cells fits kAssocSlots (20 x 8), at
    every S, on images that are and are not whole tiles and cells."""
    for h, w in ((512, 512), (97, 131), (3, 5), (2160, 3840)):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, w, TILE_W):
                wy0, wx0, wh, ww = window_of(x0, y0, h, w, s)
                assert 5 <= wh <= TILE_H // 2 + 4 and 5 <= ww <= TILE_W // 2 + 4


def test_pairs_are_dense_on_a_smooth_image():
    """At S = 26 on a smooth 130 x 130 image a pixel passes ~3-4 of its 25
    windows; the warps' rounds over their pair lists are fewer than the
    (warp, candidate) turns a lane passes (~0.8 of them here: a warp's 8 x 4
    piece mostly shares its candidates' outcome already)."""
    h = w = 130
    s, m = 26, 20.0
    lab = lab_image("smooth", h, w)
    grid = P._Grid(torch.from_numpy(lab), h, w, s, m, "ciede2000")
    centers = grid.init_centers().reshape(5, -1).T.numpy().copy()
    labels = np.full((h, w), -1, np.int32)
    dists = np.full((h, w), P._BIG, F32)
    *_, evaluated, rounds, turns, visited = pairs_association(lab, centers, labels, dists, s,
                                                     grid.space_norm, grid.color_norm,
                                                     "ciede2000")
    assert 3.0 <= evaluated / (h * w) <= 6.0
    assert rounds < turns <= visited < 25 * 8 * cdiv(h, TILE_H) * cdiv(w, TILE_W) / 3
