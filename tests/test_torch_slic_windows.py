"""SLIC's association at any drift: every center whose ±S window around its
current position holds a pixel is one of the pixel's candidates, whatever
the centers' drift (the exact windows).

A center D cells from its home cell scans pixels up to D + 1 cells from it,
so the 5×5 cell neighbourhood (the JAX package's gather) holds every window
only while D ≤ 1.  Here the plain version's association at reach 1 + D is
held to the reference's loop written out (each center in id order scanning
its window, strictly-smaller winning against the persistent map, the
in-scan sums) on states drifted 1 to 3 cells, and a whole run of
``slic_device`` to that loop with the means, snap and early exit; on the
card the kernels' wide path is held to the plain version.  No JAX here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact  # noqa: E402
from various_image_processings_tpu_torch.core.pad import cdiv  # noqa: E402
from various_image_processings_tpu_torch.models import slic as P  # noqa: E402

F32 = np.float32
BIG_KEY = np.iinfo(np.int64).max


def photo(h, w, seed):
    """u8 BGR: smooth fields at three scales, hard-edged regions and noise."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.full((h, w, 3), 128.0)
    for scale, amp in ((0.5, 60.0), (0.12, 30.0), (0.03, 12.0)):
        k = rng.normal(size=(3, 2)) / scale
        phase = rng.uniform(0, 2 * np.pi, 3)
        for c in range(3):
            img[..., c] += amp * np.sin(k[c, 0] * ys * 6 + k[c, 1] * xs * 6 + phase[c])
    img += 40.0 * (np.sin(xs * 37 + ys * 23) > 0.3)[..., None] * rng.choice([-1, 1], 3)
    img += rng.normal(0.0, 3.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def lab_of(bgr):
    return bgr2lab_u8_exact(torch.from_numpy(bgr)).numpy()


def sequential_association(lab, centers, labels, dists, s, space_norm, color_norm):
    """The reference's loop (include/cpp/slic.hpp:236-281): each center in
    id order scans |x - cx| <= S, |y - cy| <= S around where it is, a
    strictly smaller f32 distance takes the pixel, and the pixels of its
    window labelled with it after its turn join its sums.  ``centers`` (N, 5)
    f32 x, y, l, a, b → (labels, dists, changed, sums (N, 6) int64)."""
    before = dists
    h, w = labels.shape
    labels, dists = labels.copy(), dists.copy()
    sums = np.zeros((len(centers), 6), np.int64)
    pix = lab.astype(F32)
    for c, (cx, cy, cl, ca, cb) in enumerate(centers):
        x0, x1 = max(0, int(np.ceil(cx - s))), min(w, int(np.floor(cx + s)) + 1)
        y0, y1 = max(0, int(np.ceil(cy - s))), min(h, int(np.floor(cy + s)) + 1)
        if x0 >= x1 or y0 >= y1:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1]
        dx, dy = xs.astype(F32) - cx, ys.astype(F32) - cy
        p = pix[y0:y1, x0:x1]
        dl = (cl - p[..., 0]) * F32(2.55)
        da, db = ca - p[..., 1], cb - p[..., 2]
        color = dl * dl + da * da + db * db
        d = F32(space_norm) * (dx * dx + dy * dy) + F32(color_norm) * color
        win_l, win_d = labels[y0:y1, x0:x1], dists[y0:y1, x0:x1]
        better = d < win_d
        win_d[better] = d[better]
        win_l[better] = c
        member = win_l == c
        sums[c] += [xs[member].sum(), ys[member].sum(),
                    *lab[y0:y1, x0:x1][member].astype(np.int64).sum(0), member.sum()]
    return labels, dists, bool((dists < before).any()), sums


def sequential_run(lab, s, iters, m):
    """A whole k-means on the reference's loop: seeds as the port's, then
    each iteration the association, the means floor(f32 sum / f32 count),
    each center to the first raster pixel of least floor(colour distance
    to its mean) among those labelled with it, and the early exit."""
    h, w, _ = lab.shape
    pc, pr = cdiv(h, s), cdiv(w, s)
    space_norm, color_norm = P._norms(s, m)
    cx, cy, colors = P._init_centers(torch.from_numpy(lab).to(torch.float32), h, w, s, pc, pr)
    centers = torch.cat([cx[:, None], cy[:, None], colors], 1).numpy()
    labels = np.full((h, w), -1, np.int64)
    dists = np.full((h, w), np.finfo(F32).max, F32)
    pix = lab.astype(F32)
    raster = np.arange(h * w, dtype=np.int64).reshape(h, w)
    for _ in range(iters):
        labels, dists, changed, sums = sequential_association(lab, centers, labels, dists, s,
                                                              space_norm, color_norm)
        count = sums[:, 5].astype(F32)
        means = np.floor(sums[:, 2:5].astype(F32) / np.maximum(count, F32(1))[:, None])
        means = np.where(count[:, None] > 0, means, centers[:, 2:5])
        ml = means[labels]
        dl = (ml[..., 0] - pix[..., 0]) * F32(2.55)
        da, db = ml[..., 1] - pix[..., 1], ml[..., 2] - pix[..., 2]
        key = np.floor(dl * dl + da * da + db * db).astype(np.int64) * (1 << 32) + raster
        best = np.full(len(centers), BIG_KEY, np.int64)
        np.minimum.at(best, labels.reshape(-1), key.reshape(-1))
        moved = best < BIG_KEY
        first = best[moved] & 0xFFFFFFFF
        centers[moved, 0] = first % w
        centers[moved, 1] = first // w
        centers[moved, 2:5] = lab.reshape(-1, 3)[first]
        if not changed:
            break
    return labels.astype(np.int32), centers


def drifted_state(lab, s, drift, seed):
    """Centers at random pixels at most ``drift`` cells from their home
    cells (one of them exactly ``drift`` away), with the Lab color there,
    and a persistent map from one association of the seeds."""
    h, w, _ = lab.shape
    pc, pr = cdiv(h, s), cdiv(w, s)
    rng = np.random.default_rng(seed)
    gy, gx = np.divmod(np.arange(pc * pr), pr)
    cyc = np.clip(gy + rng.integers(-drift, drift + 1, gy.shape), 0, pc - 1)
    cxc = np.clip(gx + rng.integers(-drift, drift + 1, gx.shape), 0, pr - 1)
    cyc[pr + 1], cxc[pr + 1] = min(1 + drift, pc - 1), 1  # exactly `drift` cells down
    y = np.minimum(cyc * s + rng.integers(0, s, gy.shape), h - 1)
    x = np.minimum(cxc * s + rng.integers(0, s, gx.shape), w - 1)
    centers = np.stack([x, y, *lab[y, x].T], 1).astype(F32)
    space_norm, color_norm = P._norms(s, 20.0)
    cx, cy, colors = P._init_centers(torch.from_numpy(lab).to(torch.float32), h, w, s, pc, pr)
    seeds = torch.cat([cx[:, None], cy[:, None], colors], 1).numpy()
    labels, dists, _, _ = sequential_association(lab, seeds, np.full((h, w), -1, np.int64),
                                                 np.full((h, w), np.finfo(F32).max, F32), s,
                                                 space_norm, color_norm)
    return centers, labels, dists


def plain_association(lab, centers, labels, dists, s, reach):
    h, w, _ = lab.shape
    grid = P._Grid(torch.from_numpy(lab), h, w, s, 20.0, "euclidean")
    state = torch.from_numpy(centers).T.reshape(5, grid.pc, grid.pr).contiguous()
    out_l, out_d, changed, sums = grid.association(
        state, grid.to_blocks(torch.from_numpy(labels.astype(np.int32)), -1),
        grid.to_blocks(torch.from_numpy(dists), float(np.finfo(F32).max)), reach)
    return (grid.from_blocks(out_l).numpy(), grid.from_blocks(out_d).numpy(), bool(changed),
            sums.reshape(6, -1).T.numpy())


@pytest.mark.parametrize("shape,s,drift,seed", [
    ((41, 57), 5, 1, 0), ((41, 57), 5, 2, 1), ((41, 57), 5, 3, 2), ((37, 30), 6, 2, 3),
    ((50, 64), 8, 3, 4), ((23, 29), 2, 2, 5)])
def test_association_at_reach_one_past_the_drift_is_the_reference_loop(shape, s, drift, seed):
    lab = lab_of(photo(*shape, seed))
    centers, labels, dists = drifted_state(lab, s, drift, seed)
    space_norm, color_norm = P._norms(s, 20.0)
    want = sequential_association(lab, centers, labels, dists, s, space_norm, color_norm)
    got = plain_association(lab, centers, labels, dists, s, max(2, 1 + drift))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("shape,s,seed", [((41, 57), 5, 1), ((50, 64), 8, 4)])
def test_the_5x5_gather_misses_a_window_two_cells_from_home(shape, s, seed):
    """The JAX package's 5×5 neighbourhood against a state drifted two
    cells: a pixel three cells from a center's home cell, inside its window,
    does not see it."""
    lab = lab_of(photo(*shape, seed))
    centers, labels, dists = drifted_state(lab, s, 2, seed)
    space_norm, color_norm = P._norms(s, 20.0)
    want = sequential_association(lab, centers, labels, dists, s, space_norm, color_norm)
    got = plain_association(lab, centers, labels, dists, s, 2)
    assert not np.array_equal(got[3], want[3])


@pytest.mark.parametrize("shape,s,iters,seed", [
    ((60, 90), 6, 10, 7), ((72, 96), 5, 10, 0), ((45, 50), 10, 6, 9), ((40, 52), 4, 3, 1)])
def test_exact_windows_run_is_the_reference_loop(shape, s, iters, seed):
    lab = lab_of(photo(*shape, seed))
    h, w = shape
    want, want_centers = sequential_run(lab, s, iters, 20.0)
    P.iterations = P.host_syncs = 0
    labels, centers, _, drift = P.slic_device(torch.from_numpy(lab), h, w, s, iters, 20.0,
                                              impl="torch")
    np.testing.assert_array_equal(labels.numpy(), want)
    np.testing.assert_array_equal(centers.numpy(), want_centers)
    # the drift rides on the early-exit read: one after each iteration but the last
    assert P.host_syncs == min(P.iterations, iters - 1)


def gather_5x5_run(lab, s, iters, m):
    """The JAX package's k-means: ``_Grid``'s pieces with the association's
    reach held at 2 (the 5×5 neighbourhood) → raw labels (H, W)."""
    h, w, _ = lab.shape
    grid = P._Grid(torch.from_numpy(lab), h, w, s, m, "euclidean")
    centers = grid.init_centers()
    labels = torch.full(grid.pix.shape[1:], -1, dtype=torch.int32)
    dists = torch.full(grid.pix.shape[1:], P._BIG, dtype=torch.float32)
    for _ in range(iters):
        labels, dists, changed, sums = grid.association(centers, labels, dists, 2)
        centers = grid.snap_centers(centers, grid.center_means(centers, sums), labels)
        if not changed:
            break
    return grid.from_blocks(labels)


def test_a_run_that_drifts_two_cells_differs_from_the_5x5_gather():
    """A frame of the run above whose centers drift two cells: the 5×5
    gather gives other labels, the port the reference's."""
    lab = lab_of(photo(72, 96, 0))
    exact = P.slic_device(torch.from_numpy(lab), 72, 96, 5, 10, 20.0)
    assert float(exact[3]) >= 2
    np.testing.assert_array_equal(exact[0].numpy(), sequential_run(lab, 5, 10, 20.0)[0])
    assert not torch.equal(exact[0], gather_5x5_run(lab, 5, 10, 20.0))


def test_op_and_class_give_the_exact_windows_labels():
    """The public op and class on a frame that drifts two cells or more:
    the same labels, and the raw labels under them the reference loop's."""
    img = photo(48, 64, 11)
    got = vt.superpixel_slic(img, 5, 10, device="cpu")
    slic = vt.SuperpixelSLIC(48, 64, 5, 10, device="cpu")
    assert torch.equal(slic.apply(img), got)
    assert slic.last_max_drift_cells >= 2
    lab = lab_of(img)
    raw = P.slic_device(torch.from_numpy(lab), 48, 64, 5, 10, 20.0)[0]
    np.testing.assert_array_equal(raw.numpy(), sequential_run(lab, 5, 10, 20.0)[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", P.METRICS)
@pytest.mark.parametrize("shape,s,seed", [((540, 960), 10, 1), ((216, 384), 6, 2),
                                          ((97, 131), 2, 3)])
def test_kernel_route_with_exact_windows_equals_the_plain_route(cuda, metric, shape, s, seed):
    lab = bgr2lab_u8_exact(torch.from_numpy(photo(*shape, seed)).to(cuda))
    got = P.slic_device(lab, *shape, s, 10, 20.0, metric, impl="cuda")
    ran = int(P.device_iterations)
    P.iterations = 0
    want = P.slic_device(lab, *shape, s, 10, 20.0, metric, impl="torch")
    assert ran == P.iterations
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", P.METRICS)
@pytest.mark.parametrize("drift", [1, 2, 3, 5])
def test_kernels_on_a_drifted_state_equal_the_plain_pieces(cuda, metric, drift):
    """One iteration's association (its wide path from a drift of two) and
    snap keys (a label past the tile's window) on centers drifted up to
    ``drift`` cells, against ``_Grid``'s pieces at reach 1 + drift."""
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    h, w, s = 97, 131, 6
    lab_np = lab_of(photo(h, w, drift))
    centers, labels, dists = drifted_state(lab_np, s, drift, drift)
    lab = torch.from_numpy(lab_np).to(cuda)
    grid = P._Grid(lab, h, w, s, 20.0, metric)
    space_norm, color_norm = P._norms(s, 20.0)
    state = torch.zeros((1, 3, 2), dtype=torch.int32, device=cuda)
    state[0, 0, 0], state[0, 1, 0] = drift, 1
    c_k = torch.from_numpy(centers).to(cuda)[None].contiguous()
    l_k = torch.from_numpy(labels.astype(np.int32)).to(cuda)[None].contiguous()
    d_k = torch.from_numpy(dists).to(cuda)[None].contiguous()
    sums = torch.zeros((1, len(centers), 6), dtype=torch.int64, device=cuda)
    keys = torch.full((1, len(centers)), BIG_KEY, dtype=torch.int64, device=cuda)
    c_t = c_k[0].T.reshape(5, grid.pc, grid.pr).contiguous()
    l_t, d_t, changed, sums_t = grid.association(
        c_t, grid.to_blocks(l_k[0].clone(), -1), grid.to_blocks(d_k[0].clone(), P._BIG),
        max(2, 1 + drift))
    kslic.associate(lab[None], c_k, l_k, d_k, sums, state, 0, s, space_norm, color_norm, metric)
    kslic.snap_keys(lab[None], c_k, l_k, sums, keys, state, 0, s, metric)
    assert torch.equal(l_k[0], grid.from_blocks(l_t))
    assert torch.equal(d_k[0], grid.from_blocks(d_t))
    assert torch.equal(sums[0], sums_t.reshape(6, -1).T)
    assert int(state[0, 1, 1]) == int(changed)
    means = grid.center_means(c_t, sums_t)
    assert torch.equal(keys[0], grid.snap_keys(means, l_t))
