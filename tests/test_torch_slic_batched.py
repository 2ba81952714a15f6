"""Batched SLIC on the CPU: the k-means of a batch as one device program.

The JAX package runs the k-means of a batch as one vmapped XLA program
(``parallel/batch.py::superpixel_slic_batched``, ``jax.vmap`` of
``models/slic.py::slic_device``): its while_loop masks each image, so each
stops where its single run would.  The port runs a sub-batch in the same
kernel launches (csrc/slic_kmeans.cu, grid.y the image), each image with its
own state row and flags.  Here, with no card:

- the batched set-up (``_init_centers``, ``kmeans_state``) equals the
  per-image one;
- a NumPy twin of the batched kernels (every image's pixels in one flat
  array at its own offset, global center ids ``b * N + c``, a raster index
  an image, the (B, iterations + 2, 2) state with an active flag an image
  and iteration) equals the per-image twin of
  tests/test_torch_slic_kernel.py, the plain pieces and
  ``slic_device(impl="torch")`` image by image, bit for bit, on a batch
  whose images stop at different iterations, with a center that has no
  pixel in one image and pixels in the others, and with a ΔE metric;
- ``slic_device_batched`` and the batched ``_download`` keep the single
  route's contracts (a batch of one is the single call, one host read a
  sub-batch, the iterations summed);
- ``parallel.superpixel_slic_batched`` on CPU meshes of 1, 2 and 4 batch
  rows gives the labels of per-image ``superpixel_slic`` and of the JAX
  package's ``superpixel_slic_batched`` (tolerance: equal labels), on the
  mixed-convergence batch and with ``ciede2000``; against the JAX package
  with the association held at its 5×5 gather (``gather_5x5``: the batch's
  centers drift three cells, past which the port's windows are the
  reference's).

The JAX SLIC compiles once a (batch shape, metric): this file uses two,
(4, 40, 48) euclidean and (2, 40, 48) ciede2000, and caches their results."""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one chunk a CPU op: ``vector_loop`` relies on it

from various_image_processings_tpu import parallel as jpar  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch import parallel as tpar  # noqa: E402
from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact  # noqa: E402
from various_image_processings_tpu_torch.core.pad import cdiv  # noqa: E402
from various_image_processings_tpu_torch.models import slic as P  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import slic as kslic  # noqa: E402
from test_torch_slic_kernel import (  # noqa: E402
    BIG_KEY, F32, gather_5x5, lab_image, offsets, twin_color, twin_run)
from test_torch_slic_delta_e import in_vector_loop  # noqa: E402, F401

CPU = torch.device("cpu")

# (kinds, height, width, S, iterations, m): the mixed-convergence batch (the
# constant image stops after a few iterations, the noise image runs them
# all), images that are not whole cells, S past the image
BATCHES = [
    (("constant", "random", "two", "smooth"), 26, 39, 13, 10, 20.0),
    (("random", "smooth", "random"), 37, 53, 8, 5, 20.0),
    (("smooth", "constant"), 13, 17, 40, 3, 20.0),
]


def lab_batch(kinds, h, w):
    """(B, H, W, 3) Lab codes, one image of each kind (noise images seeded
    by their position)."""
    return np.stack([lab_image(kind, h, w, seed=i) for i, kind in enumerate(kinds)])


# ---------------------------------------------------------------------------
# the batched twin: the kernels' addressing and state over a whole batch
# ---------------------------------------------------------------------------

def twin_batch_association(lab, centers, labels, dists, s, space_norm, color_norm, active,
                           metric="euclidean", reach=None):
    """The association kernel over a batch: lab (B, H, W, 3); centers
    (B * N, 5), labels and dists (B, H, W) flat by image; a pixel of image b
    takes its candidates among centers b * N + c, from its cell's (2
    reach[b] + 1)² neighbourhood (``reach`` (B,) ints, 2 each by default);
    an image whose ``active`` flag is clear is left as it was.  → (labels,
    dists, changed (B,) bool, sums (B * N, 6) int64)."""
    b, h, w = labels.shape
    pc, pr = cdiv(h, s), cdiv(w, s)
    n = pc * pr
    image = np.arange(b)[:, None, None]
    ys, xs = np.mgrid[0:h, 0:w]
    ys, xs = np.broadcast_to(ys, (b, h, w)), np.broadcast_to(xs, (b, h, w))
    gy, gx = ys // s, xs // s
    xf, yf = xs.astype(F32), ys.astype(F32)
    lf, af, bf = (lab[..., k].astype(F32) for k in range(3))
    feats = [xs, ys, *(lab[..., k].astype(np.int64) for k in range(3)), np.ones_like(xs)]
    run_l, run_d = labels.copy(), dists.copy()
    sums = np.zeros((b * n, 6), np.int64)
    reach = np.full(b, 2) if reach is None else np.asarray(reach)
    for dy, dx in offsets(int(reach.max())):
        ny, nx = gy + dy, gx + dx
        on_grid = ((ny >= 0) & (ny < pc) & (nx >= 0) & (nx < pr) & active[image]
                   & (max(abs(dy), abs(dx)) <= reach[image]))
        cid = np.where(on_grid, ny * pr + nx, 0)
        gid = image * n + cid  # the kernels' 64-bit offset of the image's centers
        c = centers[gid]
        ddx, ddy = xf - c[..., 0], yf - c[..., 1]
        scanned = on_grid & (np.abs(ddx) <= F32(s)) & (np.abs(ddy) <= F32(s))
        color = twin_color(c[..., 2], c[..., 3], c[..., 4], lf, af, bf, metric)
        d = F32(space_norm) * (ddx * ddx + ddy * ddy) + F32(color_norm) * color
        better = scanned & (d < run_d)
        run_d = np.where(better, d, run_d)
        run_l = np.where(better, cid, run_l).astype(np.int32)
        member = scanned & (run_l == cid)
        for k, v in enumerate(feats):
            np.add.at(sums[:, k], gid[member], v[member])
    changed = (run_d < dists).reshape(b, -1).any(1)
    return run_l, run_d, changed, sums


def twin_batch_keys(lab, centers, labels, sums, active, metric="euclidean"):
    """The snap-key kernel over a batch: each active image's labelled pixels
    key into their center b * N + label with floor(distance to its mean) *
    2^32 + the pixel's raster index in its own image → keys (B * N,)."""
    b, h, w = labels.shape
    n = len(centers) // b
    count = sums[:, 5]
    quotient = sums[:, 2:5].astype(F32) / np.maximum(count, 1).astype(F32)[:, None]
    means = np.where(count[:, None] > 0, np.floor(quotient), centers[:, 2:5])
    member = (labels >= 0) & active[:, None, None]
    image, ys, xs = np.nonzero(member)
    gid = image * n + labels[member]
    pix = lab[member].astype(F32)
    key = np.floor(twin_color(*means[gid].T, *pix.T, metric)).astype(np.int64)
    keys = np.full(b * n, BIG_KEY, np.int64)
    np.minimum.at(keys, gid, key * (1 << 32) + ys * w + xs)
    return keys


def twin_batch_update(lab, centers, keys, sums, state, it, s, active):
    """The update kernel over a batch: one thread a center of an active
    image; its image's drift max, iteration count and next active flag
    into its own state rows; sums and keys cleared."""
    b, h, w = lab.shape[:3]
    n = len(centers) // b
    pr = cdiv(w, s)
    out = centers.copy()
    live = np.repeat(active, n)
    has = live & (keys < BIG_KEY)
    first = keys[has] & 0xFFFFFFFF
    image = np.nonzero(has)[0] // n
    out[has, 0] = first % w
    out[has, 1] = first // w
    out[has, 2:] = lab.reshape(b, -1, 3)[image, first]
    c = np.arange(b * n) % n
    drift = np.maximum(np.abs(out[:, 0].astype(np.int32) // s - c % pr),
                       np.abs(out[:, 1].astype(np.int32) // s - c // pr)).reshape(b, n).max(1)
    state[active, 0, 0] = np.maximum(state[active, 0, 0], drift[active])
    state[active, 0, 1] = it + 1
    state[active, 2 + it, 0] = state[active, 1 + it, 1]
    sums[live] = 0
    keys[live] = BIG_KEY
    return out


def twin_batch_state(labs, s, num_iteration):
    """``kmeans_state`` as NumPy arrays, centers, sums and keys flat by image."""
    b, h, w = labs.shape[:3]
    state = P.kmeans_state(torch.from_numpy(labs), h, w, s, num_iteration)
    centers, labels, dists, sums, keys, st = (t.numpy().copy() for t in state)
    return (centers.reshape(-1, 5), labels, dists, sums.reshape(-1, 6), keys.reshape(-1), st)


def twin_batch_run(labs, s, num_iteration, color_scale, metric="euclidean"):
    """Whole batched runs as the kernels run them: every iteration's three
    steps for the batch, each image's active flag and association reach
    (max(2, 1 + its drift so far)) read from its state rows → (labels (B,
    H, W), centers (B, N, 5), dists (B, H, W), state)."""
    b, h, w = labs.shape[:3]
    space_norm, color_norm = P._norms(s, color_scale)
    centers, labels, dists, sums, keys, state = twin_batch_state(labs, s, num_iteration)
    for it in range(num_iteration):
        active = state[:, 1 + it, 0] == 1
        labels, dists, changed, new_sums = twin_batch_association(
            labs, centers, labels, dists, s, space_norm, color_norm, active, metric,
            np.maximum(2, 1 + state[:, 0, 0]))
        sums += new_sums
        state[active, 1 + it, 1] = changed[active]
        keys = np.minimum(keys, twin_batch_keys(labs, centers, labels, sums, active, metric))
        centers = twin_batch_update(labs, centers, keys, sums, state, it, s, active)
    return labels, centers.reshape(b, -1, 5), dists, state


# ---------------------------------------------------------------------------
# the batched set-up
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds,h,w,s,iters,m", BATCHES)
def test_init_centers_batched_equals_per_image(kinds, h, w, s, iters, m):
    labs = torch.from_numpy(lab_batch(kinds, h, w)).to(torch.float32)
    pc, pr = cdiv(h, s), cdiv(w, s)
    cx, cy, colors = P._init_centers(labs, h, w, s, pc, pr)
    assert colors.shape == (len(kinds), pc * pr, 3)
    for i in range(len(kinds)):
        one = P._init_centers(labs[i], h, w, s, pc, pr)
        assert torch.equal(cx, one[0]) and torch.equal(cy, one[1])
        assert torch.equal(colors[i], one[2])


@pytest.mark.parametrize("kinds,h,w,s,iters,m", BATCHES)
def test_kmeans_state_batched_equals_per_image(kinds, h, w, s, iters, m):
    labs = torch.from_numpy(lab_batch(kinds, h, w))
    b, n = len(kinds), cdiv(h, s) * cdiv(w, s)
    batched = P.kmeans_state(labs, h, w, s, iters)
    shapes = [(b, n, 5), (b, h, w), (b, h, w), (b, n, 6), (b, n), (b, iters + 2, 2)]
    assert [tuple(t.shape) for t in batched] == shapes
    assert all(t.is_contiguous() for t in batched)
    for i in range(b):
        one = P.kmeans_state(labs[i:i + 1], h, w, s, iters)
        for a, c in zip(batched, one):
            assert torch.equal(a[i], c[0])
        cx, cy, colors = P._init_centers(labs[i].to(torch.float32), h, w, s, cdiv(h, s),
                                         cdiv(w, s))
        assert torch.equal(batched[0][i], torch.cat([cx[:, None], cy[:, None], colors], 1))
    state = batched[5]
    assert bool((state[:, 1, 0] == 1).all()) and int(state.sum()) == b


# ---------------------------------------------------------------------------
# the batched twin against the per-image twin and the plain route
# ---------------------------------------------------------------------------

def per_image_runs(labs, s, iters, m, metric="euclidean"):
    """slic_device(impl="torch") of each image, with the iterations each ran."""
    b, h, w = labs.shape[:3]
    runs = []
    for i in range(b):
        P.iterations = 0
        out = P.slic_device(torch.from_numpy(labs[i]), h, w, s, iters, m, metric, impl="torch")
        runs.append((*(t.numpy() for t in out), P.iterations))
    return runs


def check_twin_batch(labs, s, iters, m, metric="euclidean"):
    labels, centers, dists, state = twin_batch_run(labs, s, iters, m, metric)
    for i, (p_labels, p_centers, p_dists, p_drift, p_ran) in enumerate(
            per_image_runs(labs, s, iters, m, metric)):
        want = twin_run(labs[i], s, iters, m, metric)
        for got, single, plain in ((labels[i], want[0], p_labels),
                                   (centers[i], want[1], p_centers),
                                   (dists[i], want[2], p_dists)):
            np.testing.assert_array_equal(got, single)
            np.testing.assert_array_equal(got, plain)
        assert state[i, 0, 0] == want[3] == float(p_drift)
        assert state[i, 0, 1] == want[4] == p_ran
        # the iterations it ran were active, the rest never were
        assert list(state[i, 1:1 + iters, 0]) == [1] * p_ran + [0] * (iters - p_ran)
    return state


@pytest.mark.parametrize("kinds,h,w,s,iters,m", BATCHES)
def test_twin_batch_equals_per_image_runs(kinds, h, w, s, iters, m):
    state = check_twin_batch(lab_batch(kinds, h, w), s, iters, m)
    if kinds[0] == "constant" and iters == 10:  # the mixed-convergence batch
        ran = state[:, 0, 1]
        assert ran[0] < 10 and ran.max() == 10, ran


@pytest.mark.parametrize("metric", ["ciede2000", "ciede2000_ref"])
def test_twin_batch_equals_per_image_runs_delta_e(in_vector_loop, metric):
    kinds, h, w, s, iters, m = BATCHES[0]
    check_twin_batch(lab_batch(kinds, h, w), s, iters, m, metric)


def test_twin_batch_of_one_is_the_single_twin():
    labs = lab_batch(("random",), 37, 53)
    labels, centers, dists, state = twin_batch_run(labs, 8, 5, 20.0)
    want = twin_run(labs[0], 8, 5, 20.0)
    np.testing.assert_array_equal(labels[0], want[0])
    np.testing.assert_array_equal(centers[0], want[1])
    np.testing.assert_array_equal(dists[0], want[2])
    assert state[0, 0, 0] == want[3] and state[0, 0, 1] == want[4]


@pytest.mark.parametrize("empty_in", [0, 1])
def test_twin_batch_pieces_with_a_center_empty_in_one_image(empty_in):
    """Three iterations of the batched steps (every image active) against
    each image's plain pieces, with center 0 moved off image ``empty_in``
    before the first: there it has no pixel (no sums, no key, it keeps its
    state), in the other image it has pixels, and nothing of one image's
    center 0 reaches the other's."""
    h, w, s, m = 30, 45, 6, 20.0
    labs = lab_batch(("random", "random"), h, w)
    centers, labels, dists, sums, keys, state = twin_batch_state(labs, s, 3)
    n = len(centers) // 2
    centers[empty_in * n, :2] = -3.0 * s
    grids = [P._Grid(torch.from_numpy(labs[i]), h, w, s, m, "euclidean") for i in range(2)]
    plain = []
    for i, grid in enumerate(grids):
        c = torch.from_numpy(centers[i * n:(i + 1) * n].T.copy()).view(5, grid.pc, grid.pr)
        plain.append([c, torch.full(grid.pix.shape[1:], -1, dtype=torch.int32),
                      torch.full(grid.pix.shape[1:], P._BIG, dtype=torch.float32)])
    active = np.ones(2, bool)
    drift = [0.0, 0.0]
    for it in range(3):
        state[:, 1 + it, 0] = 1
        labels, dists, changed, sums = twin_batch_association(
            labs, centers, labels, dists, s, grids[0].space_norm, grids[0].color_norm, active)
        keys = twin_batch_keys(labs, centers, labels, sums, active)
        if it == 0:
            counts = sums[::n, 5]  # each image's center 0
            assert counts[empty_in] == 0 and counts[1 - empty_in] > 0
            assert keys[empty_in * n] == BIG_KEY and keys[(1 - empty_in) * n] < BIG_KEY
        for i, grid in enumerate(grids):
            c_t, l_t, d_t = plain[i]
            l_t, d_t, changed_t, sums_t = grid.association(c_t, l_t, d_t)
            np.testing.assert_array_equal(labels[i], grid.from_blocks(l_t).numpy())
            np.testing.assert_array_equal(dists[i], grid.from_blocks(d_t).numpy())
            assert changed[i] == bool(changed_t)
            np.testing.assert_array_equal(sums[i * n:(i + 1) * n], sums_t.reshape(6, -1).T)
            keys_t = grid.snap_keys(grid.center_means(c_t, sums_t), l_t)
            np.testing.assert_array_equal(keys[i * n:(i + 1) * n], keys_t.numpy())
            plain[i] = [grid.move_centers(c_t, keys_t), l_t, d_t]
        centers = twin_batch_update(labs, centers, keys, sums, state, it, s, active)
        for i, grid in enumerate(grids):
            np.testing.assert_array_equal(centers[i * n:(i + 1) * n],
                                          plain[i][0].reshape(5, -1).T.numpy())
            drift[i] = max(drift[i], float(grid.cell_drift(plain[i][0])))
            assert state[i, 0, 0] == drift[i] and state[i, 0, 1] == it + 1
        assert not sums.any() and (keys == BIG_KEY).all()


# ---------------------------------------------------------------------------
# slic_device_batched and the batched download
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds,h,w,s,iters,m", BATCHES[:2])
def test_slic_device_batched_equals_single_calls(kinds, h, w, s, iters, m):
    labs = torch.from_numpy(lab_batch(kinds, h, w))
    P.iterations = 0
    out = P.slic_device_batched(labs, h, w, s, iters, m)
    ran = P.iterations
    assert P.device_iterations is None  # the CPU takes the plain route
    assert [tuple(t.shape) for t in out] == [(len(kinds), h, w),
                                             (len(kinds), cdiv(h, s) * cdiv(w, s), 5),
                                             (len(kinds), h, w), (len(kinds),)]
    P.iterations = 0
    for i in range(len(kinds)):
        single = P.slic_device(labs[i], h, w, s, iters, m)
        for a, b in zip(out, single):
            assert a.dtype == b.dtype and torch.equal(a[i], b)
    assert P.iterations == ran


def test_slic_device_batched_refuses_what_it_does_not_take():
    labs = torch.from_numpy(lab_batch(("random", "smooth"), 12, 12))
    before = (kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        P.slic_device_batched(labs, 12, 12, 4, 2, 20.0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        P.slic_device_batched(labs, 12, 12, 4, 2, 20.0, "ciede2000", impl="cuda")
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        P.slic_device_batched(labs[0], 12, 12, 4, 2, 20.0)
    with pytest.raises(ValueError, match="impl"):
        P.slic_device_batched(labs, 12, 12, 4, 2, 20.0, impl="triton")
    assert before == (kslic.association_launches, kslic.snap_keys_launches,
                      kslic.update_launches)


def test_batched_wrappers_refuse_cpu_tensors():
    b, h, w, n = 2, 8, 8, 4
    lab = torch.from_numpy(lab_batch(("random", "smooth"), h, w))
    centers = torch.zeros((b, n, 5))
    labels = torch.full((b, h, w), -1, dtype=torch.int32)
    dists = torch.zeros((b, h, w))
    sums = torch.zeros((b, n, 6), dtype=torch.int64)
    keys = torch.zeros((b, n), dtype=torch.int64)
    state = torch.zeros((b, 3, 2), dtype=torch.int32)
    before = (kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kslic.associate(lab, centers, labels, dists, sums, state, 0, 4, 0.0625, 0.0025)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kslic.snap_keys(lab, centers, labels, sums, keys, state, 0, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kslic.update(lab, centers, keys, sums, state, 0, 4)
    assert before == (kslic.association_launches, kslic.snap_keys_launches,
                      kslic.update_launches)


def test_batched_download_reads_once_and_sums_the_iterations():
    """A sub-batch's kernel-route call leaves each image's iterations on the
    device; one download carries them with the labels, Lab and drifts, and
    adds their sum to ``iterations``, as B single calls would."""
    b, h, w = 3, 4, 5
    labels = torch.arange(b * h * w, dtype=torch.int32).reshape(b, h, w)
    lab = torch.from_numpy(lab_batch(("random", "smooth", "two"), h, w))
    drift = torch.tensor([1.0, 3.0, 0.0])
    state = torch.zeros((b, 12, 2), dtype=torch.int32)
    state[:, 0, 1] = torch.tensor([4, 10, 2], dtype=torch.int32)
    P.iterations = P.host_syncs = 0
    P.device_iterations = state[:, 0, 1]  # a strided column, as the kernel route leaves it
    raw, lab_host, drift_host = P._download(labels, lab, drift)
    assert P.iterations == 16 and P.host_syncs == 1 and P.device_iterations is None
    np.testing.assert_array_equal(raw, labels.numpy())
    np.testing.assert_array_equal(lab_host, lab.numpy())
    np.testing.assert_array_equal(drift_host, drift.numpy())
    assert drift_host.shape == (b,) and drift_host.dtype == np.float32


# ---------------------------------------------------------------------------
# superpixel_slic_batched: the port's meshes, per-image calls and JAX
# ---------------------------------------------------------------------------

JAX_SHAPE = (40, 48, 8, 10, 20.0)  # height, width, S, iterations, m


def bgr_batch(kinds):
    """BGR u8 images: the k-means takes any codes, and each kind keeps its
    character through the Lab conversion (constant stays constant)."""
    h, w = JAX_SHAPE[:2]
    return lab_batch(kinds, h, w)


MIXED = ("constant", "random", "two", "smooth")  # (4, 40, 48): stops at different iterations
DELTA_E_KINDS = ("constant", "smooth")


@functools.cache
def jax_labels(kinds, metric):
    h, w, s, iters, m = JAX_SHAPE
    return np.asarray(jpar.superpixel_slic_batched(bgr_batch(kinds), s, iters, m, metric))


def cpu_mesh(batch):
    return tpar.make_mesh(batch=batch, spatial=1, devices=[CPU] * batch)


def test_mixed_batch_stops_at_different_iterations():
    """With the JAX package's gather, as the comparison below runs it
    (with the port's windows its constant image drifts on to the last
    iteration; ``BATCHES``' mixed batch stops early either way)."""
    h, w, s, iters, m = JAX_SHAPE
    labs = bgr2lab_u8_exact(torch.from_numpy(bgr_batch(MIXED)))
    with gather_5x5():
        ran = [run[4] for run in per_image_runs(labs.numpy(), s, iters, m)]
    assert min(ran) < iters and max(ran) == iters, ran


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_superpixel_slic_batched_equals_jax_and_single_calls(rows):
    h, w, s, iters, m = JAX_SHAPE
    imgs = bgr_batch(MIXED)
    P.host_syncs = 0
    out = tpar.superpixel_slic_batched(imgs, s, iters, m, mesh=cpu_mesh(rows))
    assert out.shape == (len(MIXED), h, w) and out.dtype == torch.int32 and out.device == CPU
    # the plain route reads its early exit an iteration; the downloads: one a row
    assert P.host_syncs >= rows
    for i in range(len(MIXED)):
        assert torch.equal(out[i], vt.superpixel_slic(imgs[i], s, iters, m, device="cpu"))
    with gather_5x5():
        out = tpar.superpixel_slic_batched(imgs, s, iters, m, mesh=cpu_mesh(rows))
        for i in range(len(MIXED)):
            assert torch.equal(out[i], vt.superpixel_slic(imgs[i], s, iters, m, device="cpu"))
    np.testing.assert_array_equal(out.numpy(), jax_labels(MIXED, "euclidean"))


@pytest.mark.parametrize("rows", [1, 2])
def test_superpixel_slic_batched_delta_e_equals_jax_and_single_calls(rows):
    h, w, s, iters, m = JAX_SHAPE
    imgs = bgr_batch(DELTA_E_KINDS)
    out = tpar.superpixel_slic_batched(imgs, s, iters, m, "ciede2000", mesh=cpu_mesh(rows))
    for i in range(len(DELTA_E_KINDS)):
        assert torch.equal(out[i], vt.superpixel_slic(imgs[i], s, iters, m, "ciede2000",
                                                      device="cpu"))
    np.testing.assert_array_equal(out.numpy(), jax_labels(DELTA_E_KINDS, "ciede2000"))


def test_superpixel_slic_batched_downloads_once_a_row(monkeypatch):
    """Each batch row's sub-batch goes through one slic_device_batched call
    and one download, whatever its size."""
    calls, downloads = [], []
    real_batched, real_download = P.slic_device_batched, P._download

    def batched(lab, *args):
        calls.append(lab.shape[0])
        return real_batched(lab, *args)

    def download(*args):
        downloads.append(args[0].shape)
        return real_download(*args)

    monkeypatch.setattr(P, "slic_device_batched", batched)
    monkeypatch.setattr(P, "_download", download)
    imgs = lab_batch(("random", "smooth", "two", "random"), 16, 24)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tpar.superpixel_slic_batched(imgs, 8, 2, mesh=cpu_mesh(2))
    assert calls == [2, 2] and downloads == [(2, 16, 24), (2, 16, 24)]
