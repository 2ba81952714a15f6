"""The SLIC k-means kernels' formulation (csrc/slic_kmeans.cu) on the CPU.

The kernels run only on the card.  Here a NumPy twin of one iteration,
written pixel-major as the kernels are (per pixel, the candidates of its
cell's (2R + 1)² neighbourhood in ascending id with in-scan sums, R =
max(2, 1 + the drift so far); then the means and each pixel's snap key;
then one update a center, with the drift), is held bit-equal to the plain
version (``models/slic.py::_Grid``'s ``association``, ``center_means``,
``snap_keys``, ``move_centers`` and ``cell_drift``) and, over whole runs with
the early exit, to ``slic_device(..., impl="torch")``.  The grids cover
images that are not whole cells, S = 2, S larger than the image, a center
that loses every pixel, exact distance ties and a constant image that stops
early.  The twins take a metric: tests/test_torch_slic_delta_e.py holds
them to the plain pieces with the ΔE metrics.  Then the routing:
``impl="cuda"`` on a CPU tensor raises (with every metric), ``"auto"`` on
the CPU takes the plain version, and ``_download`` counts the iterations a
kernel-route call leaves on the device.  No JAX here."""

import contextlib
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu_torch.core.ciede2000 import (  # noqa: E402
    ciede2000_ref_square, ciede2000_square)
from various_image_processings_tpu_torch.core.pad import cdiv  # noqa: E402
from various_image_processings_tpu_torch.models import slic as P  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import slic as kslic  # noqa: E402

F32 = np.float32
BIG_KEY = np.iinfo(np.int64).max


def offsets(reach=2):
    """The (dy, dx) of a (2·reach + 1)² cell neighbourhood, in ascending
    center id: the 5×5 one at reach 2."""
    return [(dy, dx) for dy in range(-reach, reach + 1) for dx in range(-reach, reach + 1)]


@contextlib.contextmanager
def gather_5x5():
    """The plain route with its association held at the 5×5 neighbourhood
    whatever the drift: the JAX package's gather.  That is the port's one
    departure from the JAX package (the JAX package's windows past a drift
    of one cell, ROADMAP E, F4), so with it held off the rest of the port is
    still held to the JAX package on frames that drift two cells or more."""
    real = P._Grid.association

    def association(self, centers, labels, dists, reach=2):
        return real(self, centers, labels, dists, 2)

    with mock.patch.object(P._Grid, "association", association):
        yield


def twin_color(c_l, c_a, c_b, l, a, b, metric="euclidean"):
    """The kernels' colour distance of (center or mean, pixel), f32 arrays:
    the reference's euclidean one, or core/ciede2000's CPU function of the
    metric (the kernels take sqrt(a² + b²) once a side: the same operation,
    so the same value)."""
    if metric == "euclidean":
        dl = (c_l - l) * F32(2.55)
        da, db = c_a - a, c_b - b
        return dl * dl + da * da + db * db
    fn = {"ciede2000": ciede2000_square, "ciede2000_ref": ciede2000_ref_square}[metric]
    planes = np.broadcast_arrays(c_l, c_a, c_b, l, a, b)
    return fn(*(torch.from_numpy(np.ascontiguousarray(v, F32)) for v in planes)).numpy()


def twin_association(lab, centers, labels, dists, s, space_norm, color_norm,
                     metric="euclidean", reach=2):
    """Pixel-major association: every pixel's candidates of its cell's
    (2·reach + 1)² neighbourhood (≤25 at reach 2) in ascending id, strict <
    against the running (label, distance), (x, y, l, a, b, 1)
    added to a candidate's sums at its turn where it scans the pixel and the
    running label is its id.  → (labels, dists, changed, sums (N, 6) int64,
    pixels where a later candidate tied the running distance)."""
    h, w = labels.shape
    pc, pr = cdiv(h, s), cdiv(w, s)
    ys, xs = np.mgrid[0:h, 0:w]
    gy, gx = ys // s, xs // s
    xf, yf = xs.astype(F32), ys.astype(F32)
    lf, af, bf = (lab[..., k].astype(F32) for k in range(3))
    feats = [xs, ys, *(lab[..., k].astype(np.int64) for k in range(3)), np.ones_like(xs)]
    run_l, run_d = labels.copy(), dists.copy()
    sums = np.zeros((pc * pr, 6), np.int64)
    ties = 0
    for dy, dx in offsets(reach):
        ny, nx = gy + dy, gx + dx
        on_grid = (ny >= 0) & (ny < pc) & (nx >= 0) & (nx < pr)
        cid = np.where(on_grid, ny * pr + nx, 0)
        c = centers[cid]
        ddx, ddy = xf - c[..., 0], yf - c[..., 1]
        scanned = on_grid & (np.abs(ddx) <= F32(s)) & (np.abs(ddy) <= F32(s))
        color = twin_color(c[..., 2], c[..., 3], c[..., 4], lf, af, bf, metric)
        d = F32(space_norm) * (ddx * ddx + ddy * ddy) + F32(color_norm) * color
        ties += int((scanned & (d == run_d)).sum())
        better = scanned & (d < run_d)
        run_d = np.where(better, d, run_d)
        run_l = np.where(better, cid, run_l).astype(np.int32)
        member = scanned & (run_l == cid)
        for k, v in enumerate(feats):
            np.add.at(sums[:, k], cid[member], v[member])
    return run_l, run_d, bool((run_d < dists).any()), sums, ties


def twin_keys(lab, centers, labels, sums, metric="euclidean"):
    """Means floor(f32(sum) / f32(count)) (the state where count is 0), then
    each labelled pixel's floor(distance to its center's mean) * 2^32 +
    raster (signed: a ΔE² below 0 floors to -1), the least a center →
    (means (N, 3), keys (N,) int64)."""
    count = sums[:, 5]
    quotient = sums[:, 2:5].astype(F32) / np.maximum(count, 1).astype(F32)[:, None]
    means = np.where(count[:, None] > 0, np.floor(quotient), centers[:, 2:5])
    member = labels >= 0
    lbl = labels[member]
    m = means[lbl]
    pix = lab[member].astype(F32)
    key = np.floor(twin_color(*m.T, *pix.T, metric)).astype(np.int64)
    raster = np.flatnonzero(member.reshape(-1))
    keys = np.full(len(centers), BIG_KEY, np.int64)
    np.minimum.at(keys, lbl, key * (1 << 32) + raster)
    return means, keys


def twin_update(lab, centers, keys, s, width, per_row):
    """One thread a center: to the pixel of its least key, or kept; its
    Chebyshev drift in cells → (centers, max drift)."""
    out = centers.copy()
    has = keys < BIG_KEY
    first = keys[has] & 0xFFFFFFFF
    out[has, 0] = first % width
    out[has, 1] = first // width
    out[has, 2:] = lab.reshape(-1, 3)[first]
    c = np.arange(len(centers))
    drift = np.maximum(np.abs(out[:, 0].astype(np.int32) // s - c % per_row),
                       np.abs(out[:, 1].astype(np.int32) // s - c // per_row))
    return out, int(drift.max())


def twin_run(lab, s, num_iteration, color_scale, metric="euclidean"):
    """Whole runs as the kernels run them: each iteration active only if the
    last one changed a pixel, its association's reach 1 + the drift so far
    from a drift of two (the kernel's wide path) → (labels, centers, dists,
    drift, iterations run, tied pixels)."""
    h, w = lab.shape[:2]
    pc, pr = cdiv(h, s), cdiv(w, s)
    space_norm, color_norm = P._norms(s, color_scale)
    cx, cy, colors = P._init_centers(torch.from_numpy(lab).float(), h, w, s, pc, pr)
    centers = torch.cat([cx[:, None], cy[:, None], colors], 1).numpy()
    labels = np.full((h, w), -1, np.int32)
    dists = np.full((h, w), np.finfo(F32).max, F32)
    drift = ran = ties = 0
    for _ in range(num_iteration):
        labels, dists, changed, sums, tied = twin_association(
            lab, centers, labels, dists, s, space_norm, color_norm, metric, max(2, 1 + drift))
        _, keys = twin_keys(lab, centers, labels, sums, metric)
        centers, d = twin_update(lab, centers, keys, s, w, pr)
        drift, ran, ties = max(drift, d), ran + 1, ties + tied
        if not changed:
            break
    return labels, centers, dists, float(drift), ran, ties


def lab_image(kind, h, w, seed=0):
    """A Lab u8 image: the k-means takes any codes."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w]
        ramp = [(yy * 7 + xx * 3) % 256, (yy * 2 + 40) % 256, (xx * 5 + yy) % 256]
        return np.stack(ramp, -1).astype(np.uint8)
    if kind == "constant":
        return np.full((h, w, 3), 97, np.uint8)
    img = np.empty((h, w, 3), np.uint8)  # "two": two colors in vertical stripes
    img[:] = (20, 200, 60)
    img[:, (np.arange(w) // 3) % 2 == 1] = (220, 30, 140)
    return img


# (kind, height, width, S, iterations, color scale): images that are not
# whole cells (all but the two-color one), S = 2, S past the image, m = 1 and
# 40, two colors (ties), a constant image (early exit)
CASES = [
    ("random", 37, 53, 8, 5, 20.0),
    ("smooth", 23, 41, 7, 6, 40.0),
    ("random", 9, 11, 2, 4, 20.0),
    ("smooth", 13, 17, 40, 3, 20.0),
    ("random", 30, 45, 6, 6, 1.0),
    ("two", 24, 36, 6, 5, 20.0),
    ("constant", 26, 39, 13, 10, 20.0),
]


@pytest.mark.parametrize("displaced", [None, 0, 1])
@pytest.mark.parametrize("kind,h,w,s,iters,m", CASES)
def test_twin_iteration_equals_plain_pieces(kind, h, w, s, iters, m, displaced):
    """Three iterations from the init state: the twin equals each of the
    plain version's pieces bit for bit.  A center sitting on its own pixel
    never loses it, so a center that loses every pixel is made: before
    iteration ``displaced`` center 0 moves off the image, where no pixel is
    in its window.  Before the first iteration it then has no pixel at all
    (it keeps its state); before the second it keeps the labels of the first
    but no in-scan member (its mean is its state, and it snaps back)."""
    lab = lab_image(kind, h, w)
    grid = P._Grid(torch.from_numpy(lab), h, w, s, m, "euclidean")
    centers_t = grid.init_centers()
    labels_t = torch.full(grid.pix.shape[1:], -1, dtype=torch.int32)
    dists_t = torch.full(grid.pix.shape[1:], P._BIG, dtype=torch.float32)
    centers = centers_t.reshape(5, -1).T.numpy().copy()
    labels = np.full((h, w), -1, np.int32)
    dists = np.full((h, w), P._BIG, F32)
    for it in range(3):
        if it == displaced:
            centers[0, :2] = -3.0 * s
            centers_t[:2, 0, 0] = -3.0 * s
        labels_t, dists_t, changed_t, sums_t = grid.association(centers_t, labels_t, dists_t)
        labels, dists, changed, sums, _ = twin_association(lab, centers, labels, dists, s,
                                                           grid.space_norm, grid.color_norm)
        np.testing.assert_array_equal(labels, grid.from_blocks(labels_t).numpy())
        np.testing.assert_array_equal(dists, grid.from_blocks(dists_t).numpy())
        assert changed == bool(changed_t)
        np.testing.assert_array_equal(sums, sums_t.reshape(6, -1).T.numpy())

        means_t = grid.center_means(centers_t, sums_t)
        keys_t = grid.snap_keys(means_t, labels_t)
        means, keys = twin_keys(lab, centers, labels, sums)
        np.testing.assert_array_equal(means, means_t.reshape(5, -1)[2:].T.numpy())
        np.testing.assert_array_equal(keys, keys_t.numpy())
        if it == displaced:
            assert sums[0, 5] == 0 and (keys[0] == BIG_KEY) == (it == 0)

        new_t = grid.move_centers(centers_t, keys_t)
        assert torch.equal(new_t, grid.snap_centers(centers_t, means_t, labels_t))
        centers, drift = twin_update(lab, centers, keys, s, w, grid.pr)
        np.testing.assert_array_equal(centers, new_t.reshape(5, -1).T.numpy())
        assert drift == float(grid.cell_drift(new_t))
        centers_t = new_t


@pytest.mark.parametrize("kind,h,w,s,iters,m", CASES)
def test_twin_runs_equal_slic_device(kind, h, w, s, iters, m):
    lab = lab_image(kind, h, w)
    P.iterations = P.host_syncs = 0
    labels, centers, dists, drift = P.slic_device(torch.from_numpy(lab), h, w, s, iters, m,
                                                  impl="torch")
    want = twin_run(lab, s, iters, m)
    np.testing.assert_array_equal(want[0], labels.numpy())
    np.testing.assert_array_equal(want[1], centers.numpy())
    np.testing.assert_array_equal(want[2], dists.numpy())
    assert want[3] == float(drift)
    assert want[4] == P.iterations


def test_cases_cover_what_they_claim():
    """Each case of CASES shows the feature it is there for."""
    runs = {c[0]: twin_run(lab_image(c[0], *c[1:3]), *c[3:]) for c in CASES[-2:]}
    assert runs["two"][5] > 0             # exact distance ties
    assert runs["constant"][4] < 10       # the constant image stops early


def test_impl_cuda_on_a_cpu_tensor_raises():
    lab = torch.from_numpy(lab_image("random", 12, 12))
    with pytest.raises(ValueError, match="CUDA tensor"):
        P.slic_device(lab, 12, 12, 4, 2, 20.0, impl="cuda")


@pytest.mark.parametrize("metric", ["ciede2000", "ciede2000_ref"])
def test_impl_cuda_with_a_delta_e_metric_raises(metric):
    """The kernels take every metric, so ``impl="cuda"`` with a ΔE metric
    raises here for the CPU tensor alone, before any kernel is sought."""
    lab = torch.from_numpy(lab_image("random", 12, 12))
    before = dict(kslic.metric_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        P.slic_device(lab, 12, 12, 4, 2, 20.0, metric, impl="cuda")
    assert dict(kslic.metric_launches) == before


def test_unknown_impl_raises():
    lab = torch.from_numpy(lab_image("random", 12, 12))
    with pytest.raises(ValueError, match="impl"):
        P.slic_device(lab, 12, 12, 4, 2, 20.0, impl="triton")


def test_auto_on_the_cpu_runs_the_plain_version(monkeypatch):
    def no_kernels(*args, **kwargs):
        raise AssertionError("the kernel route was taken for a CPU tensor")

    monkeypatch.setattr(P, "_kmeans_cuda", no_kernels)
    lab = torch.from_numpy(lab_image("smooth", 20, 30))
    P.iterations = P.host_syncs = 0
    auto = P.slic_device(lab, 20, 30, 5, 3, 20.0)
    assert P.device_iterations is None and P.iterations >= 1
    assert P.host_syncs == P.iterations - 1  # the plain early exit reads on the host
    plain = P.slic_device(lab, 20, 30, 5, 3, 20.0, impl="torch")
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)


def test_kernel_wrappers_refuse_cpu_tensors():
    lab = torch.from_numpy(lab_image("random", 8, 8))
    centers = torch.zeros((4, 5))
    labels = torch.full((8, 8), -1, dtype=torch.int32)
    dists = torch.zeros((8, 8))
    sums = torch.zeros((4, 6), dtype=torch.int64)
    keys = torch.zeros(4, dtype=torch.int64)
    state = torch.zeros((3, 2), dtype=torch.int32)
    before = (kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kslic.associate(lab, centers, labels, dists, sums, state, 0, 4, 0.0625, 0.0025)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kslic.snap_keys(lab, centers, labels, sums, keys, state, 0, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kslic.update(lab, centers, keys, sums, state, 0, 4)
    assert before == (kslic.association_launches, kslic.snap_keys_launches,
                      kslic.update_launches)


def test_download_counts_the_device_iterations():
    """A kernel-route call leaves its iteration count on the device; the one
    download carries it and adds it to ``iterations``."""
    labels = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    lab = torch.from_numpy(lab_image("random", 3, 4))
    drift = torch.tensor(1.0)
    P.iterations = P.host_syncs = 0
    P.device_iterations = torch.tensor(7, dtype=torch.int32)
    raw, lab_host, drift_host = P._download(labels, lab, drift)
    assert P.iterations == 7 and P.host_syncs == 1 and P.device_iterations is None
    np.testing.assert_array_equal(raw, labels.numpy())
    np.testing.assert_array_equal(lab_host, lab.numpy())
    assert drift_host == 1.0
    P._download(labels, lab, drift)  # a plain call's download adds nothing
    assert P.iterations == 7 and P.host_syncs == 2
