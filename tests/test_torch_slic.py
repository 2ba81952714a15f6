"""The PyTorch port's SLIC (``models/slic.py``, ``ops/slic.py``, the CLI)
against the JAX package on the CPU.

- ``_init_centers``: bit-equal;
- one association pass, the means and the snap fed the JAX package's init
  state, against its first iteration: labels equal except where the port's
  two best candidate distances lie within ``TIE_ULP`` ulp (the pixels so
  excused are counted; on these inputs there are none), centers and drift
  equal, distances within ``DIST_ULP`` ulp (XLA on the CPU contracts a·b + c
  into an FMA inside a fusion; the port rounds every product);
- five iterations: the raw labels, centers and drift equal;
- ``enforce_connectivity``: equal to the JAX package's on the same raw labels;
- end to end: equal labels and equal ``last_max_drift_cells`` on the
  quadrant, uniform and three adversarial images of tests/test_slic.py, and
  on a seeded random and a seeded smooth image (there the criterion is
  equal labels, or else a boundary recall ≥ 0.95 at 2 px with a segment
  count within 5%; equal labels held), with the port's association held at
  the JAX package's 5×5 gather (``gather_5x5``); the port as it runs gives
  the same labels wherever the JAX package's centers drift at most one cell
  (past that its windows are the reference's, tests/test_torch_slic_windows.py);
- the invariant tests of tests/test_slic.py on the port, the drift guard
  included (the adversarial images drift three cells: the port's raw labels
  stay the reference loop's, and nothing warns); the CLI's two PNGs equal
  to the JAX CLI's from the same labels.

The JAX SLIC compiles once per (shape, S, iterations): this file uses four,
(60, 60, 30, 10), (64, 96, 32, 1), (64, 96, 32, 5) and (130, 130, 26, 10),
and caches every JAX result it uses."""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402
from scipy import ndimage  # noqa: E402

from various_image_processings_tpu.cli import slic as jcli  # noqa: E402
from various_image_processings_tpu.core.colors import bgr2lab_u8_exact as jax_lab  # noqa: E402
from various_image_processings_tpu.models import slic as J  # noqa: E402
from various_image_processings_tpu.ops import slic as jops  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.cli import slic as cli  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.models import slic as P  # noqa: E402
from test_torch_slic_kernel import gather_5x5  # noqa: E402
from test_torch_slic_windows import sequential_run  # noqa: E402

TIE_ULP = 4    # a label may differ only where the best two distances are this close
DIST_ULP = 4   # the distance map's allowance for XLA's FMA contraction
ADV = 130      # the adversarial images: 5x5 cells of S=26


def quadrant_image(size=60):
    img = np.zeros((size, size, 3), np.uint8)
    half = size // 2
    img[:half, :half] = (255, 0, 0)
    img[:half, half:] = (0, 255, 0)
    img[half:, :half] = (0, 0, 255)
    img[half:, half:] = (255, 255, 0)
    return img


def adversarial_images(h=ADV, w=ADV):
    """tests/test_slic.py's drift attempts: a diagonal ramp, an off-grid step
    and an off-grid radial gradient."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ramp = np.clip((yy + xx) * (255.0 / (h + w)), 0, 255).astype(np.uint8)
    step = np.full((h, w, 3), 10, np.uint8)
    step[:, 39:52] = 250
    rad = np.sqrt((yy - 17.0) ** 2 + (xx - 111.0) ** 2)
    rad = np.clip(rad * (255.0 / rad.max()), 0, 255).astype(np.uint8)
    return {"ramp": np.stack([ramp] * 3, -1), "step": step,
            "radial": np.stack([rad, rad[::-1], rad[:, ::-1]], -1)}


def smooth_image(h, w, seed=0):
    """A bicubic upsampling of a small random image: smooth color fields."""
    small = np.random.default_rng(seed).integers(0, 256, (6, 6, 3), dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


IMAGES = {
    "quadrant": (quadrant_image(), 30, 10),
    "uniform1": (np.full((64, 96, 3), 128, np.uint8), 32, 1),
    "uniform5": (np.full((64, 96, 3), 128, np.uint8), 32, 5),
    "random64_1": (random_image(64, 96), 32, 1),
    "smooth64_1": (smooth_image(64, 96, 1), 32, 1),
    "random64_5": (random_image(64, 96), 32, 5),
    "smooth64_5": (smooth_image(64, 96, 1), 32, 5),
    **{k: (v, 26, 10) for k, v in adversarial_images().items()},
    "random130": (random_image(ADV, ADV), 26, 10),
    "smooth130": (smooth_image(ADV, ADV), 26, 10),
}


@functools.cache
def jax_raw(name):
    """The JAX package's slic_device on IMAGES[name]: labels, centers,
    distances, drift (called as its SuperpixelSLIC calls it, so the two share
    one compile)."""
    img, s, it = IMAGES[name]
    h, w = img.shape[:2]
    out = J.slic_device(jnp.asarray(jax_lab(img)), h, w, s, it, 20.0, "euclidean")
    return tuple(np.asarray(a) for a in out)


@functools.cache
def jax_final(name):
    img, s, it = IMAGES[name]
    model = J.SuperpixelSLIC(*img.shape[:2], superpixel_size=s, num_iteration=it)
    return np.asarray(model.apply(img)), model.last_max_drift_cells


def port_final(name):
    img, s, it = IMAGES[name]
    model = vt.SuperpixelSLIC(*img.shape[:2], superpixel_size=s, num_iteration=it,
                              device="cpu")
    labels = model.apply(img)
    assert labels.dtype == torch.int32 and labels.device.type == "cpu"
    return labels.numpy(), model.last_max_drift_cells


def ulps(a, b):
    """|a − b| in units of the last place (both non-negative f32)."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def candidate_distance(lab, centers, y, x, c, s, m=20.0):
    """The port's association distance of pixel (y, x) to center c, op by
    op in f32 (each product and sum rounded alone)."""
    f = np.float32
    cx, cy, cl, ca, cb = centers[c]
    spatial = f(f((f(x) - cx) * (f(x) - cx)) + f((f(y) - cy) * (f(y) - cy)))
    dl = f(f(cl - f(lab[y, x, 0])) * f(2.55))
    da, db = f(ca - f(lab[y, x, 1])), f(cb - f(lab[y, x, 2]))
    color = f(f(f(dl * dl) + f(da * da)) + f(db * db))
    return f(f(f(1.0) / f(s * s)) * spatial) + f(f(f(1.0) / f(m * m)) * color)


def boundary_recall(ref, got, tol=2):
    def edges(lab):
        e = np.zeros(lab.shape, bool)
        e[:, :-1] |= lab[:, :-1] != lab[:, 1:]
        e[:-1, :] |= lab[:-1, :] != lab[1:, :]
        return e
    ref_e = edges(ref)
    near = ndimage.binary_dilation(edges(got), np.ones((2 * tol + 1,) * 2, bool))
    return (ref_e & near).sum() / max(ref_e.sum(), 1)


def one_pass(lab, centers0, h, w, s):
    grid = P._Grid(torch.from_numpy(lab), h, w, s, 20.0, "euclidean")
    centers = torch.from_numpy(centers0.T.copy()).view(5, grid.pc, grid.pr)
    labels = grid.to_blocks(torch.full((h, w), -1, dtype=torch.int32), -1)
    dists = grid.to_blocks(torch.full((h, w), P._BIG, dtype=torch.float32), P._BIG)
    labels, dists, changed, sums = grid.association(centers, labels, dists)
    centers = grid.snap_centers(centers, grid.center_means(centers, sums), labels)
    return (grid.from_blocks(labels).numpy(), centers.reshape(5, -1).T.numpy(),
            grid.from_blocks(dists).numpy(), float(grid.cell_drift(centers)), bool(changed))


# ---------------------------------------------------------------------------
# stages against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,s", [((64, 96), 32), ((37, 61), 16), ((5, 7), 2)])
def test_init_centers_bit_equal_to_jax(shape, s):
    h, w = shape
    lab = jax_lab(random_image(h, w))
    pc, pr = -(-h // s), -(-w // s)
    ours = P._init_centers(torch.from_numpy(lab).to(torch.float32), h, w, s, pc, pr)
    theirs = J._init_centers(jnp.asarray(lab, jnp.float32), h, w, s, pc, pr)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["random64_1", "smooth64_1"])
def test_one_pass_from_jax_init_state(name):
    """Association, means and snap fed the JAX package's init centers,
    against the state after its first iteration."""
    img, s, _ = IMAGES[name]
    h, w = img.shape[:2]
    lab = jax_lab(img)
    cx, cy, col = (np.asarray(a) for a in J._init_centers(
        jnp.asarray(lab, jnp.float32), h, w, s, -(-h // s), -(-w // s)))
    centers0 = np.concatenate([cx[:, None], cy[:, None], col], 1)
    labels, centers, dists, drift, changed = one_pass(lab, centers0, h, w, s)
    j_labels, j_centers, j_dists, j_drift = jax_raw(name)

    differ = np.argwhere(labels != j_labels)
    for y, x in differ:  # every difference must be a near-tie of the port's distances
        d_ours = candidate_distance(lab, centers0, y, x, labels[y, x], s)
        d_theirs = candidate_distance(lab, centers0, y, x, j_labels[y, x], s)
        assert ulps(d_ours, d_theirs) <= TIE_ULP, (y, x, d_ours, d_theirs)
    assert len(differ) == 0, f"{len(differ)} near-tie pixels"
    assert changed
    np.testing.assert_array_equal(centers, j_centers)
    assert drift == float(j_drift)
    assert ulps(dists, j_dists).max() <= DIST_ULP


def test_center_means_floor_the_f32_quotient():
    """Means are floor(f32(sum) / f32(count)) as the JAX package computes
    them, not the integer quotient: with a large count, k·count − 1 over
    count rounds up to k in f32 before the floor.  A center without pixels
    keeps its state."""
    counts = np.array([8193, 1, 3, 0, 676, 12000], np.int64)
    k = np.array([4095, 7, 5, 9, 3800, 1000], np.int64)
    sums = np.zeros((6, 1, 6), np.int64)
    sums[:5, 0] = k * counts - 1
    sums[5, 0] = counts
    centers = torch.full((5, 1, 6), -1.0)
    got = P._Grid.center_means(centers, torch.from_numpy(sums))[:, 0].numpy()
    f32 = np.float32
    want = np.floor(sums[:5, 0].astype(f32) / np.maximum(counts, 1).astype(f32))
    want[:, counts == 0] = -1.0
    np.testing.assert_array_equal(got, want)
    assert (got[:, counts > 0] != (sums[:5, 0] // np.maximum(counts, 1))[:, counts > 0]).any()


@pytest.mark.parametrize("name", ["random64_5", "smooth64_5"])
def test_five_iterations_match_jax(name):
    img, s, it = IMAGES[name]
    h, w = img.shape[:2]
    P.iterations = P.host_syncs = 0
    labels, centers, dists, drift = P.slic_device(torch.from_numpy(jax_lab(img)), h, w, s, it,
                                                  20.0)
    j_labels, j_centers, j_dists, j_drift = jax_raw(name)
    np.testing.assert_array_equal(labels.numpy(), j_labels)
    np.testing.assert_array_equal(centers.numpy(), j_centers)
    assert float(drift) == float(j_drift)
    assert ulps(dists.numpy(), j_dists).max() <= DIST_ULP
    # an early exit reads once an iteration, the last one excepted
    assert P.host_syncs == P.iterations - 1 and P.iterations <= it


@pytest.mark.parametrize("name", ["random130", "smooth130", "ramp"])
def test_enforce_connectivity_matches_jax(name):
    img, s, _ = IMAGES[name]
    raw = jax_raw(name)[0]
    lab = jax_lab(img)
    np.testing.assert_array_equal(P.enforce_connectivity(raw, lab, s),
                                  J.enforce_connectivity(raw, lab, s))


@pytest.mark.parametrize("metric", ["ciede2000", "ciede2000_ref"])
def test_enforce_connectivity_delta_e_matches_jax(metric):
    img, s, _ = IMAGES["smooth130"]
    raw = jax_raw("smooth130")[0]
    lab = jax_lab(img)
    np.testing.assert_array_equal(P.enforce_connectivity(raw, lab, s, metric),
                                  J.enforce_connectivity(raw, lab, s, metric))


def test_enforce_connectivity_merges_small_island():
    labels = np.zeros((20, 20), np.int32)
    labels[5:15, 5:15] = 1
    labels[9:11, 9:11] = 2  # a 4-pixel island inside label 1 (< 30²/20 = 45)
    lab = np.zeros((20, 20, 3), np.uint8)
    lab[labels == 1] = (100, 120, 130)
    lab[labels == 2] = (101, 121, 131)
    for impl in ("native", "numpy"):
        out = P.enforce_connectivity(labels, lab, sp_size=30, impl=impl)
        _, sizes, ncomp = P._components(out)
        assert sizes.min() >= 45 or ncomp <= 2
        np.testing.assert_array_equal(out, J.enforce_connectivity(labels, lab, sp_size=30))


# ---------------------------------------------------------------------------
# end to end against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["quadrant", "uniform1", "uniform5", "ramp", "step", "radial"])
def test_end_to_end_equal_to_jax(name):
    with gather_5x5():
        ours, drift = port_final(name)
    theirs, j_drift = jax_final(name)
    np.testing.assert_array_equal(ours, theirs)
    assert drift == j_drift
    if j_drift <= 1:  # the 5×5 gather held every window: the port as it runs agrees
        np.testing.assert_array_equal(port_final(name)[0], theirs)


@pytest.mark.parametrize("name", ["random130", "smooth130"])
def test_end_to_end_on_seeded_images(name):
    """Equal labels, or else recall ≥ 0.95 at 2 px and a segment count
    within 5% (equal labels held when this was written), the association
    held at the 5×5 gather; the port as it runs agrees where the JAX
    package's centers drift at most one cell."""
    with gather_5x5():
        ours, drift = port_final(name)
    theirs, j_drift = jax_final(name)
    assert drift == j_drift
    if not np.array_equal(ours, theirs):
        assert boundary_recall(theirs, ours) >= 0.95
        assert abs(int(ours.max()) - int(theirs.max())) <= 0.05 * (int(theirs.max()) + 1)
    if j_drift <= 1:
        np.testing.assert_array_equal(port_final(name)[0], ours)


# ---------------------------------------------------------------------------
# tests/test_slic.py's invariants, on the port
# ---------------------------------------------------------------------------

def test_quadrants_recovered_exactly():
    labels = vt.superpixel_slic(quadrant_image(60), superpixel_size=30, num_iteration=10,
                                device="cpu").numpy()
    assert labels.shape == (60, 60)
    quads = [labels[:30, :30], labels[:30, 30:], labels[30:, :30], labels[30:, 30:]]
    for quad in quads:
        assert (quad == quad[0, 0]).all()
    assert len({int(q[0, 0]) for q in quads}) == 4


def test_uniform_image_single_iteration_gives_grid():
    labels = vt.superpixel_slic(np.full((64, 96, 3), 128, np.uint8), superpixel_size=32,
                                num_iteration=1, device="cpu").numpy()
    expected = (np.arange(64)[:, None] // 32) * 3 + (np.arange(96)[None, :] // 32)
    np.testing.assert_array_equal(labels, expected)


def test_uniform_image_many_iterations_invariants():
    labels = vt.superpixel_slic(np.full((64, 96, 3), 128, np.uint8), superpixel_size=32,
                                num_iteration=5, device="cpu").numpy()
    assert labels.min() == 0
    _, sizes, ncomp = P._components(labels)
    assert ncomp == labels.max() + 1
    assert sizes.min() >= (32 * 32) // 20
    assert ncomp <= 12


def test_labels_cover_all_pixels_and_are_connected():
    """tests/test_slic.py runs this on lenna at 128×128 (absent here): a
    smooth seeded image of that size instead."""
    labels = vt.superpixel_slic(smooth_image(128, 128, 3), superpixel_size=16, num_iteration=5,
                                device="cpu").numpy()
    assert labels.min() >= 0
    n = labels.max() + 1
    assert 30 <= n <= 150
    _, sizes, ncomp = P._components(labels)
    assert ncomp == n
    assert sizes.min() >= (16 * 16) // 20


def test_slic_shape_and_argument_validation():
    slic = vt.SuperpixelSLIC(32, 32, 16, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        slic.apply(np.zeros((16, 32, 3), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        slic.apply(np.zeros((32, 32, 3), np.float32))
    with pytest.raises(ValueError, match=">= 2"):
        vt.SuperpixelSLIC(32, 32, 1, device="cpu")
    with pytest.raises(ValueError, match="metric"):
        vt.SuperpixelSLIC(32, 32, 16, metric="manhattan", device="cpu")
    with pytest.raises(RuntimeError, match="apply"):
        slic.get_label()


def test_get_label_returns_the_applied_tensor():
    slic = vt.SuperpixelSLIC(64, 96, 32, 2, device="cpu")
    labels = slic.apply(torch.from_numpy(random_image(64, 96)))
    assert slic.get_label() is labels


def test_default_device_is_the_card():
    """Without a GPU the default device="cuda" raises; nothing runs on the
    CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        vt.superpixel_slic(quadrant_image())
    with pytest.raises(RuntimeError, match="CUDA"):
        vt.SuperpixelSLIC(60, 60)


def test_drift_guard_within_bound_on_smooth_image():
    """tests/test_slic.py measures this on lenna (absent here).  A smooth
    image drifts at most one cell, the bound within which the JAX package's
    5×5 gather holds every window and the two give the same labels."""
    img = smooth_image(ADV, ADV, 5)
    model = vt.SuperpixelSLIC(ADV, ADV, superpixel_size=26, num_iteration=10, device="cpu")
    model.apply(img)
    assert model.last_max_drift_cells is not None
    assert model.last_max_drift_cells <= 1.0


def test_drift_guard_adversarial_gradient_images():
    """tests/test_slic.py's drift attempts drift the port's centers three
    cells (the JAX package's two: its 5×5 gather misses the windows that
    move them further).  The association widens with the drift, so the raw
    labels stay the reference loop's and nothing warns."""
    for img in adversarial_images().values():
        model = vt.SuperpixelSLIC(ADV, ADV, superpixel_size=26, num_iteration=10, device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            model.apply(img)  # raises if anything warns
        lab = jax_lab(img)
        raw, _, _, drift = P.slic_device(torch.from_numpy(lab), ADV, ADV, 26, 10, 20.0)
        assert float(drift) == model.last_max_drift_cells
        np.testing.assert_array_equal(raw.numpy(), sequential_run(lab, 26, 10, 20.0)[0])


def test_drift_warning_fires_when_bound_exceeded(monkeypatch):
    """The JAX package warns past two cells, where its 5×5 gather misses
    windows.  The port's association widens with the drift instead, so a
    reading forced to 3 is reported, nothing warns, and the labels are the
    unforced call's."""
    real = P.slic_device

    def fake(*args, **kwargs):
        labels, centers, dists, _ = real(*args, **kwargs)
        return labels, centers, dists, torch.tensor(3.0)

    img = random_image(64, 96)
    want = vt.SuperpixelSLIC(64, 96, superpixel_size=32, num_iteration=2, device="cpu").apply(img)
    monkeypatch.setattr(P, "slic_device", fake)
    model = vt.SuperpixelSLIC(64, 96, superpixel_size=32, num_iteration=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        labels = model.apply(img)
    assert model.last_max_drift_cells == 3.0
    assert labels.shape == (64, 96)
    assert torch.equal(labels, want)


@pytest.mark.parametrize("metric", ["ciede2000", "ciede2000_ref"])
def test_slic_with_delta_e_metrics(metric):
    img = np.zeros((40, 40, 3), np.uint8)
    img[:20] = (255, 0, 0)
    img[20:] = (0, 0, 255)
    labels = vt.superpixel_slic(img, superpixel_size=20, num_iteration=3, metric=metric,
                                device="cpu").numpy()
    assert labels.shape == (40, 40)
    assert not set(labels[:20].ravel().tolist()) & set(labels[20:].ravel().tolist())


def test_one_host_read_for_the_outputs(monkeypatch):
    """apply() reads the raw labels, the Lab image and the drift back in one
    copy, and once an iteration for the early exit."""
    P.host_syncs = P.iterations = 0
    vt.superpixel_slic(random_image(64, 96), 32, 3, device="cpu")
    assert P.iterations == 3
    assert P.host_syncs == 3  # 2 early-exit reads + 1 download


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_the_jax_clis_pngs(tmp_path, monkeypatch, capsys):
    """Both CLIs write the mean-color and contour PNGs; from the same labels
    they are byte-equal."""
    img = smooth_image(64, 96, 9)
    src = tmp_path / "in.png"
    cv2.imwrite(str(src), img)
    monkeypatch.chdir(tmp_path)
    assert cli.main([str(src), "32", "3", "20", "--device", "cpu"]) == 0
    ours = {k: (tmp_path / f"in_slic_{k}.png").read_bytes() for k in ("mean", "contour")}
    labels = vt.superpixel_slic(img, 32, 3, 20.0, device="cpu").numpy()
    assert f"superpixels: {labels.max() + 1}" in capsys.readouterr().out

    monkeypatch.setattr(jops, "superpixel_slic", lambda *a, **k: labels)
    for k in ("mean", "contour"):
        (tmp_path / f"in_slic_{k}.png").unlink()
    jcli.main([str(src), "32", "3", "20"])
    for k in ("mean", "contour"):
        assert (tmp_path / f"in_slic_{k}.png").read_bytes() == ours[k]
    np.testing.assert_array_equal(cli.draw_contour(labels), jcli.draw_contour(labels))
    np.testing.assert_array_equal(cli.draw_superpixel(img, labels),
                                  jcli.draw_superpixel(img, labels))
