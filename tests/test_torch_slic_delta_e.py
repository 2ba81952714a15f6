"""SLIC's k-means with the CIEDE2000 metrics ("ciede2000", "ciede2000_ref")
on the CPU: the port against the JAX package, and the kernels' formulation.

- The port's ``slic_device(..., metric, impl="torch")`` against the JAX
  ``slic_device(..., metric=...)`` on a 64×96 smooth image, S=16, 5
  iterations: labels, centers and drift equal, distances within
  ``DIST_RTOL`` and ``DIST_ATOL`` (the transcendentals of XLA and of PyTorch's CPU build
  differ by ulps).
- The NumPy pixel-major twin of the kernels (``tests/test_torch_slic_kernel.py``,
  with a metric: its ΔE is core/ciede2000's CPU function, center or mean
  first, pixel second, as csrc/slic_kmeans.cu takes them) bit-equal to
  ``_Grid``'s pieces, iteration by iteration, and to whole
  ``slic_device(impl="torch")`` runs, on the kernel tests' ``CASES`` (ties,
  a center that loses its pixels, S past the image, an early stop).
  PyTorch's CPU ``pow`` and ``atan2`` round differently in their vector
  loop (Sleef) and in the scalar loop that takes a tensor's tail, so there
  one pair's ΔE bits depend on where it lies in its tensor, which differs
  between the twin's layout and ``_Grid``'s blocked one.  For the bit-equal
  checks both sides therefore take the same function evaluated with every
  value in the vector loop (``vector_loop``); with the unmodified function
  the twin's labels, centers, drift and iterations still equal the plain
  route's and its distances are within ``CPU_LAYOUT_RTOL`` and
  ``CPU_LAYOUT_ATOL``.
- The kernels' CIEDE2000 constants (csrc/slic_kmeans.cu) are the plain
  version's f32 values, and the wrappers refuse what the kernels do not take.
- The D1b repair of core/ciede2000.py (a true division by a 0-d tensor
  where a Python float was) leaves the CPU's bits unchanged.

The JAX SLIC compiles once a metric (~20 s each); its results are cached."""

import functools
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one chunk a CPU op: ``vector_loop`` relies on it
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from various_image_processings_tpu.models import slic as J  # noqa: E402
from various_image_processings_tpu_torch.core import ciede2000  # noqa: E402
from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact  # noqa: E402
from various_image_processings_tpu_torch.models import slic as P  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import slic as kslic  # noqa: E402
from test_torch_slic_kernel import (  # noqa: E402
    BIG_KEY, CASES, F32, lab_image, twin_association, twin_keys, twin_run, twin_update)

METRICS = ["ciede2000", "ciede2000_ref"]
FUNCTIONS = {"ciede2000": ciede2000.ciede2000_square,
             "ciede2000_ref": ciede2000.ciede2000_ref_square}
DIST_RTOL = 1e-5       # port vs JAX distances, relative (measured ≤ 7.9e-6)
DIST_ATOL = 1e-12      # and absolute, where the port's is 0 (equal colours) and XLA's ~4e-14
# the unmodified function's distances, twin vs plain route (measured: ≤ 4.7e-6
# relative; ≤ 1.2e-10 where one side is 0, the other a ΔE of equal colours whose
# two hue angles came from different loops)
CPU_LAYOUT_RTOL, CPU_LAYOUT_ATOL = 1e-5, 1e-9
VECTOR = 64            # a multiple of every CPU vector loop's step (2 × 16 f32 on AVX-512)
JAX_CASE = (64, 96, 16, 5, 20.0)  # height, width, S, iterations, m


def vector_loop(fn):
    """``fn`` of six f32 planes, evaluated with every value in PyTorch's
    CPU vector loop: the planes broadcast, flattened and padded with zeros
    to a multiple of ``VECTOR`` values, so no value falls into a scalar
    tail loop.  Each value's bits then depend on that value alone."""
    def run(*planes):
        planes = torch.broadcast_tensors(*(torch.as_tensor(np.asarray(p, F32)) if not
                                           isinstance(p, torch.Tensor) else p for p in planes))
        n, shape = planes[0].numel(), planes[0].shape
        flat = [torch.nn.functional.pad(p.reshape(-1), (0, -n % VECTOR)) for p in planes]
        return fn(*flat)[:n].reshape(shape)
    return run


@pytest.fixture
def in_vector_loop(monkeypatch):
    """``_Grid`` and the twin both take the ΔE functions through ``vector_loop``."""
    stable = {m: vector_loop(fn) for m, fn in FUNCTIONS.items()}
    monkeypatch.setattr(ciede2000, "ciede2000_square", stable["ciede2000"])
    monkeypatch.setattr(ciede2000, "ciede2000_ref_square", stable["ciede2000_ref"])
    import test_torch_slic_kernel as kernel_tests
    monkeypatch.setattr(kernel_tests, "ciede2000_square", stable["ciede2000"])
    monkeypatch.setattr(kernel_tests, "ciede2000_ref_square", stable["ciede2000_ref"])


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

def smooth_image(h, w, seed=0):
    """A bicubic upsampling of a small random image: smooth color fields."""
    small = np.random.default_rng(seed).integers(0, 256, (6, 6, 3), dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


@functools.cache
def jax_case_lab():
    h, w = JAX_CASE[:2]
    return bgr2lab_u8_exact(torch.from_numpy(smooth_image(h, w, 1))).numpy()


@functools.cache
def jax_run(metric):
    h, w, s, iters, m = JAX_CASE
    out = J.slic_device(jnp.asarray(jax_case_lab()), h, w, s, iters, m, metric)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("metric", METRICS)
def test_delta_e_kmeans_matches_jax(metric):
    h, w, s, iters, m = JAX_CASE
    labels, centers, dists, drift = P.slic_device(torch.from_numpy(jax_case_lab()), h, w, s,
                                                  iters, m, metric, impl="torch")
    j_labels, j_centers, j_dists, j_drift = jax_run(metric)
    np.testing.assert_array_equal(labels.numpy(), j_labels)
    np.testing.assert_array_equal(centers.numpy(), j_centers)
    assert float(drift) == float(j_drift)
    np.testing.assert_allclose(dists.numpy(), j_dists, rtol=DIST_RTOL, atol=DIST_ATOL)


# ---------------------------------------------------------------------------
# the kernels' formulation: the twin against the plain pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("displaced", [None, 0, 1])
@pytest.mark.parametrize("kind,h,w,s,iters,m", CASES)
@pytest.mark.parametrize("metric", METRICS)
def test_twin_iteration_equals_plain_pieces(in_vector_loop, metric, kind, h, w, s, iters, m,
                                            displaced):
    """Three iterations from the init state, each piece bit-equal, with
    center 0 moved off the image before iteration ``displaced`` (as in
    tests/test_torch_slic_kernel.py)."""
    lab = lab_image(kind, h, w)
    grid = P._Grid(torch.from_numpy(lab), h, w, s, m, metric)
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
                                                           grid.space_norm, grid.color_norm,
                                                           metric)
        np.testing.assert_array_equal(labels, grid.from_blocks(labels_t).numpy())
        np.testing.assert_array_equal(dists, grid.from_blocks(dists_t).numpy())
        assert changed == bool(changed_t)
        np.testing.assert_array_equal(sums, sums_t.reshape(6, -1).T.numpy())

        means_t = grid.center_means(centers_t, sums_t)
        keys_t = grid.snap_keys(means_t, labels_t)
        means, keys = twin_keys(lab, centers, labels, sums, metric)
        np.testing.assert_array_equal(means, means_t.reshape(5, -1)[2:].T.numpy())
        np.testing.assert_array_equal(keys, keys_t.numpy())
        if it == displaced:
            assert sums[0, 5] == 0 and (keys[0] == BIG_KEY) == (it == 0)

        new_t = grid.move_centers(centers_t, keys_t)
        centers, drift = twin_update(lab, centers, keys, s, w, grid.pr)
        np.testing.assert_array_equal(centers, new_t.reshape(5, -1).T.numpy())
        assert drift == float(grid.cell_drift(new_t))
        centers_t = new_t


@pytest.mark.parametrize("kind,h,w,s,iters,m", CASES)
@pytest.mark.parametrize("metric", METRICS)
def test_twin_runs_equal_slic_device(in_vector_loop, metric, kind, h, w, s, iters, m):
    lab = lab_image(kind, h, w)
    P.iterations = 0
    got = P.slic_device(torch.from_numpy(lab), h, w, s, iters, m, metric, impl="torch")
    want = twin_run(lab, s, iters, m, metric)
    for a, b in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(a, b.numpy())
    assert want[3] == float(got[3]) and want[4] == P.iterations


@pytest.mark.parametrize("metric", METRICS)
def test_twin_runs_near_the_unmodified_plain_route(metric):
    """Without ``vector_loop``: the same labels, centers, drift and
    iterations; distances within ``CPU_LAYOUT_RTOL`` and ``CPU_LAYOUT_ATOL``."""
    for kind, h, w, s, iters, m in CASES:
        lab = lab_image(kind, h, w)
        P.iterations = 0
        labels, centers, dists, drift = P.slic_device(torch.from_numpy(lab), h, w, s, iters, m,
                                                      metric, impl="torch")
        want = twin_run(lab, s, iters, m, metric)
        np.testing.assert_array_equal(want[0], labels.numpy())
        np.testing.assert_array_equal(want[1], centers.numpy())
        np.testing.assert_allclose(want[2], dists.numpy(), rtol=CPU_LAYOUT_RTOL,
                                   atol=CPU_LAYOUT_ATOL)
        assert want[3] == float(drift) and want[4] == P.iterations


def test_snap_key_of_a_negative_delta_e_is_signed(monkeypatch):
    """A ΔE² that rounds below 0 floors to -1: the packed key is
    -2^32 + raster, below every key of a distance ≥ 0, in the plain version
    and in the twin alike (both given the distance -1e-6 at raster 4, 5
    elsewhere)."""
    import test_torch_slic_kernel as kernel_tests
    h, w = 2, 3
    lab = lab_image("random", h, w)
    grid = P._Grid(torch.from_numpy(lab), h, w, 4, 20.0, "ciede2000")
    grid.color_dist = lambda *planes: torch.where(grid.flat_index == 4, -1e-6, 5.0)
    labels = grid.to_blocks(torch.zeros((h, w), dtype=torch.int32), -1)
    centers = grid.init_centers()
    keys = grid.snap_keys(centers, labels)
    assert int(keys[0]) == -(1 << 32) + 4
    monkeypatch.setattr(kernel_tests, "twin_color", lambda *planes: np.where(
        np.arange(h * w) == 4, F32(-1e-6), F32(5.0)))
    sums = np.zeros((1, 6), np.int64)  # no member: the mean is the state
    _, twin = twin_keys(lab, centers.reshape(5, -1).T.numpy(), np.zeros((h, w), np.int32), sums,
                        "ciede2000")
    np.testing.assert_array_equal(twin, keys.numpy())


# ---------------------------------------------------------------------------
# the D1b repair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
def test_true_division_leaves_the_cpu_bits_unchanged(monkeypatch, metric):
    """On seeded pairs (drawn as tests/test_torch_ciede2000.py draws them)
    and the kernel tests' CASES as pairs: the function divides by a 0-d tensor;
    with ``torch.tensor`` giving back its value it divides by the Python
    float, as it did before.  The CPU divides both ways, so the bits agree."""
    v = np.random.default_rng(7).integers(-255, 256, (6, 1 << 14)).astype(F32)
    pix = np.concatenate([lab_image(kind, h, w).reshape(-1, 3) for kind, h, w, *_ in CASES])
    pairs = np.concatenate([v, np.concatenate([pix[::-1], pix], 1).T.astype(F32)], 1)
    fn = FUNCTIONS[metric]
    now = fn(*torch.from_numpy(pairs))
    with monkeypatch.context() as mp:
        mp.setattr(ciede2000.torch, "tensor", lambda value, device=None: value)
        before = fn(*torch.from_numpy(pairs))
    assert torch.equal(now, before)


# ---------------------------------------------------------------------------
# the kernels' constants and the wrappers' checks
# ---------------------------------------------------------------------------

CSRC = Path(P.__file__).resolve().parents[1] / "csrc" / "slic_kmeans.cu"


def nearest_f32(text):
    """The f32 a C compiler makes of the decimal literal ``text``."""
    exact = Fraction(text)
    x = np.float32(float(text))
    near = [np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))]
    return min(near, key=lambda c: abs(Fraction(float(c)) - exact))


def test_kernel_constants_are_the_plain_versions():
    """Each metric's hue period, half period and degree map at 30, 6, 63,
    275 and 25 degrees; the decimal literals of the ΔE function round to the
    f32 PyTorch makes of the same Python numbers."""
    src = CSRC.read_text()
    for struct, full, half, deg in (
            ("Ciede2000", ciede2000._TWO_PI, ciede2000._PI, ciede2000._deg),
            ("Ciede2000Ref", ciede2000._deg_ref(360.0), ciede2000._deg_ref(180.0),
             ciede2000._deg_ref)):
        body = re.search(rf"struct {struct} {{(.*?)}};", src, re.S).group(1)
        got = {name: float.fromhex(v) for name, v in
               re.findall(r"(k\w+) = (0x[0-9a-f.p+-]+)f;", body)}
        assert got == {"kFull": full, "kHalf": half,
                       **{f"kDeg{d}": deg(float(d)) for d in (30, 6, 63, 275, 25)}}
    body = src[src.index("float delta_e_square("):src.index("// The colour distance of")]
    literals = set(re.findall(r"(?<![\w.])(\d+\.\d+)f\b", body))
    assert {"0.17", "0.24", "0.32", "0.20", "0.015", "0.045", "7.0"} <= literals
    pow25 = re.search(r"kPow25To7 = (\d+\.\d+)f;", src).group(1)
    assert float(pow25) == ciede2000._POW25_7
    for text in literals | {pow25}:
        assert nearest_f32(text) == np.float32(float(text))


def test_wrappers_refuse_cpu_tensors_and_unknown_metrics():
    planes = [torch.zeros(4) for _ in range(6)]
    before = kslic.delta_e_launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        kslic.delta_e(*planes, "ciede2000")
    with pytest.raises(ValueError, match="CIEDE2000 metrics only"):
        kslic.delta_e(*planes, "euclidean")
    with pytest.raises(ValueError, match="unknown SLIC metric"):
        kslic.delta_e(*planes, "cie76")
    lab = torch.from_numpy(lab_image("random", 8, 8))
    with pytest.raises(ValueError, match="unknown SLIC metric"):
        kslic.associate(lab, torch.zeros((4, 5)), torch.full((8, 8), -1, dtype=torch.int32),
                        torch.zeros((8, 8)), torch.zeros((4, 6), dtype=torch.int64),
                        torch.zeros((3, 2), dtype=torch.int32), 0, 4, 0.0625, 0.0025, "cie76")
    with pytest.raises(ValueError, match="unknown SLIC metric"):
        kslic.snap_keys(lab, torch.zeros((4, 5)), torch.full((8, 8), -1, dtype=torch.int32),
                        torch.zeros((4, 6), dtype=torch.int64), torch.zeros(4, dtype=torch.int64),
                        torch.zeros((3, 2), dtype=torch.int32), 0, 4, "cie76")
    assert kslic.delta_e_launches == before
