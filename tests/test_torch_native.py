"""The port's native loader (``utils/native.py``) against the JAX package's
on the same inputs, and the port's NumPy connectivity paths against its
native ones.

The JAX package's own library (``native/build/libvip_native.so``, which its
loader builds with ``make``) is not there on every machine.  So each result
of the port's library is held to the JAX package's NumPy path for it, with
that loader made to report no library: ``models/slic.py::_components`` for
the components, ``enforce_connectivity``'s Python merge for the merge and
the fused connectivity pass, ``core/colors.py::bgr2lab_u8_exact``'s integer
path for Lab.  Where the JAX package's library is built, each is also held
to it, as before."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu.core import colors as jcolors  # noqa: E402
from various_image_processings_tpu.models import slic as jslic  # noqa: E402
from various_image_processings_tpu.utils import native as jnative  # noqa: E402
from various_image_processings_tpu_torch.core.colors import _lab_tables  # noqa: E402
from various_image_processings_tpu_torch.models import slic  # noqa: E402
from various_image_processings_tpu_torch.utils import native  # noqa: E402

LABEL_MAPS = [(0, (60, 50), 6), (1, (37, 83), 12), (2, (128, 128), 40), (3, (1, 9), 3)]
# a superpixel size S for each min_area (S² // 20) the merge is run at
SP_SIZE = {0: 4, 5: 10, 33: 26}


def label_map(seed, shape, nlabels):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, nlabels, size=shape).astype(np.int32)
    lab = rng.randint(0, 255, size=shape + (3,)).astype(np.uint8)
    return labels, lab


def block_label_map(seed, shape, nlabels):
    """Labels in 6×6 blocks with 3% of the pixels relabelled at random: the
    fragments a k-means leaves, fewer than in pure noise."""
    labels, lab = label_map(seed, shape, nlabels)
    blocks = np.kron(labels[::6, ::6], np.ones((6, 6), np.int32))[:shape[0], :shape[1]]
    noise = np.random.RandomState(seed + 100).rand(*shape) < 0.03
    return np.where(noise, labels, blocks).astype(np.int32), lab


def jax_numpy_path(fn, *args):
    """``fn(*args)`` of the JAX package with its native library reported
    absent, so it takes its NumPy path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_lib", lambda: None)
        return fn(*args)


def numpy_component_sums(comp, lab, ncomp):
    """Per-component (x, y, l, a, b, count) int64 sums, by bincount."""
    ys, xs = np.indices(comp.shape)
    flat = comp.reshape(-1)
    planes = [xs, ys, *np.moveaxis(lab.astype(np.int64), -1, 0), np.ones(comp.shape, np.int64)]
    return np.stack([np.bincount(flat, weights=p.reshape(-1), minlength=ncomp)
                     for p in planes], 1).astype(np.int64)


@pytest.mark.parametrize("seed,shape,nlabels", LABEL_MAPS)
def test_ccl_and_component_sums_match_jax_loader(seed, shape, nlabels):
    labels, lab = label_map(seed, shape, nlabels)
    comp, ncomp = native.ccl_4conn(labels)
    sums = native.component_sums(comp, lab, ncomp)
    jcomp, jsizes, jncomp = jax_numpy_path(jslic._components, labels)
    assert ncomp == jncomp
    np.testing.assert_array_equal(comp, jcomp)
    np.testing.assert_array_equal(sums, numpy_component_sums(jcomp, lab, jncomp))
    np.testing.assert_array_equal(sums[:, 5], jsizes)
    if jnative.available():
        jcomp, jncomp = jnative.ccl_4conn(labels)
        assert ncomp == jncomp
        np.testing.assert_array_equal(comp, jcomp)
        np.testing.assert_array_equal(sums, jnative.component_sums(jcomp, lab, jncomp))


@pytest.mark.parametrize("seed,shape,nlabels", LABEL_MAPS)
@pytest.mark.parametrize("min_area", [0, 5, 33])
def test_merge_and_fused_connectivity_match_jax_loader(seed, shape, nlabels, min_area):
    """The merge is held through the labels it gives (``_compact`` of its
    roots over the components), the fused pass directly."""
    labels, lab = label_map(seed, shape, nlabels)
    assert SP_SIZE[min_area] ** 2 // 20 == min_area
    comp, ncomp = native.ccl_4conn(labels)
    sums = native.component_sums(comp, lab, ncomp)
    sizes = sums[:, 5]
    means = sums[:, 2:5] // sizes[:, None]
    merged = native.slic_merge(comp, means, sizes, min_area)
    fused = native.slic_connectivity(labels, lab, min_area)
    want = jax_numpy_path(jslic.enforce_connectivity, labels, lab, SP_SIZE[min_area])
    np.testing.assert_array_equal(slic._compact(merged, comp), want)
    np.testing.assert_array_equal(fused, want)
    if jnative.available():
        np.testing.assert_array_equal(merged, jnative.slic_merge(comp, means, sizes, min_area))
        np.testing.assert_array_equal(fused, jnative.slic_connectivity(labels, lab, min_area))


def test_lab_matches_jax_loader():
    img = np.random.default_rng(5).integers(0, 256, (61, 37, 3), dtype=np.uint8)
    tables = _lab_tables()
    lab = native.bgr2lab_u8(img, *tables)
    np.testing.assert_array_equal(lab, jax_numpy_path(jcolors.bgr2lab_u8_exact, img))
    if jnative.available():
        np.testing.assert_array_equal(lab, jnative.bgr2lab_u8(img, *tables))


@pytest.mark.parametrize("seed,shape,nlabels", LABEL_MAPS)
def test_numpy_components_match_native(seed, shape, nlabels):
    labels, _ = label_map(seed, shape, nlabels)
    comp_n, sizes_n, ncomp_n = slic._components(labels, "native")
    comp_p, sizes_p, ncomp_p = slic._components(labels, "numpy")
    assert ncomp_n == ncomp_p
    np.testing.assert_array_equal(comp_n, comp_p)
    np.testing.assert_array_equal(sizes_n, sizes_p)


@pytest.mark.parametrize("metric,make", [
    ("euclidean", label_map), ("euclidean", block_label_map),
    ("ciede2000", block_label_map), ("ciede2000_ref", block_label_map)])
@pytest.mark.parametrize("seed,shape,nlabels", LABEL_MAPS[:3])
def test_numpy_connectivity_matches_native(seed, shape, nlabels, metric, make):
    """impl="numpy" (scipy components, NumPy sums, Python merge) equals the
    native path: the fused C++ call for euclidean, native components and
    sums with the Python merge for the ΔE metrics."""
    labels, lab = make(seed, shape, nlabels)
    np.testing.assert_array_equal(
        slic.enforce_connectivity(labels, lab, 30, metric, impl="native"),
        slic.enforce_connectivity(labels, lab, 30, metric, impl="numpy"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a compiler that fails raises, and nothing is left behind."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_compiler", lambda: "false")
    with pytest.raises(RuntimeError, match="failed"):
        native._build(tmp_path / "libvip_native_test.so")
    assert list(tmp_path.iterdir()) == []


def test_bad_inputs_raise():
    labels, lab = label_map(0, (6, 5), 3)
    with pytest.raises(ValueError, match="does not match"):
        native.slic_connectivity(labels, lab[:, :4], 1)
    with pytest.raises(ValueError, match="component ids"):
        native.component_sums(labels, lab, 2)


class FakeLibc:
    def __init__(self):
        self.calls = []

    def mallopt(self, param, value):
        self.calls.append((param, value))
        return 1


def test_the_slic_pass_keeps_freed_memory_and_the_loader_does_not(monkeypatch):
    """SLIC's connectivity pass owns glibc's allocator policy: its first call
    tells glibc to serve blocks of up to 1 GiB from the heap and to keep up
    to that much freed, and later calls tell it nothing more; loading the
    runtime tells it nothing.  A C library without ``mallopt`` is left as
    it is."""
    import ctypes

    libc, real = FakeLibc(), ctypes.CDLL
    monkeypatch.setattr(ctypes, "CDLL", lambda name, *a, **k: libc if name is None
                        else real(name, *a, **k))
    labels = np.zeros((8, 8), np.int32)
    lab = np.zeros((8, 8, 3), np.uint8)
    native.load_library.cache_clear()
    slic._keep_freed_memory.cache_clear()
    try:
        native.load_library()
        assert libc.calls == []
        for impl in ("native", "numpy", "native"):
            slic.enforce_connectivity(labels, lab, 4, impl=impl)
        assert libc.calls == [(-3, 1 << 30), (-1, 1 << 30)]
        monkeypatch.setattr(ctypes, "CDLL", lambda name, *a, **k: object())
        slic._keep_freed_memory.cache_clear()
        slic._keep_freed_memory()  # no mallopt: nothing to do, no error
    finally:
        native.load_library.cache_clear()
        slic._keep_freed_memory.cache_clear()
