"""The port's native loader (``utils/native.py``) against the JAX package's
on the same inputs, and the port's NumPy connectivity paths against its
native ones."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu.utils import native as jnative  # noqa: E402
from various_image_processings_tpu_torch.core.colors import _lab_tables  # noqa: E402
from various_image_processings_tpu_torch.models import slic  # noqa: E402
from various_image_processings_tpu_torch.utils import native  # noqa: E402

LABEL_MAPS = [(0, (60, 50), 6), (1, (37, 83), 12), (2, (128, 128), 40), (3, (1, 9), 3)]


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


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")


@pytest.mark.parametrize("seed,shape,nlabels", LABEL_MAPS)
def test_ccl_and_component_sums_match_jax_loader(seed, shape, nlabels):
    labels, lab = label_map(seed, shape, nlabels)
    comp, ncomp = native.ccl_4conn(labels)
    jcomp, jncomp = jnative.ccl_4conn(labels)
    assert ncomp == jncomp
    np.testing.assert_array_equal(comp, jcomp)
    np.testing.assert_array_equal(native.component_sums(comp, lab, ncomp),
                                  jnative.component_sums(jcomp, lab, jncomp))


@pytest.mark.parametrize("seed,shape,nlabels", LABEL_MAPS)
@pytest.mark.parametrize("min_area", [0, 5, 33])
def test_merge_and_fused_connectivity_match_jax_loader(seed, shape, nlabels, min_area):
    labels, lab = label_map(seed, shape, nlabels)
    comp, ncomp = native.ccl_4conn(labels)
    sums = native.component_sums(comp, lab, ncomp)
    sizes = sums[:, 5]
    means = sums[:, 2:5] // sizes[:, None]
    np.testing.assert_array_equal(native.slic_merge(comp, means, sizes, min_area),
                                  jnative.slic_merge(comp, means, sizes, min_area))
    np.testing.assert_array_equal(native.slic_connectivity(labels, lab, min_area),
                                  jnative.slic_connectivity(labels, lab, min_area))


def test_lab_matches_jax_loader():
    img = np.random.default_rng(5).integers(0, 256, (61, 37, 3), dtype=np.uint8)
    tables = _lab_tables()
    np.testing.assert_array_equal(native.bgr2lab_u8(img, *tables),
                                  jnative.bgr2lab_u8(img, *tables))


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
