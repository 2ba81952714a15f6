"""The PyTorch port's Gaussian pyramid (``ops/pyramid.py``) against the
OpenCV oracle and the JAX package's ``pyr_down`` / ``pyr_up``, on the CPU.

The u8 path is a bit-exact twin of OpenCV's fixed-point pyramid, so the u8
cases assert equality (the cases of tests/test_pyramid.py, odd destination
sizes included); the f32 path is held to 1e-3, as the JAX tests hold theirs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from various_image_processings_tpu.ops import pyramid as jpyr  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops.pyramid import pyr_down, pyr_up  # noqa: E402


def down(img):
    return pyr_down(torch.from_numpy(img)).numpy()


def up(img, out_shape=None):
    return pyr_up(torch.from_numpy(img), out_shape).numpy()


@pytest.mark.parametrize("shape", [(64, 64), (50, 70), (51, 71), (3, 5), (4, 4), (2, 5), (1, 1)])
def test_pyr_down_bit_exact_vs_opencv_and_jax(shape):
    src = random_image(*shape)
    ours = down(src)
    np.testing.assert_array_equal(ours, np.asarray(jpyr.pyr_down(src)))
    if min(shape) >= 3:  # below 3 rows the JAX package's f32 path is the spec
        np.testing.assert_array_equal(ours, cv2.pyrDown(src))


@pytest.mark.parametrize("shape", [(32, 32), (25, 35), (3, 4)])
def test_pyr_up_bit_exact_vs_opencv_and_jax(shape):
    src = random_image(*shape)
    ours = up(src)
    np.testing.assert_array_equal(ours, cv2.pyrUp(src))
    np.testing.assert_array_equal(ours, np.asarray(jpyr.pyr_up(src)))


@pytest.mark.parametrize("shape", [(26, 18), (13, 27)])
def test_pyr_up_odd_dst_bit_exact(shape):
    h, w = shape
    src = random_image(h, w)
    for oh, ow in [(2 * h - 1, 2 * w), (2 * h, 2 * w - 1), (2 * h - 1, 2 * w - 1)]:
        ours = up(src, (oh, ow))
        np.testing.assert_array_equal(ours, cv2.pyrUp(src, dstsize=(ow, oh)))
        np.testing.assert_array_equal(ours, np.asarray(jpyr.pyr_up(src, out_shape=(oh, ow))))


@pytest.mark.parametrize("shape", [(13, 9), (8, 11), (3, 3)])
def test_pyr_up_odd_larger_dst_bit_exact(shape):
    """cv::pyrUp's 2n+1 destination: the extra row duplicates row 2n−2, the
    extra column column 2n−1."""
    h, w = shape
    src = random_image(h, w)
    for oh, ow in [(2 * h + 1, 2 * w), (2 * h, 2 * w + 1), (2 * h + 1, 2 * w + 1),
                   (2 * h - 1, 2 * w + 1), (2 * h + 1, 2 * w - 1)]:
        ours = up(src, (oh, ow))
        np.testing.assert_array_equal(ours, cv2.pyrUp(src, dstsize=(ow, oh)))
        np.testing.assert_array_equal(ours, np.asarray(jpyr.pyr_up(src, out_shape=(oh, ow))))


def test_pyr_up_odd_larger_dst_float():
    src = (np.random.RandomState(3).rand(9, 7, 3) * 255).astype(np.float32)
    for oh, ow in [(19, 14), (18, 15), (19, 15)]:
        ours = up(src, (oh, ow))
        assert ours.shape == (oh, ow, 3) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, cv2.pyrUp(src, dstsize=(ow, oh)), atol=1e-3)
        np.testing.assert_allclose(ours, np.asarray(jpyr.pyr_up(src, out_shape=(oh, ow))),
                                   atol=1e-3)


def test_pyr_up_dst_beyond_legal_range_raises():
    with pytest.raises(ValueError, match="legal range"):
        up(random_image(8, 8), (18, 16))


def test_pyr_roundtrip_fuzz_bit_exact():
    rng = np.random.RandomState(42)
    for _ in range(6):
        h = int(rng.randint(3, 60))
        w = int(rng.randint(3, 60))
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        np.testing.assert_array_equal(down(img), cv2.pyrDown(img))
        d = cv2.pyrDown(img)
        np.testing.assert_array_equal(up(d, (h, w)), cv2.pyrUp(d, dstsize=(w, h)))
        np.testing.assert_array_equal(up(d, (h, w)), np.asarray(jpyr.pyr_up(d, out_shape=(h, w))))


def test_pyr_up_crops_to_requested_shape():
    assert up(random_image(51, 35), (101, 69)).shape == (101, 69, 3)


@pytest.mark.parametrize("shape", [(40, 40), (37, 61)])
def test_gray_bit_exact(shape):
    """The Wexler mask pyramid goes through the 2-D (gray) path."""
    src = random_image(*shape)[:, :, 0].copy()
    np.testing.assert_array_equal(down(src), cv2.pyrDown(src))
    np.testing.assert_array_equal(down(src), np.asarray(jpyr.pyr_down(src)))
    h, w = src.shape
    np.testing.assert_array_equal(up(down(src), (h, w)),
                                  cv2.pyrUp(cv2.pyrDown(src), dstsize=(w, h)))


def test_float_path_close_to_opencv_and_jax():
    src = random_image(20, 24).astype(np.float32)
    out = down(src)
    assert out.shape == (10, 12, 3) and out.dtype == np.float32
    assert np.abs(out - cv2.pyrDown(src)).max() < 1e-3
    assert np.abs(out - np.asarray(jpyr.pyr_down(src))).max() < 1e-3
