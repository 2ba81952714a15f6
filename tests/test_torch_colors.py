"""The port's Lab conversions (``core/colors.py``) against the JAX package's
and OpenCV's.

- ``_lab_tables``: equal to the JAX package's;
- ``bgr2lab_u8_exact`` (integer torch ops): equal to the JAX package's on
  seeded images, and to ``cv2.cvtColor`` on all 2²⁴ colors;
- the float ``bgr2lab_u8``: within ±1 code of the JAX package's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from various_image_processings_tpu.core import colors as jcolors  # noqa: E402
from various_image_processings_tpu_torch.core import colors  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402


def all_colors() -> np.ndarray:
    """Every 24-bit BGR color once, as a 4096×4096 image."""
    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


def test_lab_tables_match_jax():
    for ours, theirs in zip(colors._lab_tables(), jcolors._lab_tables()):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("shape", [(1, 1), (37, 61), (64, 96), (3, 5, 7)])
def test_bgr2lab_exact_matches_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    ours = colors.bgr2lab_u8_exact(torch.from_numpy(img))
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == img.shape
    np.testing.assert_array_equal(ours.numpy(), jcolors.bgr2lab_u8_exact(img))


def test_bgr2lab_exact_matches_opencv_on_every_color():
    """All 2²⁴ BGR colors, in four bands of rows to bound the memory."""
    img = all_colors()
    ref = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
    for rows in np.array_split(np.arange(4096), 4):
        band = img[rows[0]:rows[-1] + 1]
        np.testing.assert_array_equal(colors.bgr2lab_u8_exact(torch.from_numpy(band)).numpy(),
                                      ref[rows[0]:rows[-1] + 1])


def test_bgr2lab_float_within_one_of_jax():
    img = random_image(64, 96)
    ours = colors.bgr2lab_u8(torch.from_numpy(img)).numpy().astype(np.int32)
    theirs = np.asarray(jcolors.bgr2lab_u8(img)).astype(np.int32)
    assert np.abs(ours - theirs).max() <= 1
