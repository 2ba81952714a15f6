"""The PyTorch port's border-replicated integral image and window sums on the
CPU, against golden/ (exact), the JAX ops (exact for integer sources,
rtol 1e-5 for f32, whose cumsums may add in another order) and brute force
over every window of a 5×5 image (exact for integers, rtol 1e-2 for f32, the
reference's own bound)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu.golden.integral_image import (  # noqa: E402
    BorderReplicatedIntegralImage as GoldenII)
from various_image_processings_tpu.ops.integral_image import (  # noqa: E402
    integral_image as jax_integral_image, window_sums as jax_window_sums)
from various_image_processings_tpu_torch.core.rng import random_array  # noqa: E402
from various_image_processings_tpu_torch.ops.integral_image import (  # noqa: E402
    integral_image, window_sums)

SIZE = 5


def brute_force_sum(src, x0, y0, x1, y1):
    h, w = src.shape[:2]
    total = np.zeros(src.shape[2], np.float64)
    for y in range(y0, y1 + 1):
        for x in range(x0, x1 + 1):
            total += src[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]
    return total


def corner_sum(ii, r, x0, y0, x1, y1):
    """The 4-corner window sum over padded coordinates, as golden's get()."""
    return (ii[y1 + r + 1, x1 + r + 1] - ii[y1 + r + 1, x0 + r]
            - ii[y0 + r, x1 + r + 1] + ii[y0 + r, x0 + r])


def all_windows(radius):
    for y0 in range(-radius, SIZE + radius):
        for x0 in range(-radius, SIZE + radius):
            for y1 in range(y0, min(y0 + 2 * radius + 1, SIZE + radius)):
                for x1 in range(x0, min(x0 + 2 * radius + 1, SIZE + radius)):
                    yield x0, y0, x1, y1


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("radius", [1, 4])
def test_integral_and_window_sums_match_golden_and_jax(radius, dtype):
    src = random_array(20 * 15 * 3).reshape(20, 15, 3).astype(dtype)
    golden_ii = GoldenII(src, radius)
    ii = integral_image(src, radius, device="cpu")
    ws = window_sums(torch.from_numpy(src), radius)
    assert ii.dtype == torch.int32 and ws.dtype == torch.int32
    np.testing.assert_array_equal(ii.numpy(), golden_ii.buffer)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(jax_integral_image(src, radius)))
    np.testing.assert_array_equal(ws.numpy(), golden_ii.window_sums(radius))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jax_window_sums(src, radius)))


@pytest.mark.parametrize("window_radius", [0, 2, 3])
def test_smaller_window_and_2d_source_match_jax(window_radius):
    src = random_array(11 * 9).reshape(11, 9)
    ii = integral_image(src, 3, device="cpu")
    assert tuple(ii.shape) == (11 + 7, 9 + 7)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(jax_integral_image(src, 3)))
    np.testing.assert_array_equal(window_sums(src, 3, window_radius, device="cpu").numpy(),
                                  np.asarray(jax_window_sums(src, 3, window_radius)))


@pytest.mark.parametrize("radius", [1, 3])
def test_u16_as_int32_exact_against_brute_force(radius):
    src = random_array(SIZE * SIZE * 2, 40000, np.uint16).reshape(SIZE, SIZE, 2)
    ii = integral_image(src.astype(np.int32), radius, device="cpu")
    assert ii.dtype == torch.int32
    ii = ii.numpy()
    for x0, y0, x1, y1 in all_windows(radius):
        np.testing.assert_array_equal(corner_sum(ii, radius, x0, y0, x1, y1),
                                      brute_force_sum(src, x0, y0, x1, y1))
    ws = window_sums(src.astype(np.int32), radius, device="cpu").numpy()
    for y in range(SIZE):
        for x in range(SIZE):
            np.testing.assert_array_equal(
                ws[y, x], brute_force_sum(src, x - radius, y - radius, x + radius, y + radius))


@pytest.mark.parametrize("radius", [1, 3])
def test_f32_within_rtol_of_brute_force_and_jax(radius):
    src = random_array(SIZE * SIZE * 3, 255.0, np.float32).reshape(SIZE, SIZE, 3)
    ii = integral_image(src, radius, device="cpu")
    assert ii.dtype == torch.float32
    ii = ii.numpy()
    np.testing.assert_allclose(ii, np.asarray(jax_integral_image(src, radius)), rtol=1e-5)
    for x0, y0, x1, y1 in all_windows(radius):
        np.testing.assert_allclose(corner_sum(ii, radius, x0, y0, x1, y1),
                                   brute_force_sum(src, x0, y0, x1, y1), rtol=1e-2)
    np.testing.assert_allclose(window_sums(src, radius, device="cpu").numpy(),
                               np.asarray(jax_window_sums(src, radius)), rtol=1e-5)


def test_int32_sums_wrap_like_jax_and_windows_stay_exact():
    """A 4-corner difference in int32 is exact even where the running total
    has wrapped past 2³¹, as the reference's and JAX's int32 tables are."""
    src = np.full((300, 300, 1), 2 ** 16, np.int32)
    ii = integral_image(src, 1, device="cpu")
    assert ii.dtype == torch.int32
    np.testing.assert_array_equal(ii.numpy(), np.asarray(jax_integral_image(src, 1)))
    np.testing.assert_array_equal(window_sums(src, 1, device="cpu").numpy(),
                                  np.full((300, 300, 1), 9 * 2 ** 16, np.int32))


def test_numpy_input_without_a_device_runs_on_the_gpu_or_raises():
    src = random_array(8 * 8).reshape(8, 8)
    if torch.cuda.is_available():
        assert integral_image(src, 1).is_cuda
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            integral_image(src, 1)
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            window_sums(src, 1)
