"""The port's class API (``core/device_image.py::DeviceImage``, the filter
modules' ``warmup()``) against the functional ops, after
tests/test_class_api.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402

CPU = "cpu"


def test_device_image_roundtrip():
    src = random_image(20, 30)
    img = vt.DeviceImage.from_array(src, device=CPU)
    np.testing.assert_array_equal(img.download(), src)
    assert tuple(img.get().shape) == (20, 30, 3) and img.get().dtype == torch.uint8
    src[0, 0] = ~src[0, 0]  # the buffer is a copy, not a view of the array
    assert not np.array_equal(img.download(), src)
    with pytest.raises(ValueError, match="shape"):
        img.upload(np.zeros((21, 30, 3), np.uint8))
    with pytest.raises(ValueError, match="shape"):
        img.set(torch.zeros((20, 30, 1), dtype=torch.uint8))
    img.set(torch.ones((20, 30, 3), dtype=torch.uint8))
    assert int(img.download().sum()) == 20 * 30 * 3


def test_device_image_two_dimensional_and_float():
    gray = np.arange(12, dtype=np.float32).reshape(3, 4)
    img = vt.DeviceImage.from_array(gray, device=CPU)
    assert img.shape == (3, 4, 1) and img.dtype == torch.float32
    np.testing.assert_array_equal(img.download()[:, :, 0], gray)
    img.upload(torch.zeros((3, 4)))
    assert not img.download().any()
    blank = vt.DeviceImage(5, 6, device=CPU)
    assert blank.download().shape == (5, 6, 3) and not blank.download().any()


def test_device_image_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        vt.DeviceImage(4, 4)


@pytest.mark.parametrize("make", [
    lambda: vt.BilateralFilter(40, 40, 9, 10.0, 30.0, device=CPU),
    lambda: vt.AdaptiveBilateralFilter(40, 40, 9, device=CPU),
    lambda: vt.BilateralTextureFilter(40, 40, ksize=5, nitr=1, device=CPU)])
def test_warmup_returns_self(make):
    module = make()
    assert module.warmup() is module


def test_bilateral_filter_class_matches_op():
    src = random_image(40, 40)
    f = vt.BilateralFilter(40, 40, 9, 10.0, 30.0, device=CPU).warmup()
    out = f(src)
    assert torch.equal(out, vt.bilateral_filter(src, 9, 10.0, 30.0, device=CPU))
    # a DeviceImage's buffer goes in as it is
    assert torch.equal(out, f(vt.DeviceImage.from_array(src, device=CPU).get()))


def test_adaptive_and_btf_classes_fed_device_images_match_ops():
    src = random_image(32, 32)
    buf = vt.DeviceImage.from_array(src, device=CPU).get()
    abf = vt.AdaptiveBilateralFilter(32, 32, 9, device=CPU).warmup()
    assert torch.equal(abf(buf), vt.adaptive_bilateral_filter(src, 9, device=CPU))
    btf = vt.BilateralTextureFilter(32, 32, ksize=5, nitr=1, device=CPU).warmup()
    assert torch.equal(btf.execute(buf), vt.bilateral_texture_filter(src, 5, 1, device=CPU))


def test_slic_fed_a_device_image_matches_op():
    src = random_image(64, 96)
    buf = vt.DeviceImage.from_array(src, device=CPU).get()
    labels = vt.SuperpixelSLIC(64, 96, 32, 3, device=CPU).apply(buf)
    assert torch.equal(labels, vt.superpixel_slic(src, 32, 3, device=CPU))
