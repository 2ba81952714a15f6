"""The port's plain versions at the first window past each kernel's old
one-tile limit, against golden/ on a tiny image.  On the card the kernels
take these windows in bands of their halo tiles and are held bit-equal to
exactly these plain versions (tests/test_torch_cuda.py, chip_smoke.py).
Tolerances are each pair's own: 0, or 1 u8 for the guide, whose exp is
torch's here and numpy's in golden/."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu import golden  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops import bilateral_texture as tbt  # noqa: E402

SHAPE = (3, 4)


def diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


def test_plain_bilateral_at_k221_bit_exact_to_golden():
    """k = 221: the self filter's old limit was 219."""
    src = random_image(*SHAPE)
    got = vt.bilateral_filter(src, 221, 10.0, 30.0, impl="torch", device="cpu")
    assert diff(got.numpy(), golden.bilateral_filter(src, 221, 10.0, 30.0)).max() == 0


def test_plain_joint_bilateral_at_k151_bit_exact_to_golden():
    """k = 151: the joint filter's old limit was 149."""
    src = random_image(*SHAPE)
    guide = src[::-1].copy()
    got = vt.joint_bilateral_filter(src, guide, 151, 10.0, 30.0, impl="torch", device="cpu")
    want = golden.joint_bilateral_filter(src, guide, 151, 10.0, 30.0)
    assert diff(got.numpy(), want).max() == 0


def test_plain_abf_at_k179_bit_exact_to_golden():
    """k = 179: the adaptive filter's old limit was 177."""
    src = random_image(*SHAPE)
    got = vt.adaptive_bilateral_filter(src, 179, 10.0, 30.0, impl="torch", device="cpu")
    assert diff(got.numpy(), golden.adaptive_bilateral_filter(src, 179, 10.0, 30.0)).max() == 0


@pytest.mark.parametrize("ksize", [121, 223])
def test_plain_blur_rtv_and_guide_past_the_old_limits(ksize):
    """k = 121 (blur + mRTV's old limit was 119) and 223 (the guide's was
    221): blur + mRTV bit-equal to golden/, the guide within 1."""
    src = random_image(*SHAPE)
    mag = golden.gradient(src)
    blurred_g, rtv_g = golden.compute_blur_and_rtv(src, mag, ksize)
    blurred, rtv = tbt._blur_and_rtv_math(torch.from_numpy(src).float(), torch.from_numpy(mag),
                                          ksize)
    np.testing.assert_array_equal(blurred.numpy(), blurred_g)
    np.testing.assert_array_equal(rtv.numpy(), rtv_g)
    guide = tbt._guide_math(torch.from_numpy(blurred_g), torch.from_numpy(rtv_g), ksize)
    assert diff(guide.numpy(), golden.compute_guide(blurred_g, rtv_g, ksize)).max() <= 1


def test_plain_btf_at_k77_within_the_golden_envelope():
    """A k = 77 BTF runs its joint filter at k′ = 153, past the joint
    filter's old limit of 149; the JAX path's end-to-end envelope."""
    src = random_image(*SHAPE)
    got = vt.bilateral_texture_filter(src, 77, 1, impl="torch", device="cpu")
    d = diff(got.numpy(), golden.bilateral_texture_filter(src, ksize=77, nitr=1))
    assert np.percentile(d, 99.9) <= 2 and d.max() <= 3
