"""The port's CUDA kernel on the card, held bit-exact to its plain PyTorch
version.  Every test here needs an NVIDIA GPU and skips without one; this
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops.bilateral import _bilateral_math  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral as cuda_bf  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def images(shape, device):
    src = random_image(*shape)
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(src[::-1].copy()).to(device))


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"), ("reflect101", "rint")])
@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("ksize", [1, 3, 9, 17, 27])
@pytest.mark.parametrize("shape", [(37, 61), (8, 5)])
def test_kernel_bit_exact_to_plain(cuda, shape, ksize, joint, border, rounding):
    src, guide = images(shape, cuda)
    got = cuda_bf.bilateral(src, guide if joint else None, ksize, 10.0, 30.0, border, rounding)
    expected = _bilateral_math(src, guide if joint else src, ksize, 10.0, 30.0,
                               border, rounding)
    torch.cuda.synchronize()
    assert torch.equal(got, expected)


def test_auto_on_a_cuda_tensor_launches_the_kernel(cuda):
    src, guide = images((50, 50), cuda)
    before = cuda_bf.launches
    out = vt.bilateral_filter(src, 9, 10.0, 30.0)
    out_joint = vt.joint_bilateral_filter(src, guide, 9, 10.0, 30.0)
    module = vt.BilateralFilter(50, 50).to(cuda)
    out_module = module(src)
    assert cuda_bf.launches == before + 3
    assert torch.equal(out, _bilateral_math(src, src, 9, 10.0, 30.0))
    assert torch.equal(out_joint, _bilateral_math(src, guide, 9, 10.0, 30.0))
    assert torch.equal(out_module, out)
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  vt.bilateral_filter(src.cpu().numpy(), 9, 10.0, 30.0).numpy())


def test_op_makes_views_contiguous_and_wrapper_rejects_them(cuda):
    src, _ = images((40, 64), cuda)
    view = src[:, ::2]
    np.testing.assert_array_equal(vt.bilateral_filter(view, 5).cpu().numpy(),
                                  vt.bilateral_filter(view.cpu().numpy(), 5).numpy())
    taps, lut = cuda_bf.device_tables(5, 10.0, 30.0, src.device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bf.joint_bilateral(view, None, taps, lut, 2)
    with pytest.raises(TypeError, match="uint8"):
        cuda_bf.joint_bilateral(src.float(), None, taps, lut, 2)


def test_too_large_a_halo_tile_raises(cuda):
    src, _ = images((8, 8), cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_bf.bilateral(src, None, 301, 10.0, 30.0)
