"""The PyTorch port's bilateral / joint bilateral filters on the CPU: the
plain version against golden/ (bit-exact) and against the JAX package's xla
and pallas paths (±1 u8, the JAX path's own contract), plus validation and
dispatch.  The CUDA kernel itself is tested on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from various_image_processings_tpu import golden  # noqa: E402
from various_image_processings_tpu.ops import bilateral as jbf  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops import bilateral as tbf  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral as cuda_bf  # noqa: E402
from various_image_processings_tpu_torch.ops._dispatch import resolve_impl  # noqa: E402


def max_diff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def images(shape):
    src = random_image(*shape)
    return src, src[::-1].copy()


@pytest.mark.parametrize("shape", [(50, 50), (37, 61), (8, 5)])
@pytest.mark.parametrize("ksize", [1, 3, 9, 11, 17, 27])
def test_plain_bilateral_bit_exact_to_golden(shape, ksize):
    src, _ = images(shape)
    out = vt.bilateral_filter(src, ksize, 10.0, 30.0)
    assert out.dtype == torch.uint8 and tuple(out.shape) == src.shape
    assert max_diff(out.numpy(), golden.bilateral_filter(src, ksize, 10.0, 30.0)) == 0


@pytest.mark.parametrize("shape", [(50, 50), (37, 61), (8, 5)])
@pytest.mark.parametrize("ksize", [1, 3, 9, 11, 17, 27])
def test_plain_joint_bilateral_bit_exact_to_golden(shape, ksize):
    src, guide = images(shape)
    out = vt.joint_bilateral_filter(src, guide, ksize, 10.0, 30.0)
    expected = golden.joint_bilateral_filter(src, guide, ksize, 10.0, 30.0)
    assert max_diff(out.numpy(), expected) == 0


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"), ("reflect101", "rint")])
@pytest.mark.parametrize("shape,ksize,sigmas", [((37, 61), 9, (10.0, 30.0)),
                                                ((41, 57), 17, (8.0, 3.0 ** 0.5)),
                                                ((8, 5), 17, (8.0, 3.0 ** 0.5))])
def test_plain_matches_jax_bilateral_math(border, rounding, shape, ksize, sigmas):
    src, guide = images(shape)
    expected = jbf._bilateral_math(jnp.asarray(src, jnp.float32), jnp.asarray(guide, jnp.float32),
                                   ksize, *sigmas, border, rounding, strict=True)
    got = tbf._bilateral_math(torch.from_numpy(src), torch.from_numpy(guide), ksize, *sigmas,
                              border, rounding)
    assert max_diff(got.numpy(), expected) <= 1


def test_plain_matches_jax_pallas_k9():
    src, _ = images((50, 50))
    expected = jbf.bilateral_filter(src, 9, 10.0, 30.0, impl="pallas")
    assert max_diff(vt.bilateral_filter(src, 9, 10.0, 30.0).numpy(), expected) <= 1


def test_plain_matches_jax_pallas_joint_k17():
    src, guide = images((41, 57))
    expected = jbf.joint_bilateral_filter(src, guide, 17, 10.0, 30.0, impl="pallas")
    got = vt.joint_bilateral_filter(src, guide, 17, 10.0, 30.0)
    assert max_diff(got.numpy(), expected) <= 1


def test_float_inputs_and_strict_give_the_same_result():
    src, guide = images((37, 61))
    s, g = torch.from_numpy(src), torch.from_numpy(guide)
    ref = tbf._bilateral_math(s, g, 9, 10.0, 30.0)
    for strict in (False, True):
        got = tbf._bilateral_math(s.float(), g.float(), 9, 10.0, 30.0, strict=strict)
        assert torch.equal(got, ref)


def test_tensor_input_stays_and_numpy_input_goes_to_device():
    src, _ = images((8, 5))
    t = torch.from_numpy(src)
    assert vt.bilateral_filter(t, 3).device == t.device
    assert vt.bilateral_filter(src, 3, device="cpu").device.type == "cpu"


def test_ksize_1_is_identity():
    src = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    np.testing.assert_array_equal(vt.bilateral_filter(src, ksize=1).numpy(), src)


# -- validation: the same types and messages as tests/test_validation.py --

def test_rejects_2d_image():
    with pytest.raises(ValueError, match="color image"):
        vt.bilateral_filter(np.zeros((8, 8), np.uint8))


def test_rejects_f32_image():
    with pytest.raises(TypeError, match="uint8"):
        vt.bilateral_filter(np.zeros((8, 8, 3), np.float32))


@pytest.mark.parametrize("ksize", [8, 0, -3])
def test_rejects_bad_ksize(ksize):
    with pytest.raises(ValueError, match="odd"):
        vt.bilateral_filter(np.zeros((8, 8, 3), np.uint8), ksize=ksize)
    with pytest.raises(ValueError, match="odd"):
        vt.joint_bilateral_filter(np.zeros((8, 8, 3), np.uint8),
                                  np.zeros((8, 8, 3), np.uint8), ksize=ksize)


def test_rejects_mismatched_guide():
    with pytest.raises(ValueError, match="same shape"):
        vt.joint_bilateral_filter(np.zeros((8, 8, 3), np.uint8), np.zeros((9, 8, 3), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        vt.joint_bilateral_filter(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8, 3), np.int16))


def test_rejects_bad_impl():
    with pytest.raises(ValueError, match="impl"):
        vt.bilateral_filter(np.zeros((8, 8, 3), np.uint8), impl="pallas")


def test_rejects_bad_border_and_rounding():
    x = torch.zeros((8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="border"):
        tbf._bilateral_math(x, x, 3, 10.0, 30.0, border="wrap")
    with pytest.raises(ValueError, match="rounding"):
        tbf._bilateral_math(x, x, 3, 10.0, 30.0, rounding="ceil")


def test_auto_on_a_cpu_tensor_is_the_plain_version():
    assert resolve_impl("auto", torch.zeros(1)) == "torch"
    assert resolve_impl("torch", torch.zeros(1)) == "torch"


def test_cuda_impl_on_a_cpu_tensor_raises():
    with pytest.raises(ValueError, match="CUDA tensor"):
        vt.bilateral_filter(np.zeros((8, 8, 3), np.uint8), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        resolve_impl("cuda", torch.zeros(1))


def test_kernel_wrapper_rejects_a_cpu_tensor_before_building():
    x = torch.zeros((8, 8, 3), dtype=torch.uint8)
    taps, lut = cuda_bf.device_tables(3, 10.0, 30.0, x.device)
    launches = cuda_bf.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_bf.joint_bilateral(x, None, taps, lut, 1)
    assert cuda_bf.launches == launches
