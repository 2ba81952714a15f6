"""The PyTorch port's gradient magnitude on the CPU: the plain version
against golden/ (u8 bit-exact, f32 within 4 ulp as tests/test_gradient.py
holds the JAX path) and against the JAX package's xla and pallas paths, plus
validation and dispatch.  The CUDA kernel itself is tested on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu import golden  # noqa: E402
from various_image_processings_tpu.ops.gradient import gradient as jax_gradient  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_array  # noqa: E402
from various_image_processings_tpu_torch.ops.gradient import _gradient  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import gradient as cuda_grad  # noqa: E402


def source(shape, dtype):
    n = int(np.prod(shape))
    if dtype is np.float32:
        return random_array(n, 255.0, np.float32).reshape(shape)
    return random_array(n).reshape(shape)


def within_4_ulp(got, expected):
    got, expected = np.asarray(got), np.asarray(expected)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(expected)))
    return bool(np.all(np.abs(got - expected) <= 4 * ulp))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(50, 50), (8, 5), (1, 1)])
def test_plain_u8_bit_exact_to_golden(shape, channels):
    src = source((*shape, channels), np.uint8)
    out = vt.gradient(src, device="cpu")
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    np.testing.assert_array_equal(out.numpy(), golden.gradient(src))


@pytest.mark.parametrize("channels", [1, 3])
def test_plain_f32_within_4_ulp_of_golden(channels):
    src = source((50, 50, channels), np.float32)
    out = vt.gradient(src, device="cpu").numpy()
    assert out.dtype == np.float32
    assert within_4_ulp(out, golden.gradient(src))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("channels", [1, 3])
def test_plain_matches_jax(impl, dtype, channels):
    src = source((37, 61, channels), dtype)
    expected = np.asarray(jax_gradient(src, impl=impl))
    assert within_4_ulp(vt.gradient(src, device="cpu").numpy(), expected)


def test_2d_input_is_one_channel():
    src = source((30, 30), np.uint8)
    out = vt.gradient(src, device="cpu").numpy()
    np.testing.assert_array_equal(out, golden.gradient(src))
    assert within_4_ulp(out, np.asarray(jax_gradient(src, impl="xla")))


def test_u8_and_its_f32_copy_give_the_same_result():
    src = source((37, 61, 3), np.uint8)
    t = torch.from_numpy(src)
    assert torch.equal(_gradient(t, "torch"), _gradient(t.float(), "torch"))


def test_rejects_bad_dtype_and_rank():
    with pytest.raises(TypeError):
        vt.gradient(np.zeros((4, 4), np.int16), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        vt.gradient(np.zeros((2, 4, 4, 3), np.uint8), device="cpu")


def test_cuda_impl_on_a_cpu_tensor_raises_before_building():
    x = torch.zeros((8, 8, 3), dtype=torch.uint8)
    launches = cuda_grad.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        vt.gradient(x, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_grad.gradient(x)
    assert cuda_grad.launches == launches
