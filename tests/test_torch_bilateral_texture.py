"""The PyTorch port's bilateral texture filter on the CPU: its plain stage
versions against golden/ and the JAX package (blur + mRTV bit-equal, the
guide within 1 u8), the whole filter against golden/ and the JAX xla and
pallas paths within the JAX path's own envelope, plus validation and
dispatch.  The CUDA kernels themselves are tested on the card
(tests/test_torch_cuda.py, chip_smoke.py); the fuzz replays are in
tests/test_torch_btf_fuzz.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from various_image_processings_tpu import golden  # noqa: E402
from various_image_processings_tpu.ops import bilateral_texture as jbt  # noqa: E402
from various_image_processings_tpu.ops.pallas.bilateral_texture import guide_pallas  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops import bilateral_texture as tbt  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as cuda_btf  # noqa: E402


def diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


def assert_btf_envelope(got, expected):
    """The JAX path's end-to-end contract (tests/test_bilateral_texture.py):
    three cascaded stages, a few pixels may drift."""
    d = diff(got, expected)
    assert np.percentile(d, 99.9) <= 2 and d.max() <= 3, (np.percentile(d, 99.9), d.max())


def stage_inputs(shape, ksize):
    src = random_image(*shape)
    mag = golden.gradient(src)
    return src, mag, golden.compute_blur_and_rtv(src, mag, ksize)


@pytest.mark.parametrize("ksize", [1, 3, 9])
@pytest.mark.parametrize("shape", [(50, 50), (64, 31)])
def test_plain_blur_and_rtv_bit_equal_to_golden_and_jax(shape, ksize):
    src, mag, (blurred_g, rtv_g) = stage_inputs(shape, ksize)
    blurred, rtv = tbt._blur_and_rtv_math(torch.from_numpy(src).float(), torch.from_numpy(mag),
                                          ksize)
    np.testing.assert_array_equal(blurred.numpy(), blurred_g)
    np.testing.assert_array_equal(rtv.numpy(), rtv_g)
    blurred_j, rtv_j = jax.jit(lambda s, m: jbt._blur_and_rtv_math(s, m, ksize))(
        jnp.asarray(src, jnp.float32), jnp.asarray(mag))
    np.testing.assert_array_equal(blurred.numpy(), np.asarray(blurred_j))
    np.testing.assert_array_equal(rtv.numpy(), np.asarray(rtv_j))


@pytest.mark.parametrize("ksize", [1, 3, 9])
@pytest.mark.parametrize("shape", [(50, 50), (64, 31)])
def test_plain_guide_within_1_of_golden_and_jax(shape, ksize):
    _, _, (blurred, rtv) = stage_inputs(shape, ksize)
    got = tbt._guide_math(torch.from_numpy(blurred), torch.from_numpy(rtv), ksize).numpy()
    assert diff(got, golden.compute_guide(blurred, rtv, ksize)).max() <= 1
    strict = jax.jit(lambda b, r: jbt._guide_math(b, r, ksize, strict=True))(
        jnp.asarray(blurred), jnp.asarray(rtv))
    assert diff(got, strict).max() <= 1
    assert diff(got, guide_pallas(jnp.asarray(blurred), jnp.asarray(rtv), ksize)).max() <= 1


def test_end_to_end_vs_golden():
    src = random_image(40, 40)
    got = vt.bilateral_texture_filter(src, 5, 2, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == src.shape
    assert_btf_envelope(got.numpy(), golden.bilateral_texture_filter(src, ksize=5, nitr=2))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", ["cuda", "cpp"])
def test_end_to_end_vs_jax(impl, variant):
    src = random_image(40, 40)
    got = vt.bilateral_texture_filter(src, 5, 2, variant=variant, device="cpu")
    assert_btf_envelope(got.numpy(), jbt.bilateral_texture_filter(src, 5, 2, impl=impl,
                                                                  variant=variant))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_cpp_variant_on_an_image_smaller_than_the_jbf_radius(impl):
    """8 rows against the k=5 JBF's radius 8: the reflect-101 pad must
    multi-reflect."""
    src = random_image(8, 60)
    got = vt.bilateral_texture_filter(src, 5, 2, variant="cpp", device="cpu")
    assert_btf_envelope(got.numpy(), jbt.bilateral_texture_filter(src, 5, 2, impl=impl,
                                                                  variant="cpp"))


def test_nitr_0_returns_a_copy_and_nitr_1_is_one_iteration():
    src = random_image(16, 12)
    t = torch.from_numpy(src)
    out = vt.bilateral_texture_filter(t, 3, 0)
    assert torch.equal(out, t) and out.data_ptr() != t.data_ptr()
    once = vt.bilateral_texture_filter(t, 3, 1)
    taps, lut = tbt.jbf_tables(3, t.device)
    assert torch.equal(once, tbt.btf_iteration(t, 3, taps, lut, "replicate", "trunc", "torch"))
    twice = vt.bilateral_texture_filter(t, 3, 2)
    assert torch.equal(vt.bilateral_texture_filter(once, 3, 1), twice)


def test_tensor_input_stays_on_its_device():
    src = random_image(8, 5)
    assert vt.bilateral_texture_filter(torch.from_numpy(src), 3, 1).device.type == "cpu"


# -- validation: the same types and messages as the JAX package's op --

def test_rejects_bad_arguments():
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="nitr"):
        vt.bilateral_texture_filter(img, 3, -1, device="cpu")
    with pytest.raises(ValueError, match="variant"):
        vt.bilateral_texture_filter(img, 3, 1, variant="opencv", device="cpu")
    with pytest.raises(ValueError, match="odd"):
        vt.bilateral_texture_filter(img, 4, 1, device="cpu")
    with pytest.raises(TypeError, match="uint8"):
        vt.bilateral_texture_filter(img.astype(np.float32), 3, 1, device="cpu")
    with pytest.raises(ValueError, match="color image"):
        vt.bilateral_texture_filter(img[:, :, 0], 3, 1, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        vt.bilateral_texture_filter(img, 3, 1, impl="pallas", device="cpu")


def test_numpy_input_without_a_device_runs_on_the_gpu_or_raises():
    src = random_image(8, 5)
    if torch.cuda.is_available():
        assert vt.bilateral_texture_filter(src, 3, 1).is_cuda
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            vt.bilateral_texture_filter(src, 3, 1)
        with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
            vt.BilateralTextureFilter(8, 5, 3, 1)


def test_cuda_impl_on_a_cpu_tensor_raises_before_building():
    x = torch.zeros((8, 8, 3), dtype=torch.uint8)
    counts = (cuda_btf.blur_rtv_launches, cuda_btf.guide_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        vt.bilateral_texture_filter(x, 3, 1, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_btf.blur_and_rtv(x, torch.zeros((8, 8)), 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_btf.guide(x.float(), torch.zeros((8, 8)), 3)
    assert (cuda_btf.blur_rtv_launches, cuda_btf.guide_launches) == counts


def test_sigma_alpha_and_epsilon_are_the_references_f32_values():
    for ksize in (1, 3, 9, 15):
        expected = np.float32(1.0) / np.float32(5 * ksize)
        assert cuda_btf.sigma_alpha(ksize) == expected
        assert np.float32(float(cuda_btf.sigma_alpha(ksize))) == expected
    assert cuda_btf.EPSILON == jbt.EPSILON
    assert np.float32(float(cuda_btf.EPSILON)) == golden.bilateral_texture.EPSILON
