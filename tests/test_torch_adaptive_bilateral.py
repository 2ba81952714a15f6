"""The PyTorch port's adaptive bilateral filter on the CPU: the plain version
against golden/ (bit-exact, subnormal-band and product-underflow points
included), the box-mean division, the module, validation and dispatch.  The
comparison with the JAX paths is tests/test_torch_adaptive_bilateral_jax.py;
the CUDA kernel itself is tested on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu import golden  # noqa: E402
from various_image_processings_tpu.core.luts import (  # noqa: E402
    COLOR_TABLE_SIZE_ADAPTIVE, pre_compute_kernels)
from various_image_processings_tpu.ops.adaptive_bilateral import (  # noqa: E402
    adaptive_bilateral_filter as jax_abf)
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops.adaptive_bilateral import box_mean  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import adaptive_bilateral as cuda_abf  # noqa: E402

# (k, σs, σc, h, w): the weights of every tap fall in the LUT's f32
# subnormal band (tests/test_bilateral.py:81-82) ...
BAND_POINTS = [(3, 9.3, 16.3, 26, 41), (15, 22.8, 11.5, 45, 13),
               (11, 8.0, 21.8, 35, 56), (11, 19.6, 35.6, 33, 49)]
# ... and whole windows whose ws·lut products underflow to 0 (:172-175),
# each on np.random.default_rng(777 + i) noise
UNDERFLOW_POINTS = [(13, 1.13, 1.6, 50, 50), (7, 1.13, 5.14, 32, 32),
                    (15, 0.47, 3.49, 31, 64), (13, 1.75, 5.14, 48, 48)]


def underflow_image(i):
    _, _, _, h, w = UNDERFLOW_POINTS[i]
    return np.random.default_rng(777 + i).integers(0, 256, (h, w, 3), np.uint8)


def golden_abf(img, k, ss, sc):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # golden divides 0/0 where the reference does
        return golden.adaptive_bilateral_filter(img, k, ss, sc)


def port(img, k, ss, sc):
    return vt.adaptive_bilateral_filter(img, k, ss, sc, device="cpu").numpy()


def diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


CASES = ([pytest.param(random_image(50, 50), k, 10.0, 30.0, id=f"k{k}") for k in (9, 3, 1, 31)]
         + [pytest.param(random_image(h, w), k, ss, sc, id=f"band{i}")
            for i, (k, ss, sc, h, w) in enumerate(BAND_POINTS)]
         + [pytest.param(underflow_image(i), k, ss, sc, id=f"underflow{i}")
            for i, (k, ss, sc, _, _) in enumerate(UNDERFLOW_POINTS)])


@pytest.mark.parametrize("img,k,ss,sc", CASES)
def test_plain_bit_exact_to_golden(img, k, ss, sc):
    out = port(img, k, ss, sc)
    assert out.dtype == np.uint8 and out.shape == img.shape
    assert diff(out, golden_abf(img, k, ss, sc)).max() == 0


def test_underflow_points_have_all_zero_pixels():
    """The sumk == 0 select runs: whole windows underflow to weight 0 there."""
    for i, (k, ss, sc, _, _) in enumerate(UNDERFLOW_POINTS):
        img = underflow_image(i)
        assert (port(img, k, ss, sc) == 0).all(axis=2).sum() > 0


@pytest.mark.parametrize("ksize", [3, 5, 7, 9, 11, 13, 15])
def test_box_mean_division_exhaustive(ksize):
    """fl(box / k²) equals numpy's IEEE f32 division for every reachable box
    value 0..255·k² (the range index needs it bit-equal, PARITY.md D2)."""
    box = np.arange(0, 255 * ksize * ksize + 1, dtype=np.float32)
    want = box / np.float32(ksize * ksize)
    np.testing.assert_array_equal(box_mean(torch.from_numpy(box), ksize).numpy(), want)


def test_ksize_1_is_identity():
    src = random_image(8, 8)
    np.testing.assert_array_equal(port(src, 1, 10.0, 30.0), src)


def test_module_matches_op():
    src = random_image(37, 61)
    module = vt.AdaptiveBilateralFilter(37, 61, 7, 5.0, 20.0, device="cpu")
    expected = port(src, 7, 5.0, 20.0)
    np.testing.assert_array_equal(module(src).numpy(), expected)
    np.testing.assert_array_equal(module.adaptive_bilateral_filter(src).numpy(), expected)
    state = module.state_dict()
    assert set(state) == {"taps", "lut"} and state["lut"].shape == (COLOR_TABLE_SIZE_ADAPTIVE,)


@pytest.mark.parametrize("ksize,sigmas", [(9, (10.0, 30.0)), (13, (1.13, 1.6))])
def test_from_numpy_tables_of_the_jax_package(ksize, sigmas):
    """The JAX package's host-built tables carried into the module give the
    module's own tables, the op's output and golden's."""
    space, table = pre_compute_kernels(ksize, *sigmas, COLOR_TABLE_SIZE_ADAPTIVE)
    carried = vt.AdaptiveBilateralFilter.from_numpy_tables(space, table, 41, 57, device="cpu")
    own = vt.AdaptiveBilateralFilter(41, 57, ksize, *sigmas, device="cpu")
    assert torch.equal(carried.taps, own.taps) and torch.equal(carried.lut, own.lut)
    src = random_image(41, 57)
    np.testing.assert_array_equal(carried(src).numpy(), port(src, ksize, *sigmas))
    np.testing.assert_array_equal(carried(src).numpy(), golden_abf(src, ksize, *sigmas))


def test_module_rejects_wrong_input_and_tables():
    module = vt.AdaptiveBilateralFilter(8, 8, 3, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        module(np.zeros((8, 9, 3), np.uint8))
    with pytest.raises(ValueError, match="odd"):
        vt.AdaptiveBilateralFilter(8, 8, ksize=4, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        vt.AdaptiveBilateralFilter(8, 8, impl="pallas", device="cpu")
    with pytest.raises(ValueError, match=r"color_table must have shape \(1536,\)"):
        vt.AdaptiveBilateralFilter.from_numpy_tables(np.ones((3, 3), np.float32),
                                                     np.ones(768, np.float32), 8, 8, device="cpu")


# -- validation: the same types and messages as tests/test_validation.py --

@pytest.mark.parametrize("bad,error,match", [
    (np.zeros((8, 8), np.uint8), ValueError, "color image"),
    (np.zeros((8, 8, 4), np.uint8), ValueError, "color image"),
    (np.zeros((8, 8, 3), np.float32), TypeError, "uint8"),
])
def test_rejects_what_the_jax_op_rejects(bad, error, match):
    with pytest.raises(error, match=match):
        jax_abf(bad)
    with pytest.raises(error, match=match):
        vt.adaptive_bilateral_filter(bad, device="cpu")


@pytest.mark.parametrize("ksize", [0, 8, -3])
def test_rejects_bad_ksize(ksize):
    src = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="odd"):
        jax_abf(src, ksize=ksize)
    with pytest.raises(ValueError, match="odd"):
        vt.adaptive_bilateral_filter(src, ksize=ksize, device="cpu")


def test_rejects_bad_impl_and_cuda_on_a_cpu_tensor():
    src = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(ValueError, match="impl"):
        vt.adaptive_bilateral_filter(src, impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        vt.adaptive_bilateral_filter(src, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        vt.AdaptiveBilateralFilter(8, 8, 3, impl="cuda", device="cpu")(src)


def test_numpy_input_without_a_device_runs_on_the_gpu_or_raises():
    """The default device is the GPU: without one, a NumPy input raises and
    never runs silently on the CPU."""
    src = random_image(8, 5)
    for call in (lambda: vt.adaptive_bilateral_filter(src, 3),
                 lambda: vt.AdaptiveBilateralFilter(8, 5, 3)(src)):
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
                call()


def test_kernel_wrapper_rejects_a_cpu_tensor_before_building():
    x = torch.zeros((8, 8, 3), dtype=torch.uint8)
    taps, lut = cuda_abf.device_tables(3, 10.0, 30.0, x.device)
    assert lut.shape == (COLOR_TABLE_SIZE_ADAPTIVE,)
    launches = cuda_abf.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_abf.adaptive_bilateral_taps(x, taps, lut, 1)
    assert cuda_abf.launches == launches
