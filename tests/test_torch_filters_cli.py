"""The PyTorch port's class API (``BilateralFilter`` and
``BilateralTextureFilter``, nn.Modules whose tables are their state) and
its bilateral-filter, gradient, bilateral-texture-filter and
adaptive-bilateral-filter CLIs, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from various_image_processings_tpu import golden  # noqa: E402
from various_image_processings_tpu.core.luts import pre_compute_kernels  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.cli import (  # noqa: E402
    adaptive_bilateral_filter as cli_abf)
from various_image_processings_tpu_torch.cli import bilateral_filter as cli  # noqa: E402
from various_image_processings_tpu_torch.cli import (  # noqa: E402
    bilateral_texture_filter as cli_btf)
from various_image_processings_tpu_torch.cli import gradient as cli_grad  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402


@pytest.mark.parametrize("ksize,sigmas", [(9, (10.0, 30.0)), (17, (8.0, 3.0 ** 0.5))])
def test_module_matches_op(ksize, sigmas):
    src = random_image(37, 61)
    guide = src[::-1].copy()
    module = vt.BilateralFilter(37, 61, ksize, *sigmas, device="cpu")
    np.testing.assert_array_equal(module(src).numpy(),
                                  vt.bilateral_filter(src, ksize, *sigmas, device="cpu").numpy())
    np.testing.assert_array_equal(module.bilateral_filter(src).numpy(), module(src).numpy())
    np.testing.assert_array_equal(module.joint_bilateral_filter(src, guide).numpy(),
                                  vt.joint_bilateral_filter(src, guide, ksize, *sigmas,
                                                           device="cpu").numpy())


@pytest.mark.parametrize("ksize,sigmas", [(9, (10.0, 30.0)), (11, (3.0, 12.5))])
def test_from_numpy_tables_of_the_jax_package(ksize, sigmas):
    """The JAX package's host-built tables are the filter's whole state:
    carried into the module they give the module's own output, and golden's."""
    space, table = pre_compute_kernels(ksize, *sigmas)
    carried = vt.BilateralFilter.from_numpy_tables(space, table, 41, 57, device="cpu")
    own = vt.BilateralFilter(41, 57, ksize, *sigmas, device="cpu")
    assert torch.equal(carried.taps, own.taps) and torch.equal(carried.lut, own.lut)
    src = random_image(41, 57)
    guide = src[::-1].copy()
    np.testing.assert_array_equal(carried(src).numpy(), own(src).numpy())
    np.testing.assert_array_equal(carried(src).numpy(),
                                  golden.bilateral_filter(src, ksize, *sigmas))
    np.testing.assert_array_equal(carried.joint_bilateral_filter(src, guide).numpy(),
                                  golden.joint_bilateral_filter(src, guide, ksize, *sigmas))


def test_tables_are_buffers():
    module = vt.BilateralFilter(8, 8, 5, device="cpu")
    state = module.state_dict()
    assert set(state) == {"taps", "lut"}
    assert state["taps"].dtype == torch.int32 and state["lut"].shape == (768,)
    moved = module.to("cpu")
    assert moved.taps.device.type == "cpu"


def test_module_rejects_wrong_input():
    module = vt.BilateralFilter(8, 8, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        module(np.zeros((8, 9, 3), np.uint8))
    with pytest.raises(ValueError, match="expected"):
        module(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="odd"):
        vt.BilateralFilter(8, 8, ksize=4, device="cpu")
    with pytest.raises(ValueError, match="impl"):
        vt.BilateralFilter(8, 8, impl="xla", device="cpu")
    with pytest.raises(ValueError, match="square"):
        vt.BilateralFilter.from_numpy_tables(np.ones((3, 5), np.float32),
                                             np.ones(768, np.float32), 8, 8, device="cpu")
    with pytest.raises(ValueError, match="color_table"):
        vt.BilateralFilter.from_numpy_tables(np.ones((3, 3), np.float32),
                                             np.ones(512, np.float32), 8, 8, device="cpu")


def test_cli_matches_golden(tmp_path, capsys):
    src = random_image(40, 64)
    in_path = tmp_path / "in.png"
    out_path = tmp_path / "out.png"
    cv2.imwrite(str(in_path), src)
    assert cli.main([str(in_path), "7", "5.0", "20.0", "-o", str(out_path),
                     "--device", "cpu", "--side-by-side", "--compare"]) == 0
    out = cv2.imread(str(out_path), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(out, golden.bilateral_filter(src, 7, 5.0, 20.0))
    sbs = cv2.imread(str(tmp_path / "out_sbs.png"), cv2.IMREAD_COLOR)
    assert sbs.shape == (40, 2 * 64 + 2, 3)
    assert "max abs diff vs cv2.bilateralFilter" in capsys.readouterr().out


def test_cli_impl_cuda_on_cpu_device_raises(tmp_path):
    in_path = tmp_path / "in.png"
    cv2.imwrite(str(in_path), random_image(8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cli.main([str(in_path), "-o", str(tmp_path / "o.png"), "--device", "cpu",
                  "--impl", "cuda"])


def test_cli_default_device_needs_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    in_path = tmp_path / "in.png"
    cv2.imwrite(str(in_path), random_image(8, 8))
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cli.main([str(in_path), "-o", str(tmp_path / "o.png")])


# -- the bilateral texture filter's module and the gradient / BTF CLIs --

@pytest.mark.parametrize("ksize,nitr", [(3, 2), (5, 1)])
def test_btf_module_matches_op(ksize, nitr):
    src = random_image(30, 23)
    module = vt.BilateralTextureFilter(30, 23, ksize, nitr, device="cpu")
    expected = vt.bilateral_texture_filter(src, ksize, nitr, device="cpu")
    np.testing.assert_array_equal(module(src).numpy(), expected.numpy())
    np.testing.assert_array_equal(module.execute(src).numpy(), expected.numpy())
    assert set(module.state_dict()) == {"taps", "lut"}


def test_btf_from_numpy_tables_of_the_jax_package():
    """pre_compute_kernels(2k−1, k−1, √3) is the BTF's JBF stage: carried into
    the module it gives the module's own tables and golden's output."""
    ksize = 5
    space, table = pre_compute_kernels(2 * ksize - 1, float(ksize - 1),
                                       float(np.sqrt(np.float32(3.0))))
    carried = vt.BilateralTextureFilter.from_numpy_tables(space, table, 40, 40, nitr=2,
                                                          device="cpu")
    own = vt.BilateralTextureFilter(40, 40, ksize, 2, device="cpu")
    assert carried.ksize == ksize
    assert torch.equal(carried.taps, own.taps) and torch.equal(carried.lut, own.lut)
    src = random_image(40, 40)
    np.testing.assert_array_equal(carried(src).numpy(),
                                  golden.bilateral_texture_filter(src, ksize, 2))


def test_btf_module_rejects_wrong_input():
    module = vt.BilateralTextureFilter(8, 8, 3, 1, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        module(np.zeros((8, 9, 3), np.uint8))
    with pytest.raises(ValueError, match="nitr"):
        vt.BilateralTextureFilter(8, 8, 3, -1, device="cpu")
    with pytest.raises(ValueError, match="odd"):
        vt.BilateralTextureFilter(8, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="odd window"):
        vt.BilateralTextureFilter.from_numpy_tables(np.ones((3, 3), np.float32),
                                                    np.ones(768, np.float32), 8, 8,
                                                    device="cpu")


def test_gradient_cli(tmp_path):
    src = random_image(24, 24)
    in_path, out_path = tmp_path / "in.png", tmp_path / "out.png"
    cv2.imwrite(str(in_path), src)
    assert cli_grad.main([str(in_path), "-o", str(out_path), "--device", "cpu"]) == 0
    g = golden.gradient(src)
    expected = (g * np.float32(255.0) / g.max()).astype(np.uint8)
    out = cv2.imread(str(out_path), cv2.IMREAD_GRAYSCALE)
    assert np.abs(out.astype(int) - expected.astype(int)).max() <= 1


@pytest.mark.parametrize("variant", ["cuda", "cpp"])
def test_btf_cli(tmp_path, variant):
    src = random_image(24, 24)
    in_path, out_path = tmp_path / "in.png", tmp_path / "out.png"
    cv2.imwrite(str(in_path), src)
    assert cli_btf.main([str(in_path), "5", "2", "-o", str(out_path), "--device", "cpu",
                         "--variant", variant]) == 0
    out = cv2.imread(str(out_path), cv2.IMREAD_COLOR)
    expected = vt.bilateral_texture_filter(src, 5, 2, variant=variant, device="cpu")
    np.testing.assert_array_equal(out, expected.numpy())
    if variant == "cuda":
        np.testing.assert_array_equal(out, golden.bilateral_texture_filter(src, 5, 2))


def test_abf_cli_writes_the_ops_output(tmp_path):
    src = random_image(24, 32)
    in_path, out_path = tmp_path / "in.png", tmp_path / "out.png"
    cv2.imwrite(str(in_path), src)
    assert cli_abf.main([str(in_path), "5", "4.0", "40.0", "-o", str(out_path),
                         "--device", "cpu"]) == 0
    out = cv2.imread(str(out_path), cv2.IMREAD_COLOR)
    expected = vt.adaptive_bilateral_filter(src, 5, 4.0, 40.0, device="cpu")
    np.testing.assert_array_equal(out, expected.numpy())
    np.testing.assert_array_equal(out, golden.adaptive_bilateral_filter(src, 5, 4.0, 40.0))


def test_abf_cli_impl_cuda_on_cpu_device_raises(tmp_path):
    in_path = tmp_path / "in.png"
    cv2.imwrite(str(in_path), random_image(8, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cli_abf.main([str(in_path), "-o", str(tmp_path / "o.png"), "--device", "cpu",
                      "--impl", "cuda"])
