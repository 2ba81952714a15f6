"""The PyTorch port's class API (``BilateralFilter``, an nn.Module whose
tables are its state) and its bilateral-filter CLI, on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from various_image_processings_tpu import golden  # noqa: E402
from various_image_processings_tpu.core.luts import pre_compute_kernels  # noqa: E402
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.cli import bilateral_filter as cli  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402


@pytest.mark.parametrize("ksize,sigmas", [(9, (10.0, 30.0)), (17, (8.0, 3.0 ** 0.5))])
def test_module_matches_op(ksize, sigmas):
    src = random_image(37, 61)
    guide = src[::-1].copy()
    module = vt.BilateralFilter(37, 61, ksize, *sigmas)
    np.testing.assert_array_equal(module(src).numpy(),
                                  vt.bilateral_filter(src, ksize, *sigmas).numpy())
    np.testing.assert_array_equal(module.bilateral_filter(src).numpy(), module(src).numpy())
    np.testing.assert_array_equal(module.joint_bilateral_filter(src, guide).numpy(),
                                  vt.joint_bilateral_filter(src, guide, ksize, *sigmas).numpy())


@pytest.mark.parametrize("ksize,sigmas", [(9, (10.0, 30.0)), (11, (3.0, 12.5))])
def test_from_numpy_tables_of_the_jax_package(ksize, sigmas):
    """The JAX package's host-built tables are the filter's whole state:
    carried into the module they give the module's own output, and golden's."""
    space, table = pre_compute_kernels(ksize, *sigmas)
    carried = vt.BilateralFilter.from_numpy_tables(space, table, 41, 57)
    own = vt.BilateralFilter(41, 57, ksize, *sigmas)
    assert torch.equal(carried.taps, own.taps) and torch.equal(carried.lut, own.lut)
    src = random_image(41, 57)
    guide = src[::-1].copy()
    np.testing.assert_array_equal(carried(src).numpy(), own(src).numpy())
    np.testing.assert_array_equal(carried(src).numpy(),
                                  golden.bilateral_filter(src, ksize, *sigmas))
    np.testing.assert_array_equal(carried.joint_bilateral_filter(src, guide).numpy(),
                                  golden.joint_bilateral_filter(src, guide, ksize, *sigmas))


def test_tables_are_buffers():
    module = vt.BilateralFilter(8, 8, 5)
    state = module.state_dict()
    assert set(state) == {"taps", "lut"}
    assert state["taps"].dtype == torch.int32 and state["lut"].shape == (768,)
    moved = module.to("cpu")
    assert moved.taps.device.type == "cpu"


def test_module_rejects_wrong_input():
    module = vt.BilateralFilter(8, 8)
    with pytest.raises(ValueError, match="expected"):
        module(np.zeros((8, 9, 3), np.uint8))
    with pytest.raises(ValueError, match="expected"):
        module(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError, match="odd"):
        vt.BilateralFilter(8, 8, ksize=4)
    with pytest.raises(ValueError, match="impl"):
        vt.BilateralFilter(8, 8, impl="xla")
    with pytest.raises(ValueError, match="square"):
        vt.BilateralFilter.from_numpy_tables(np.ones((3, 5), np.float32),
                                             np.ones(768, np.float32), 8, 8)
    with pytest.raises(ValueError, match="color_table"):
        vt.BilateralFilter.from_numpy_tables(np.ones((3, 3), np.float32),
                                             np.ones(512, np.float32), 8, 8)


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
