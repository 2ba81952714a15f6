"""``vip-torch-benchmark`` on the CPU: the same TOML schema as the JAX
package's ``vip-benchmark`` (its ``parse_config`` must give the same
configuration) and one "[msec]" line per timed op."""

import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu.cli.benchmark import parse_config as jax_parse_config  # noqa: E402
from various_image_processings_tpu_torch.cli import benchmark  # noqa: E402

CONFIG = """execute_times = 2

[BilateralFilter]
ksize = 5

[BilateralTextureFilter]
nitr = 1

[SuperpixelSLIC]
superpixel_size = 8
num_iteration = 2
"""


@pytest.fixture
def config(tmp_path):
    path = tmp_path / "config.toml"
    path.write_text(CONFIG)
    return str(path)


def test_parse_config_equals_the_jax_package(config):
    assert benchmark.parse_config(None) == jax_parse_config(None)
    assert benchmark.parse_config(config) == jax_parse_config(config)
    cfg = benchmark.parse_config(config)
    assert cfg["execute_times"] == 2 and cfg["BilateralFilter"]["ksize"] == 5
    assert cfg["AdaptiveBilateralFilter"] == {"ksize": 9}


def test_defaults_are_not_mutated(config):
    benchmark.parse_config(config)
    assert benchmark.DEFAULTS["BilateralFilter"] == {"ksize": 9}


def test_main_prints_a_msec_line_per_op_on_the_cpu(config, capsys):
    assert benchmark.main(["--size", "24", "24", "--device", "cpu", config]) == 0
    out = capsys.readouterr().out
    assert "image size        : 24x24" in out
    assert "timing impl=torch only" in out
    lines = [ln for ln in out.splitlines() if "[msec]" in ln]
    names = [ln.split(" : ")[0].strip() for ln in lines]
    assert names == ["gradient (torch)", "bilateral_filter k=5 (torch)",
                     "adaptive_bilateral_filter k=9 (torch)",
                     "bilateral_texture_filter k=9 nitr=1 (torch)",
                     "superpixel_slic S=8 itr=2"]
    for ln in lines:
        m = re.search(r": +([0-9.]+) \[msec\]  \( *([0-9.]+) MP/s\)$", ln)
        assert m and float(m.group(1)) > 0, ln


def test_main_on_cuda_without_a_gpu_raises(monkeypatch, config):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        benchmark.main(["--size", "8", "8", config])
