"""The work counts against the bounds PERF.md quotes, counted from the
parameters and the frame's shape alone."""

import pytest

from port_bench import core
from various_image_processings_tpu_torch.core import luts

BENCH = core.Bench()
PEAKS = BENCH.peaks()


def least_ms(ops, nbytes):
    return max(ops / PEAKS["f32_ops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"]) * 1e3


@pytest.mark.parametrize("ksize,sigma_space", [(9, 10.0), (17, 8.0), (3, 0.5), (31, 2.0),
                                               (1, 10.0)])
def test_nonzero_taps_equal_the_ports_tap_table(ksize, sigma_space):
    count = BENCH.load("counts", "bilateral")
    assert count.nonzero_taps(ksize, sigma_space) == len(
        luts.tap_table(luts.space_kernel(ksize, sigma_space)))


def test_bf_4k_bound_is_perf_mds():
    ops, nbytes = BENCH.load("counts", "bilateral").work(
        {"ksize": 9, "sigma_space": 10.0, "sigma_color": 30.0}, 2160, 3840, 3)
    assert ops == 2160 * 3840 * (8 * 49 + 6)
    assert nbytes == 2 * 2160 * 3840 * 3
    assert round(least_ms(ops, nbytes), 4) == 0.0493  # bound by the operations
    assert ops / PEAKS["f32_ops_per_s"] > nbytes / PEAKS["hbm_bytes_per_s"]


def test_btf_4k_stage_counts():
    count = BENCH.load("counts", "bilateral_texture")
    assert count.stage_ops(9) == {"gradient": 19, "blur_rtv": 81 + 108 + 10,
                                  "guide": 36 + 20, "joint_bilateral": 8 * 197 + 6}
    px = 2160 * 3840
    ops, nbytes = count.work({"ksize": 9, "nitr": 3, "variant": "cuda"}, 2160, 3840, 3)
    assert ops == 3 * px * (19 + 199 + 56 + 1582)
    assert nbytes == 2 * px * 3  # no intermediate buffer
    assert round(least_ms(ops, nbytes), 3) == 0.689
    # each stage's share of the 4K call, as PERF.md's kernel bounds have them
    jbf_ms = px * 1582 / PEAKS["f32_ops_per_s"] * 1e3
    assert round(jbf_ms, 4) == 0.1958


def test_counts_scale_with_nitr_and_frame():
    count = BENCH.load("counts", "bilateral_texture")
    one = count.work({"ksize": 9, "nitr": 1}, 600, 900, 3)
    assert count.work({"ksize": 9, "nitr": 3}, 600, 900, 3) == (3 * one[0], one[1])
    assert count.work({"ksize": 9, "nitr": 0}, 600, 900, 3)[0] == 0
