"""The plain references against the port's plain versions, at small sizes
on the CPU: bit-equal in float32, and not in bfloat16 (the control)."""

import numpy as np
import pytest
import torch

import various_image_processings_tpu_torch as vt
from port_bench import core
from port_bench.refs import _plain
from various_image_processings_tpu_torch.core import luts
from various_image_processings_tpu_torch.ops import bilateral_texture as obt
from various_image_processings_tpu_torch.ops.gradient import _gradient_math

BENCH = core.Bench()
SQRT3 = float(np.sqrt(np.float32(3.0)))


def frame(h, w, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (h, w, 3), dtype=torch.uint8, generator=g)


@pytest.mark.parametrize("ksize,sigma_space,sigma_color", [
    (9, 10.0, 30.0), (5, 3.0, 12.5), (3, 1.0, 200.0), (17, 8.0, SQRT3), (1, 10.0, 30.0)])
def test_tables_equal_the_ports(ksize, sigma_space, sigma_color):
    assert np.array_equal(_plain.space_kernel(ksize, sigma_space),
                          luts.space_kernel(ksize, sigma_space))
    assert np.array_equal(_plain.color_table(sigma_color), luts.color_table(sigma_color))


@pytest.mark.parametrize("shape,ksize,sigma_space,sigma_color", [
    ((17, 23), 9, 10.0, 30.0), ((9, 31), 5, 3.0, 12.5), ((12, 12), 3, 1.0, 200.0),
    ((20, 11), 17, 8.0, SQRT3), ((6, 7), 9, 10.0, 30.0)])
def test_bilateral_reference_equals_the_ports_plain_filter(shape, ksize, sigma_space,
                                                           sigma_color):
    src = frame(*shape, seed=ksize)
    got = BENCH.load("refs", "bilateral").reference(src, ksize=ksize, sigma_space=sigma_space,
                                                    sigma_color=sigma_color)
    want = vt.bilateral_filter(src, ksize, sigma_space, sigma_color, impl="torch")
    assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.parametrize("shape,ksize,nitr", [
    ((19, 26), 9, 3), ((16, 13), 5, 2), ((11, 9), 3, 1), ((7, 8), 9, 0)])
def test_btf_reference_equals_the_ports_plain_filter(shape, ksize, nitr):
    src = frame(*shape, seed=nitr + 10 * ksize)
    got = BENCH.load("refs", "bilateral_texture").reference(src, ksize=ksize, nitr=nitr)
    want = vt.bilateral_texture_filter(src, ksize, nitr, impl="torch")
    assert torch.equal(got, want)
    assert got.data_ptr() != src.data_ptr()


def test_btf_stages_equal_the_ports_plain_stages():
    src = frame(23, 29, seed=3)
    mag = _plain.gradient(src)
    assert torch.equal(mag, _gradient_math(src.to(torch.float32)))
    blurred, rtv = _plain.blur_and_rtv(src, mag, 9)
    want_b, want_r = obt._blur_and_rtv_math(src.to(torch.float32), mag, 9)
    assert torch.equal(blurred, want_b) and torch.equal(rtv, want_r)
    assert torch.equal(_plain.guide(blurred, rtv, 9), obt._guide_math(want_b, want_r, 9))


def test_btf_reference_takes_the_cuda_variant_only():
    with pytest.raises(ValueError, match="variant"):
        BENCH.load("refs", "bilateral_texture").reference(frame(8, 8, 0), 9, 1, variant="cpp")


@pytest.mark.parametrize("name,kwargs", [
    ("bilateral", {"ksize": 9, "sigma_space": 10.0, "sigma_color": 30.0}),
    ("bilateral_texture", {"ksize": 9, "nitr": 1})])
def test_bfloat16_reference_departs_from_float32(name, kwargs):
    src = frame(24, 32, seed=5)
    ref = BENCH.load("refs", name).reference
    f32, bf16 = ref(src, **kwargs), ref(src, dtype=torch.bfloat16, **kwargs)
    assert (f32.int() - bf16.int()).abs().max() >= 1
