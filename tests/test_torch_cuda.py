"""The port's CUDA kernels on the card, held bit-exact to their plain
PyTorch versions.  Every test here needs an NVIDIA GPU and skips without one; this
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_array, random_image  # noqa: E402
from various_image_processings_tpu_torch.ops.adaptive_bilateral import (  # noqa: E402
    _abf_math, box_mean)
from various_image_processings_tpu_torch.ops.bilateral import (  # noqa: E402
    _bilateral_math, _taps_math)
from various_image_processings_tpu_torch.ops.bilateral_texture import (  # noqa: E402
    _blur_and_rtv_math, _guide_math)
from various_image_processings_tpu_torch.ops.cuda import adaptive_bilateral as cuda_abf  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral as cuda_bf  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as cuda_btf  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import gradient as cuda_grad  # noqa: E402
from various_image_processings_tpu_torch.models import inpainting as wexler  # noqa: E402
from various_image_processings_tpu_torch.ops import wexler_search as search_op  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import wexler_search as cuda_search  # noqa: E402
from various_image_processings_tpu_torch.ops.gradient import _gradient_math  # noqa: E402

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
                                  vt.bilateral_filter(src.cpu().numpy(), 9, 10.0, 30.0,
                                                      device="cpu").numpy())


def test_op_makes_views_contiguous_and_wrapper_rejects_them(cuda):
    src, _ = images((40, 64), cuda)
    view = src[:, ::2]
    np.testing.assert_array_equal(vt.bilateral_filter(view, 5).cpu().numpy(),
                                  vt.bilateral_filter(view.cpu().numpy(), 5, device="cpu").numpy())
    taps, lut = cuda_bf.device_tables(5, 10.0, 30.0, src.device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_bf.joint_bilateral(view, None, taps, lut, 2)
    with pytest.raises(TypeError, match="uint8"):
        cuda_bf.joint_bilateral(src.float(), None, taps, lut, 2)


def test_too_large_a_halo_tile_raises(cuda):
    src, _ = images((8, 8), cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_bf.bilateral(src, None, 301, 10.0, 30.0)


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"), ("reflect101", "rint")])
@pytest.mark.parametrize("shape", [(45, 129), (19, 130), (64, 200), (600, 900)])
def test_btf_shaped_joint_filter_bit_exact_to_plain(cuda, shape, border, rounding):
    """The BTF's JBF (k′=17, σs=8, σc=√3) on widths that are not a multiple
    of the block's 128 columns or of the 4 pixels a thread."""
    src, guide = images(shape, cuda)
    sigma_color = float(np.sqrt(3.0))
    got = cuda_bf.bilateral(src, guide, 17, 8.0, sigma_color, border, rounding)
    assert torch.equal(got, _bilateral_math(src, guide, 17, 8.0, sigma_color, border, rounding))


def sparse_taps(radius):
    """A few taps spread over a (2r+1)² window, corners and centre included,
    in (ky, kx) order: the plain version stays cheap at any radius."""
    d = 2 * radius
    pos = sorted({(0, 0), (0, d), (radius, radius), (radius // 3, d - 1), (d, 0), (d, d)})
    ws = np.array([1.0, 0.5, 0.25, 0.75, 0.125, 0.875][:len(pos)], np.float32)
    table = np.zeros((len(pos), 4), np.int32)
    table[:, :2] = pos
    table[:, 2] = ws.view(np.int32)
    return table


# (joint, radius): the largest radius each side accepts (k = 219 self, 149
# joint), and the radii on both sides of the switch from 4 pixels a thread to 1
@pytest.mark.parametrize("joint,radius", [(False, 109), (True, 74), (False, 88), (False, 89),
                                          (True, 55), (True, 56)])
def test_largest_accepted_radius_is_no_smaller_than_before(cuda, joint, radius):
    src, guide = images((23, 37), cuda)
    _, lut = cuda_bf.device_tables(3, 10.0, 30.0, src.device)
    table = sparse_taps(radius)
    taps = torch.from_numpy(table).to(cuda)
    pixels = cuda_bf._lib().vip_bilateral_pixels_per_thread(radius, int(joint))
    assert pixels == (4 if radius <= (55 if joint else 88) else 1)
    for border, rounding in [("replicate", "trunc"), ("reflect101", "rint")]:
        got = cuda_bf.joint_bilateral(src, guide if joint else None, taps, lut, radius,
                                      border, rounding)
        want = _taps_math(src, guide if joint else src, table, lut, radius, border, rounding)
        assert torch.equal(got, want)
    if radius in (109, 74):
        with pytest.raises(ValueError, match="shared memory"):
            cuda_bf.joint_bilateral(src, guide if joint else None,
                                    torch.from_numpy(sparse_taps(radius + 1)).to(cuda), lut,
                                    radius + 1)


# -- gradient, blur + mRTV and guide kernels; the bilateral texture filter --

STAGE_SHAPES = [(1, 1), (8, 5), (37, 61), (64, 31)]


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", [(1, 1), (8, 5), (37, 61)])
def test_gradient_kernel_bit_exact_to_plain(cuda, shape, channels, dtype):
    n = shape[0] * shape[1] * channels
    if dtype == torch.float32:
        src_np = random_array(n, 255.0, np.float32).reshape(*shape, channels)
    else:
        src_np = random_array(n).reshape(*shape, channels)
    src = torch.from_numpy(src_np).to(cuda)
    got = cuda_grad.gradient(src)
    assert torch.equal(got, _gradient_math(src.float()))
    assert torch.equal(got.cpu(), _gradient_math(src.cpu().float()))


@pytest.mark.parametrize("ksize", [1, 3, 5, 9, 15])
@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_blur_rtv_and_guide_kernels_bit_exact_to_plain(cuda, shape, ksize):
    img, _ = images(shape, cuda)
    magnitude = _gradient_math(img.float())
    blurred, rtv = cuda_btf.blur_and_rtv(img, magnitude, ksize)
    blurred_p, rtv_p = _blur_and_rtv_math(img.float(), magnitude, ksize)
    assert torch.equal(blurred, blurred_p) and torch.equal(rtv, rtv_p)
    blurred_c, rtv_c = _blur_and_rtv_math(img.cpu().float(), magnitude.cpu(), ksize)
    assert torch.equal(blurred.cpu(), blurred_c) and torch.equal(rtv.cpu(), rtv_c)
    guide = cuda_btf.guide(blurred, rtv, ksize)
    assert guide.dtype == torch.uint8
    assert torch.equal(guide, _guide_math(blurred, rtv, ksize).to(torch.uint8))


def near_tie_image():
    """A (24, 32, 3) image whose every pixel sum b+g+r is one whose /3 a
    multiply by the reciprocal gets one ulp wrong."""
    sums = np.arange(766)
    s32 = sums.astype(np.float32)
    near = sums[s32 / np.float32(3) != s32 * (np.float32(1) / np.float32(3))]
    b = np.minimum(near, 255)
    g = np.minimum(near - b, 255)
    pixels = np.stack([b, g, near - b - g], axis=1).astype(np.uint8)
    return np.resize(pixels, (24 * 32, 3)).reshape(24, 32, 3)


def test_true_division_on_a_near_tie_image(cuda):
    """PyTorch's CUDA division by a host scalar multiplies by the
    reciprocal.  The kernels and the plain version on the card keep the true
    division of the CPU and of golden/, so blur + mRTV stay bit-equal and
    the guide's argmin does not flip."""
    img = torch.from_numpy(near_tie_image()).to(cuda)
    f = img.float()
    intensity = f[:, :, 0] + f[:, :, 1] + f[:, :, 2]
    assert not torch.equal(intensity * (1.0 / 3.0), intensity / torch.tensor(3.0, device=cuda))
    magnitude = _gradient_math(f)
    for ksize in (3, 9):
        blurred, rtv = cuda_btf.blur_and_rtv(img, magnitude, ksize)
        blurred_p, rtv_p = _blur_and_rtv_math(f, magnitude, ksize)
        blurred_c, rtv_c = _blur_and_rtv_math(f.cpu(), magnitude.cpu(), ksize)
        for got in (blurred, blurred_p):
            assert torch.equal(got.cpu(), blurred_c)
        for got in (rtv, rtv_p):
            assert torch.equal(got.cpu(), rtv_c)
        guide = cuda_btf.guide(blurred, rtv, ksize)
        assert torch.equal(guide, _guide_math(blurred_p, rtv_p, ksize).to(torch.uint8))


@pytest.mark.parametrize("variant", ["cuda", "cpp"])
def test_btf_auto_launches_4_nitr_kernels_and_equals_plain(cuda, variant):
    src, _ = images((45, 38), cuda)
    counts = (cuda_grad.launches, cuda_btf.blur_rtv_launches, cuda_btf.guide_launches,
              cuda_bf.launches)
    out = vt.bilateral_texture_filter(src, 5, 3, variant=variant)
    after = (cuda_grad.launches, cuda_btf.blur_rtv_launches, cuda_btf.guide_launches,
             cuda_bf.launches)
    assert [b - a for a, b in zip(counts, after)] == [3, 3, 3, 3]
    plain = vt.bilateral_texture_filter(src, 5, 3, impl="torch", variant=variant)
    assert out.is_cuda and torch.equal(out, plain)
    if variant == "cuda":
        module = vt.BilateralTextureFilter(45, 38, 5, 3)
        assert torch.equal(module(src), out)
        assert cuda_bf.launches == after[3] + 3


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    img, _ = images((40, 64), cuda)
    magnitude = cuda_grad.gradient(img)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_grad.gradient(img[:, ::2])
    with pytest.raises(TypeError):
        cuda_grad.gradient(img.int())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_btf.blur_and_rtv(img[:, ::2], magnitude[:, ::2], 3)
    with pytest.raises(TypeError):
        cuda_btf.blur_and_rtv(img.float(), magnitude, 3)
    with pytest.raises(ValueError, match="must match"):
        cuda_btf.blur_and_rtv(img, magnitude[:20], 3)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_btf.blur_and_rtv(img, magnitude, 301)
    blurred, rtv = cuda_btf.blur_and_rtv(img, magnitude, 3)
    with pytest.raises(TypeError):
        cuda_btf.guide(blurred.double(), rtv, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_btf.guide(blurred.transpose(0, 1), rtv.t(), 3)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_btf.guide(blurred, rtv, 301)
    with pytest.raises(ValueError, match="odd"):
        cuda_btf.guide(blurred, rtv, 4)


# -- the adaptive bilateral kernel --

# (k, σs, σc, h, w): every tap's weight in the LUT's f32 subnormal band, then
# whole windows whose ws·lut products underflow to 0 (the last four, on
# np.random.default_rng(777 + i) noise); tests/test_bilateral.py:81-82, :172-175
ABF_BAND_POINTS = [(3, 9.3, 16.3, 26, 41), (15, 22.8, 11.5, 45, 13),
                   (11, 8.0, 21.8, 35, 56), (11, 19.6, 35.6, 33, 49)]
ABF_UNDERFLOW_POINTS = [(13, 1.13, 1.6, 50, 50), (7, 1.13, 5.14, 32, 32),
                        (15, 0.47, 3.49, 31, 64), (13, 1.75, 5.14, 48, 48)]


def abf_bit_exact(img_np, k, ss, sc, device):
    img = torch.from_numpy(img_np).to(device)
    got = cuda_abf.adaptive_bilateral(img, k, ss, sc)
    assert torch.equal(got, _abf_math(img, k, ss, sc))
    assert torch.equal(got.cpu(), _abf_math(img.cpu(), k, ss, sc))
    return got


@pytest.mark.parametrize("ksize", [1, 3, 5, 9, 15, 31])
@pytest.mark.parametrize("shape", [(1, 1), (8, 5), (37, 61), (50, 50)])
def test_abf_kernel_bit_exact_to_plain(cuda, shape, ksize):
    abf_bit_exact(random_image(*shape), ksize, 10.0, 30.0, cuda)


@pytest.mark.parametrize("point", range(4))
def test_abf_kernel_bit_exact_on_the_band_points(cuda, point):
    k, ss, sc, h, w = ABF_BAND_POINTS[point]
    abf_bit_exact(random_image(h, w), k, ss, sc, cuda)


@pytest.mark.parametrize("point", range(4))
def test_abf_kernel_bit_exact_on_the_underflow_points(cuda, point):
    k, ss, sc, h, w = ABF_UNDERFLOW_POINTS[point]
    img = np.random.default_rng(777 + point).integers(0, 256, (h, w, 3), np.uint8)
    got = abf_bit_exact(img, k, ss, sc, cuda)
    assert (got == 0).all(dim=2).any()  # the sumk == 0 select ran


@pytest.mark.parametrize("ksize", [3, 5, 7, 9, 11, 13, 15])
def test_abf_box_mean_division_exhaustive_on_the_card(cuda, ksize):
    """The plain version's box / k² on the card is numpy's IEEE f32 division
    for every reachable box value; dividing by the Python number is not."""
    box = np.arange(0, 255 * ksize * ksize + 1, dtype=np.float32)
    want = box / np.float32(ksize * ksize)
    got = box_mean(torch.from_numpy(box).to(cuda), ksize)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_abf_auto_on_a_cuda_tensor_launches_the_kernel(cuda):
    src, _ = images((50, 50), cuda)
    before = cuda_abf.launches
    out = vt.adaptive_bilateral_filter(src, 9, 10.0, 30.0)
    out_module = vt.AdaptiveBilateralFilter(50, 50)(src)
    assert cuda_abf.launches == before + 2
    assert out.is_cuda and torch.equal(out, _abf_math(src, 9, 10.0, 30.0))
    assert torch.equal(out_module, out)
    np.testing.assert_array_equal(
        out.cpu().numpy(),
        vt.adaptive_bilateral_filter(src.cpu().numpy(), 9, 10.0, 30.0, device="cpu").numpy())


def test_abf_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    src, _ = images((40, 64), cuda)
    view = src[:, ::2]
    np.testing.assert_array_equal(
        vt.adaptive_bilateral_filter(view, 5).cpu().numpy(),
        vt.adaptive_bilateral_filter(view.cpu().numpy(), 5, device="cpu").numpy())
    taps, lut = cuda_abf.device_tables(5, 10.0, 30.0, src.device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_abf.adaptive_bilateral_taps(view, taps, lut, 2)
    with pytest.raises(TypeError, match="uint8"):
        cuda_abf.adaptive_bilateral_taps(src.float(), taps, lut, 2)
    with pytest.raises(ValueError, match="shape"):
        cuda_abf.adaptive_bilateral_taps(src, taps, lut[:768].contiguous(), 2)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_abf.adaptive_bilateral(src, 301, 10.0, 30.0)


# -- the Wexler search kernel and the inpainting path --

def search_inputs(shape, t, initial, seed, max_value, device):
    """(p117, f13, valid) of a random image with values 0..max_value, a 5×5
    hole and t random targets; (20, 20) gets a hole pixel at (9, 9), which
    every 13×13 window covers."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = torch.from_numpy(rng.integers(0, max_value + 1, (h, w, 3)).astype(np.float32))
    rem = torch.zeros((h, w))
    rem[h // 3 : h // 3 + 5, w // 3 : w // 3 + 5] = 1.0
    rem[min(9, h - 1), min(9, w - 1)] = 1.0
    ty = torch.from_numpy(rng.integers(0, h, t))
    tx = torch.from_numpy(rng.integers(0, w, t))
    img, rem, ty, tx = (x.to(device) for x in (img, rem, ty, tx))
    f13, valid, _ = wexler._search_filters(img, rem, ty, tx, h, w, initial)
    return wexler._build_p117(img, w), f13, valid


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("t", [1, 7, 16, 256, 1000])
@pytest.mark.parametrize("shape", [(20, 20), (33, 41), (34, 45), (64, 200)])
def test_wexler_search_kernel_bit_exact_to_plain(cuda, shape, t, initial):
    """Values 0..127: every partial sum of the masked SSD is an integer below
    2²⁴, so any summation order gives the same bits."""
    p117, f13, valid = search_inputs(shape, t, initial, 5, 127, cuda)
    emin, idx = cuda_search.search_min(p117, f13, valid)
    emin_p, idx_p = search_op._search_min_math(p117, f13, valid)
    assert torch.equal(emin, emin_p) and torch.equal(idx, idx_p)
    if shape == (20, 20):
        assert not valid.any() and torch.isinf(emin).all() and not idx.any()


def search_case(img, rem, t, initial, seed, device):
    """(p117, f13, valid) of the image ``img`` (h, w, 3) with hole ``rem``
    and t random targets."""
    rng = np.random.default_rng(seed)
    h, w, _ = img.shape
    ty = torch.from_numpy(rng.integers(0, h, t))
    tx = torch.from_numpy(rng.integers(0, w, t))
    img, rem, ty, tx = (torch.as_tensor(x).to(device) for x in (img, rem, ty, tx))
    f13, valid, _ = wexler._search_filters(img.float(), rem.float(), ty, tx, h, w, initial)
    return wexler._build_p117(img.float(), w), f13, valid


def assert_search_bit_equal(p117, f13, valid):
    emin, idx = cuda_search.search_min(p117, f13, valid)
    emin_p, idx_p = search_op._search_min_math(p117, f13, valid)
    assert torch.equal(emin, emin_p) and torch.equal(idx, idx_p)
    return emin, idx


@pytest.mark.parametrize("t", [1, 16, 17, 64, 129, 1024])
@pytest.mark.parametrize("shape", [(37, 90), (34, 45), (41, 141)])
def test_wexler_search_kernel_bit_exact_on_tile_edges(cuda, shape, t):
    """n_cy not a multiple of the 4 candidate rows a block, n_cx not a
    multiple of its 64 columns, T not a multiple of its 128 targets."""
    n_cy, n_cx = shape[0] - 12, shape[1] - 12
    assert n_cy % 4 and n_cx % 64
    assert_search_bit_equal(*search_inputs(shape, t, False, 11, 127, cuda))


@pytest.mark.parametrize("t", [16, 300])
def test_wexler_search_kernel_one_valid_candidate(cuda, t):
    """Every block but one has no valid candidate (and returns at once); that
    one has a single valid candidate, which every target must pick."""
    p117, f13, valid = search_inputs((61, 200), t, False, 12, 127, cuda)
    one = torch.zeros_like(valid)
    one[21, 137] = True
    emin, idx = assert_search_bit_equal(p117, f13, one)
    assert (idx == 21 * valid.shape[1] + 137).all() and torch.isfinite(emin).all()


@pytest.mark.parametrize("period", [(2, 3), (6, 64), (1, 1)])
def test_wexler_search_kernel_ties_go_to_the_lowest_index(cuda, period):
    """A periodic image: windows one period apart are equal, so every energy
    is reached by candidates in two rows of one block (period 2), in two
    blocks along y (period 6 > 4 rows) and along x (period 64), or
    everywhere (a flat image).  The lowest raster index must win."""
    py, px = period
    rng = np.random.default_rng(13)
    cell = rng.integers(0, 128, (py, px, 3))
    img = np.tile(cell, (-(-90 // py), -(-200 // px), 1))[:90, :200].astype(np.float32)
    rem = np.zeros((90, 200), np.float32)
    rem[40:46, 90:97] = 1.0
    for initial in (False, True):
        p117, f13, valid = search_case(img, rem, 256, initial, 14, cuda)
        emin, idx = assert_search_bit_equal(p117, f13, valid)
        n_cx = valid.shape[1]
        cy, cx = idx.long() // n_cx, idx.long() % n_cx
        assert valid[cy, cx].all()


@pytest.mark.parametrize("shape", [(33, 41), (64, 200)])
def test_wexler_search_kernel_full_range_within_tolerance(cuda, shape):
    """Values 0..255: sums pass 2²⁴ and round in each order.  Energies within
    max(4, 1e-6·S), S the f64 sum of the absolute terms; picks equal where
    the best energy leads the second best by more than twice that."""
    p117, f13, valid = search_inputs(shape, 256, False, 6, 255, cuda)
    emin, idx = cuda_search.search_min(p117, f13, valid)
    emin_p, idx_p = search_op._search_min_math(p117, f13, valid)
    n_cy, n_cx = valid.shape
    a = p117.double().unfold(0, 13, 1).permute(0, 1, 3, 2).reshape(n_cy * n_cx, -1)
    e = a @ f13.double().reshape(a.shape[1], -1)
    s = (a @ f13.double().abs().reshape(a.shape[1], -1)).gather(0, idx_p.long()[None])[0]
    tol = torch.clamp(1e-6 * s, min=4.0)
    assert ((emin.double() - emin_p.double()).abs() <= tol).all()
    e = torch.where(valid.reshape(-1, 1), e, torch.inf)
    two = torch.topk(e, 2, dim=0, largest=False).values
    clear = (two[1] - two[0]) > 2 * tol
    assert clear.any() and torch.equal(idx[clear], idx_p[clear])


def test_wexler_search_auto_launches_the_kernel(cuda):
    p117, f13, valid = search_inputs((34, 45), 16, False, 7, 127, cuda)
    before, plain = cuda_search.launches, search_op.plain_searches
    emin, idx = search_op.search_min(p117, f13, valid)
    assert cuda_search.launches == before + 1 and search_op.plain_searches == plain
    emin_p, idx_p = search_op.search_min(p117, f13, valid, impl="torch")
    assert search_op.plain_searches == plain + 1
    assert torch.equal(emin, emin_p) and torch.equal(idx, idx_p)


def test_wexler_search_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    p117, f13, valid = search_inputs((34, 45), 16, False, 8, 127, cuda)
    with pytest.raises(TypeError):
        cuda_search.search_min(p117.float(), f13, valid)
    with pytest.raises(TypeError):
        cuda_search.search_min(p117, f13, valid.int())
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_search.search_min(p117.cpu(), f13, valid)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_search.search_min(p117[:, ::2], f13, valid[:, ::2])
    with pytest.raises(ValueError, match="shape"):
        cuda_search.search_min(p117, f13, valid[1:].contiguous())
    with pytest.raises(ValueError, match="channel"):
        cuda_search.search_min(p117, f13[:, :100].contiguous(), valid)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_search.search_min(p117, f13, valid.cpu())
    with pytest.raises(ValueError, match="no candidate"):
        cuda_search.search_min(p117[:12].contiguous(), f13, valid[:0])


def stripes(size_hw, lo, hi):
    h, w = size_hw
    row = ((np.arange(w) // 4) % 2 * (hi - lo) + lo).astype(np.uint8)
    return np.ascontiguousarray(np.broadcast_to(row[None, :, None], (h, w, 3)))


@pytest.mark.parametrize("case", ["stripes72", "texture128x160"])
def test_wexler_kernel_path_equals_plain_path(cuda, case):
    if case == "stripes72":
        img = stripes((72, 72), 20, 120)
        mask = np.zeros((72, 72), np.uint8)
        mask[30:38, 30:38] = 255
    else:
        img = np.tile(random_image(37, 53) // 2, (4, 4, 1))[:128, :160].copy()
        mask = np.zeros((128, 160), np.uint8)
        mask[50:74, 60:90] = 255
        mask[100:104, 20:140] = 255
    src, hole = torch.from_numpy(img).to(cuda), torch.from_numpy(mask).to(cuda)
    before, plain = cuda_search.launches, search_op.plain_searches
    out = vt.inpainting_wexler(src, hole)
    assert cuda_search.launches > before and search_op.plain_searches == plain
    ref = vt.inpainting_wexler(src, hole, impl="torch")
    assert out.is_cuda and torch.equal(out, ref)
    known = torch.from_numpy(mask == 0).to(cuda)
    assert torch.equal(out[known], src[known])
