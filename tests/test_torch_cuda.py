"""The port's CUDA kernels on the card, held bit-exact to their plain
PyTorch versions.  Every test here needs an NVIDIA GPU and skips without one; this
file imports neither jax nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_array, random_image  # noqa: E402
from various_image_processings_tpu_torch.core.luts import (  # noqa: E402
    COLOR_TABLE_SIZE_ADAPTIVE, color_table, space_kernel, tap_table)
from various_image_processings_tpu_torch.ops.adaptive_bilateral import (  # noqa: E402
    _abf_math, _abf_taps_math, box_mean)
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
from various_image_processings_tpu_torch.ops.cuda import wexler_fill as cuda_fill  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import wexler_search as cuda_search  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda._build import load_library, plan  # noqa: E402
from various_image_processings_tpu_torch.ops.gradient import _gradient_math  # noqa: E402
from guide_ties import tie_inputs  # noqa: E402
from test_torch_wexler_diffusion_strips import (  # noqa: E402
    BOXES as DIFFUSION_BOXES, case as diffusion_case, strip_diffusion)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@functools.cache
def _random_image(shape):
    return random_image(*shape)


def images(shape, device):
    src = _random_image(shape)
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(src[::-1].copy()).to(device))


# heights on both sides of the blocked path's (16 rows and less: the 8-row
# blocks of 4 pixels 32 apart; more: 32-row blocks of 4 adjacent pixels a
# thread, rows past the frame masked), widths with a ragged last block of 32
# and 128 columns and a thread whose 4 columns cross the frame's edge; the
# blocked path takes k = 11, 17 and 27 (k = 1, 3 and 9 go to the 4-pixel path)
BILATERAL_SHAPES = [(37, 61), (8, 5), (1, 61), (2, 5), (3, 900), (5, 61), (16, 61), (17, 5),
                    (600, 900), (2160, 3840)]


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"), ("reflect101", "rint")])
@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("ksize", [1, 3, 9, 11, 17, 27])
@pytest.mark.parametrize("shape", BILATERAL_SHAPES)
def test_kernel_bit_exact_to_plain(cuda, shape, ksize, joint, border, rounding):
    src, guide = images(shape, cuda)
    got = cuda_bf.bilateral(src, guide if joint else None, ksize, 10.0, 30.0, border, rounding)
    expected = _bilateral_math(src, guide if joint else src, ksize, 10.0, 30.0,
                               border, rounding)
    torch.cuda.synchronize()
    assert torch.equal(got, expected)


# (radius, height, columns a thread): the smallest radius of the blocked path
# and the one below, the largest and the next (the 4-pixel path), on the
# lowest frame it takes, a lower one and a taller one
@pytest.mark.parametrize("radius,height,cols", [(4, 600, 0), (5, 600, 4), (5, 17, 4), (5, 16, 0),
                                                (31, 17, 4), (32, 17, 0), (31, 600, 4),
                                                (32, 600, 0)])
@pytest.mark.parametrize("joint", [False, True])
def test_blocked_path_handover_is_bit_exact(cuda, joint, radius, height, cols):
    """The circle of the radius (every tap of its window but the corners),
    bit-equal to the plain version on both sides of each handover, the
    counter of blocked launches rising only where the path is taken."""
    lib = load_library()
    assert lib.vip_bilateral_columns_per_thread(radius, height) == cols
    src, guide = images((height, 45), cuda)
    table = tap_table(space_kernel(2 * radius + 1, 10.0))
    _, lut = cuda_bf.device_tables(3, 10.0, 30.0, cuda)
    for border, rounding in [("replicate", "trunc"), ("reflect101", "rint")]:
        before = cuda_bf.blocked_calls
        got = cuda_bf.joint_bilateral(src, guide if joint else None,
                                      torch.from_numpy(table).to(cuda), lut, radius,
                                      border, rounding)
        assert cuda_bf.blocked_calls == before + (cols != 0)
        want = _taps_math(src, guide if joint else src, table, lut, radius, border, rounding)
        assert torch.equal(got, want)


@pytest.mark.parametrize("joint", [False, True])
def test_blocked_path_on_runs_shorter_than_a_thread(cuda, joint):
    """A sparse table whose tap rows hold runs of 1 to 5 taps and gaps: the
    runs shorter than a thread's 4 outputs go output by output."""
    radius = 6
    pos = [(0, 6), (1, 2), (1, 3), (1, 7), (1, 8), (1, 9), (2, 0), (2, 1), (2, 2), (2, 3),
           (2, 4), (2, 10), (3, 5), (3, 7), (6, 6), (9, 1), (9, 2), (9, 3), (9, 4), (9, 5),
           (9, 6), (12, 12)]
    table = np.zeros((len(pos), 4), np.int32)
    table[:, :2] = pos
    table[:, 2] = (0.0625 + np.arange(len(pos)) / len(pos)).astype(np.float32).view(np.int32)
    src, guide = images((45, 70), cuda)
    assert plan("vip_bilateral_columns_per_thread", radius, 45) == 4
    bf_case(src, guide if joint else None, table, radius, cuda)


# (joint, shape, ksize, blocked): the benchmark's cells, and a 4K BF at k=17
@pytest.mark.parametrize("joint,shape,ksize,blocked", [(False, (2160, 3840), 9, False),
                                                       (True, (600, 900), 17, True),
                                                       (True, (2160, 3840), 17, True),
                                                       (False, (2160, 3840), 17, True)])
def test_blocked_path_counter_rises_once_a_blocked_launch(cuda, joint, shape, ksize, blocked):
    """The BTF's k′=17 joint filter takes the blocked path at every launch,
    through the op as through the wrapper, and the k=9 BF never; the
    counter is not a launch counter."""
    src, guide = images(shape, cuda)
    launches, calls = cuda_bf.launches, cuda_bf.blocked_calls
    for _ in range(3):
        if joint:
            vt.joint_bilateral_filter(src, guide, ksize, 8.0, 3.0 ** 0.5)
        else:
            vt.bilateral_filter(src, ksize, 10.0, 30.0)
    assert cuda_bf.launches - launches == 3
    assert cuda_bf.blocked_calls - calls == (3 if blocked else 0)
    assert plan("vip_bilateral_columns_per_thread", ksize // 2, shape[0]) == 4 * blocked


# -- the unrolled path: the circle of k = 3 to 9 unrolled at compile time --

@functools.cache
def _photo_like(shape):
    """A frame like a photograph: smooth shading, curved edges, noise of
    σ 2.5 (the benchmark's photo-like traffic in spirit; made here with
    numpy)."""
    h, w = shape
    rng = np.random.default_rng(h * 7919 + w)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        img[..., c] = (128 + 60 * np.sin(xx / (37.0 + 11 * c)) * np.cos(yy / (23.0 + 5 * c))
                       + 50 * (np.hypot(yy - h / 2, xx - w / 3) < min(h, w) / 3)
                       - 40 * (yy + 0.5 * xx > (h + w) / 2))
    img += rng.normal(0.0, 2.5, img.shape).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def frames(kind, shape, device):
    """(src, guide): noise or a photo-like frame, the guide the frame upside down."""
    src = _random_image(shape) if kind == "noise" else _photo_like(shape)
    return (torch.from_numpy(src).to(device),
            torch.from_numpy(src[::-1].copy()).to(device))


UNROLLED_SHAPES = [(1, 1), (3, 5), (17, 33), (61, 97), (512, 512), (2160, 3840)]
MODES = [(b, r) for b in ("replicate", "reflect101") for r in ("trunc", "rint")]


@pytest.mark.parametrize("kind", ["noise", "photo"])
@pytest.mark.parametrize("shape", UNROLLED_SHAPES)
@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_unrolled_path_bit_exact_to_plain(cuda, ksize, joint, shape, kind):
    """Every border and rounding, on frames down to one pixel and with
    ragged blocks, through the unrolled path, counted once a launch."""
    src, guide = frames(kind, shape, cuda)
    assert plan("vip_bilateral_path", ksize // 2, int(joint), shape[0]) == cuda_bf.UNROLLED
    for border, rounding in MODES:
        before = (cuda_bf.launches, cuda_bf.unrolled_calls, cuda_bf.blocked_calls)
        got = cuda_bf.bilateral(src, guide if joint else None, ksize, 10.0, 30.0, border,
                                rounding)
        after = (cuda_bf.launches, cuda_bf.unrolled_calls, cuda_bf.blocked_calls)
        assert [b - a for a, b in zip(before, after)] == [1, 1, 0]
        want = _bilateral_math(src, guide if joint else src, ksize, 10.0, 30.0, border, rounding)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_unrolled_path_on_tables_with_taps_left_out(cuda, ksize, joint):
    """A table that holds part of the circle (a tiny σs drops the outer
    taps; a random half): the left-out taps add exactly 0."""
    r = ksize // 2
    src, guide = images((61, 97), cuda)
    _, lut = cuda_bf.device_tables(3, 10.0, 30.0, cuda)
    full = tap_table(space_kernel(ksize, 10.0))
    keep = np.random.default_rng(ksize).random(len(full)) < 0.5
    keep[len(full) // 2] = True
    for table in (tap_table(space_kernel(ksize, 0.3)), full[keep]):
        for border, rounding in MODES:
            got = cuda_bf.joint_bilateral(src, guide if joint else None,
                                          torch.from_numpy(table).to(cuda), lut, r, border,
                                          rounding)
            want = _taps_math(src, guide if joint else src, table, lut, r, border, rounding)
            assert torch.equal(got, want)


# (radius, height, path): the unrolled path's largest radius and the next
# (path 1 over 16 rows, else 4 pixels 32 apart), its smallest and the one
# below (k = 1), on frames of 16 rows and more
@pytest.mark.parametrize("radius,height,path", [(4, 600, 4), (5, 600, 1), (4, 16, 4), (5, 16, 2),
                                                (4, 17, 4), (5, 17, 1), (1, 17, 4), (0, 17, 2)])
@pytest.mark.parametrize("joint", [False, True])
def test_unrolled_path_handover_is_bit_exact(cuda, joint, radius, height, path):
    src, guide = images((height, 45), cuda)
    assert plan("vip_bilateral_path", radius, int(joint), height) == path
    table = tap_table(space_kernel(2 * radius + 1, 10.0))
    _, lut = cuda_bf.device_tables(3, 10.0, 30.0, cuda)
    for border, rounding in [("replicate", "trunc"), ("reflect101", "rint")]:
        before = (cuda_bf.unrolled_calls, cuda_bf.blocked_calls)
        got = cuda_bf.joint_bilateral(src, guide if joint else None,
                                      torch.from_numpy(table).to(cuda), lut, radius,
                                      border, rounding)
        assert (cuda_bf.unrolled_calls - before[0], cuda_bf.blocked_calls - before[1]) == \
            (int(path == cuda_bf.UNROLLED), int(path == cuda_bf.BLOCKED))
        want = _taps_math(src, guide if joint else src, table, lut, radius, border, rounding)
        assert torch.equal(got, want)


# (joint, shape, ksize, unrolled): the benchmark's cells
@pytest.mark.parametrize("joint,shape,ksize,unrolled", [(False, (2160, 3840), 9, True),
                                                        (False, (512, 512), 9, True),
                                                        (True, (600, 900), 17, False),
                                                        (True, (2160, 3840), 17, False)])
def test_unrolled_counter_rises_once_an_unrolled_launch(cuda, joint, shape, ksize, unrolled):
    """The k=9 BF takes the unrolled path at every call through the op, the
    BTF's k′=17 joint filter never; the counter is not a launch counter."""
    src, guide = images(shape, cuda)
    launches, calls = cuda_bf.launches, cuda_bf.unrolled_calls
    for _ in range(3):
        if joint:
            vt.joint_bilateral_filter(src, guide, ksize, 8.0, 3.0 ** 0.5)
        else:
            vt.bilateral_filter(src, ksize, 10.0, 30.0)
    assert cuda_bf.launches - launches == 3
    assert cuda_bf.unrolled_calls - calls == (3 if unrolled else 0)


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
    """A window whose halo tile does not fit one block's shared memory does
    not raise: the kernel streams the tile through in bands, bit-equal to
    the plain version."""
    src, guide = images((8, 8), cuda)
    for g in (None, guide):
        got = cuda_bf.bilateral(src, g, 301, 10.0, 30.0)
        assert torch.equal(got, _bilateral_math(src, src if g is None else g, 301, 10.0, 30.0))


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


# (joint, radius): the largest radius whose whole tile fits (k = 219 self,
# 149 joint), and the radii on both sides of the switch from 4 pixels a
# thread to 1
@pytest.mark.parametrize("joint,radius", [(False, 109), (True, 74), (False, 88), (False, 89),
                                          (True, 55), (True, 56)])
def test_largest_accepted_radius_is_no_smaller_than_before(cuda, joint, radius):
    src, guide = images((23, 37), cuda)
    _, lut = cuda_bf.device_tables(3, 10.0, 30.0, src.device)
    table = sparse_taps(radius)
    taps = torch.from_numpy(table).to(cuda)
    pixels = plan("vip_bilateral_pixels_per_thread", radius, int(joint))
    assert pixels == (4 if radius <= (55 if joint else 88) else 1)
    for border, rounding in [("replicate", "trunc"), ("reflect101", "rint")]:
        got = cuda_bf.joint_bilateral(src, guide if joint else None, taps, lut, radius,
                                      border, rounding)
        want = _taps_math(src, guide if joint else src, table, lut, radius, border, rounding)
        assert torch.equal(got, want)
    if radius in (109, 74):  # one radius more: the tile goes in bands, bit-equal all the same
        assert plan("vip_bilateral_band", radius, int(joint), 0) == 2 * radius + 1
        assert plan("vip_bilateral_band", radius + 1, int(joint), 0) < 2 * radius + 3
        table = sparse_taps(radius + 1)
        got = cuda_bf.joint_bilateral(src, guide if joint else None,
                                      torch.from_numpy(table).to(cuda), lut, radius + 1)
        assert torch.equal(got, _taps_math(src, guide if joint else src, table, lut, radius + 1))


# -- gradient, blur + mRTV and guide kernels; the bilateral texture filter --

STAGE_SHAPES = [(1, 1), (8, 5), (37, 61), (64, 31)]


# rows that are whole words (width % 4 == 0, the u8 word kernel) and rows
# that are not (3 * 61 = 183 bytes), one row, one column, a ragged last
# warp (260 = 2 * 128 + 4), the BTF's 600x900
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("channels", [1, 3, 2, 4])
@pytest.mark.parametrize("shape", [(1, 1), (8, 5), (37, 61), (5, 183), (600, 900), (1, 64),
                                   (64, 1), (13, 260)])
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


def test_gradient_kernel_on_an_unaligned_u8_image(cuda):
    """A contiguous u8 image one byte past a word boundary goes to the
    general kernel, bit-equal all the same."""
    flat = torch.from_numpy(random_array(37 * 64 * 3 + 1)).to(cuda)
    src = flat[1:].view(37, 64, 3)
    assert src.is_contiguous() and src.data_ptr() % 4 != 0
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


# widths that are not a multiple of 4 (the guide's scalar path), that leave
# a ragged last block of 4 columns, and whole 16-byte rows
@pytest.mark.parametrize("ksize", [1, 3, 9, 15, 223])
@pytest.mark.parametrize("shape", [(37, 61), (20, 132), (64, 200)])
def test_guide_kernel_bit_exact_on_ties(cuda, shape, ksize):
    """Windows with equal minima in different rows and columns, and whole
    flat windows: the separable argmin keeps the first minimum in (ky, kx)
    order, as the plain version's scan does."""
    blurred, rtv = (torch.from_numpy(a).to(cuda) for a in tie_inputs(*shape, shape[0] * shape[1]))
    got = cuda_btf.guide(blurred, rtv, ksize)
    assert torch.equal(got, _guide_math(blurred, rtv, ksize).to(torch.uint8))


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
    with pytest.raises(ValueError, match="odd"):
        cuda_btf.blur_and_rtv(img, magnitude, 8)
    blurred, rtv = cuda_btf.blur_and_rtv(img, magnitude, 3)
    with pytest.raises(TypeError):
        cuda_btf.guide(blurred.double(), rtv, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_btf.guide(blurred.transpose(0, 1), rtv.t(), 3)
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
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_abf.adaptive_bilateral_taps(src.cpu(), taps, lut, 2)


# -- every radius: halo tiles that do not fit one block go through in bands --

def band_taps(radius, rows=None, cols=None):
    """A sparse (ky, kx)-ordered tap table over a (2r+1)² window with taps on
    both sides of the band edges: tap rows rows−1, rows, 2·rows−1 and
    2·rows, and where one tap row is cut into segments of ``cols`` columns,
    tap columns cols−1 and cols."""
    d = 2 * radius
    ys = {0, radius, d} | ({rows - 1, rows, 2 * rows - 1, 2 * rows} if rows else set())
    xs = {0, radius, d} | ({cols - 1, cols} if cols else set())
    pos = sorted((y, x) for y in ys for x in xs if y <= d and x <= d)
    ws = (0.125 + np.arange(len(pos)) / len(pos)).astype(np.float32)
    table = np.zeros((len(pos), 4), np.int32)
    table[:, :2] = pos
    table[:, 2] = ws.view(np.int32)
    return table


def bf_case(src, guide, table, radius, cuda, modes=(("replicate", "trunc"),
                                                    ("reflect101", "rint"))):
    _, lut = cuda_bf.device_tables(3, 10.0, 30.0, cuda)
    for border, rounding in modes:
        got = cuda_bf.joint_bilateral(src, guide, torch.from_numpy(table).to(cuda), lut, radius,
                                      border, rounding)
        want = _taps_math(src, src if guide is None else guide, table, lut, radius, border,
                          rounding)
        assert torch.equal(got, want)


@pytest.mark.parametrize("joint,ksize", [(False, 221), (True, 151)])
def test_bilateral_bit_exact_just_past_the_one_tile_limit(cuda, joint, ksize):
    """The first k whose one-pixel tile does not fit (old limit 219 self,
    149 joint), with the filter's whole tap table: chunk edges fall inside
    and across bands."""
    src, guide = images((23, 37), cuda)
    assert plan("vip_bilateral_band", ksize // 2, int(joint), 0) < ksize
    mode = ("reflect101", "rint") if joint else ("replicate", "trunc")
    got = cuda_bf.bilateral(src, guide if joint else None, ksize, 10.0, 30.0, *mode)
    assert torch.equal(got, _bilateral_math(src, guide if joint else src, ksize, 10.0, 30.0,
                                            *mode))


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("radius", [75, 110, 150, 200])
def test_bilateral_bit_exact_at_band_edges(cuda, joint, radius):
    src, guide = images((23, 37), cuda)
    rows = plan("vip_bilateral_band", radius, int(joint), 0)
    bf_case(src, guide if joint else None, band_taps(radius, rows=min(rows, 2 * radius)),
            radius, cuda)


def first_cut_radius(band, start):
    """The smallest radius ≥ start whose band is a segment of one tap row."""
    lo, hi = start, 8 * start
    assert band(hi, 1) < 2 * hi + 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if band(mid, 1) < 2 * mid + 1 else (mid, hi)
    return hi


@pytest.mark.parametrize("joint", [False, True])
def test_bilateral_bit_exact_on_column_segments(cuda, joint):
    """Past k ≈ 3521 (joint) and 7073 (self) one tap row of the tile does not
    fit: a band is a segment of one tap row."""
    lib = load_library()
    radius = first_cut_radius(lambda r, w: lib.vip_bilateral_band(r, int(joint), w), 1000)
    assert lib.vip_bilateral_band(radius, int(joint), 0) == 1
    cols = lib.vip_bilateral_band(radius, int(joint), 1)
    src, guide = images((23, 37), cuda)
    bf_case(src, guide if joint else None, band_taps(radius, rows=1, cols=cols), radius, cuda,
            modes=(("replicate", "trunc"),))


def abf_taps_case(src, table, radius, cuda):
    lut = torch.from_numpy(color_table(30.0, COLOR_TABLE_SIZE_ADAPTIVE)).to(cuda)
    got = cuda_abf.adaptive_bilateral_taps(src, torch.from_numpy(table).to(cuda), lut, radius)
    assert torch.equal(got, _abf_taps_math(src, table, lut, radius))


def test_abf_bit_exact_just_past_the_one_tile_limit(cuda):
    """k = 179 (old limit 177) with the filter's whole tap table."""
    assert plan("vip_adaptive_bilateral_band", 89, 0) < 179
    abf_bit_exact(random_image(23, 37), 179, 10.0, 30.0, cuda)


@pytest.mark.parametrize("radius", [89, 110, 150, 200])
def test_abf_bit_exact_at_band_edges(cuda, radius):
    src, _ = images((23, 37), cuda)
    rows = plan("vip_adaptive_bilateral_band", radius, 0)
    abf_taps_case(src, band_taps(radius, rows=min(rows, 2 * radius)), radius, cuda)


def test_abf_bit_exact_on_column_segments(cuda):
    """Past k ≈ 6497 a band is a segment of one tap row, for the box sums
    and the taps alike."""
    lib = load_library()
    radius = first_cut_radius(lib.vip_adaptive_bilateral_band, 1000)
    assert lib.vip_adaptive_bilateral_band(radius, 0) == 1
    src, _ = images((23, 37), cuda)
    abf_taps_case(src, band_taps(radius, rows=1,
                                 cols=lib.vip_adaptive_bilateral_band(radius, 1)),
                  radius, cuda)


@pytest.mark.parametrize("ksize,bright", [(121, False), (223, False), (257, True), (301, True)])
def test_blur_rtv_and_guide_bit_exact_in_bands(cuda, ksize, bright):
    """Past k = 119 (blur + mRTV) and 109 (guide) the tiles go in bands.
    Past k = 255 a window's box sum can pass 2²⁴, where the plain version's
    f32 sum rounds in (ky, kx) order, and so does the kernel's: a bright
    image (values 250..255) makes it round."""
    assert plan("vip_blur_rtv_band", ksize // 2, 0) < ksize
    assert plan("vip_guide_band", ksize // 2, 0) < ksize
    img_np = random_image(19, 29)
    if bright:
        img_np = (250 + img_np % 6).astype(np.uint8)
    img = torch.from_numpy(img_np).to(cuda)
    magnitude = _gradient_math(img.float())
    blurred, rtv = cuda_btf.blur_and_rtv(img, magnitude, ksize)
    blurred_p, rtv_p = _blur_and_rtv_math(img.float(), magnitude, ksize)
    assert torch.equal(blurred, blurred_p) and torch.equal(rtv, rtv_p)
    guide = cuda_btf.guide(blurred, rtv, ksize)
    assert torch.equal(guide, _guide_math(blurred, rtv, ksize).to(torch.uint8))


def test_btf_k77_auto_equals_plain(cuda):
    """A BTF at k = 77 runs its JBF at k′ = 153, past the one-tile limit of
    149: on the card it launches its four kernels and equals impl="torch"."""
    src, _ = images((20, 30), cuda)
    counts = (cuda_grad.launches, cuda_btf.blur_rtv_launches, cuda_btf.guide_launches,
              cuda_bf.launches)
    out = vt.bilateral_texture_filter(src, 77, 1)
    after = (cuda_grad.launches, cuda_btf.blur_rtv_launches, cuda_btf.guide_launches,
             cuda_bf.launches)
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1, 1]
    assert torch.equal(out, vt.bilateral_texture_filter(src, 77, 1, impl="torch"))


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


def hole_psnr(out, truth, hole):
    mse = float(((out.double() - truth.double())[hole] ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("image", ["tiled", "smooth"])
def test_wexler_full_range_fill_within_the_psnr_window(cuda, image):
    """Values 0..255: the search's sums pass 2²⁴ and round in the kernel's
    order, so the kernel path may pick other candidates than the plain path
    on near-ties.  The fill of the 402×700 config-5a hole must stay within
    the window PARITY.md sets for the JAX fill against the reference: hole
    PSNR (against the true image) no more than 2 dB below the plain path's.
    A tile of random_image(37, 53) holds the true content elsewhere; a
    bicubic upsampling of random_image(26, 44) holds no exact repeat."""
    if image == "tiled":
        src = torch.from_numpy(np.tile(random_image(37, 53), (11, 14, 1))[:402, :700].copy())
        src = src.to(cuda)
    else:
        coarse = torch.from_numpy(random_image(26, 44)).to(cuda).permute(2, 0, 1)[None].float()
        smooth = torch.nn.functional.interpolate(coarse, size=(402, 700), mode="bicubic",
                                                 align_corners=False)
        src = smooth.round().clamp(0, 255)[0].permute(1, 2, 0).to(torch.uint8).contiguous()
    mask = np.zeros((402, 700), np.uint8)
    mask[201 - 32 : 201 + 32, 350 - 32 : 350 + 32] = 255
    hole = torch.from_numpy(mask).to(cuda)
    out = vt.inpainting_wexler(src, hole)
    ref = vt.inpainting_wexler(src, hole, impl="torch")
    inside = hole > 0
    assert torch.equal(out[~inside], src[~inside])
    assert hole_psnr(out, src, inside) >= hole_psnr(ref, src, inside) - 2.0


def fill_case(name):
    """(image u8, hole bool, box (bh, bw, by0, bx0) or None for the bucketed
    box): the fill kernels' cases.  The tight boxes are 33 and 65 pixels
    wide (one ring-pick word and one pixel, two words and one), one row, at
    the image's left edge (the validity region starts at column 0), and the
    whole 402x700 image for config 5c's mask with an annulus around a known
    island."""
    img = np.tile(random_image(37, 53) // 2, (11, 14, 1))
    yy, xx = np.mgrid[:60, :70]
    holes = {
        "square": (slice(20, 30), slice(25, 37)),
        "border": (slice(0, 9), slice(50, 70)),
        "width 33": (slice(20, 31), slice(17, 50)),
        "width 65": (slice(22, 27), slice(2, 67)),
        "one row": (slice(33, 34), slice(9, 61)),
        "left edge": (slice(14, 40), slice(0, 23)),
    }
    if name == "annulus":
        d = (yy - 30) ** 2 + (xx - 35) ** 2
        return img[:60, :70].copy(), (d <= 144) & (d > 9), None
    if name == "lone":
        hole = np.zeros((20, 20), bool)
        hole[9, 9] = True
        return img[:20, :20].copy(), hole, None
    if name == "5c island":
        h, w = 402, 700
        cy, cx = h // 2, w // 2
        yy, xx = np.mgrid[:h, :w]
        hole = np.zeros((h, w), bool)
        hole[cy - 40 : cy + 8, cx - 50 : cx - 30] = True
        hole[cy - 8 : cy + 8, cx - 50 : cx + 10] = True
        hole[(yy - (cy + 60)) ** 2 + (xx - (cx + 80)) ** 2 <= 18 ** 2] = True
        hole[cy + 100 : cy + 104, cx - 60 : cx + 60] = True
        d = (yy - 90) ** 2 + (xx - 150) ** 2
        hole[(d <= 14 ** 2) & (d > 4 ** 2)] = True
        return img[:h, :w].copy(), hole, (h, w, 0, 0)
    hole = np.zeros((60, 70), bool)
    hole[holes[name]] = True
    ys, xs = holes[name]
    box = None if name in ("square", "border") else (ys.stop - ys.start, xs.stop - xs.start,
                                                     ys.start, xs.start)
    return img[:60, :70].copy(), hole, box


def fill_passes(name, initial, cap, device):
    """A kernel pass and a plain pass on the card from the same inputs."""
    img, hole, box = fill_case(name)
    if not initial:
        img[hole] = 64
    h, w = hole.shape
    (bh, bw), (by0, bx0) = wexler.WexlerInpainting._hole_bbox(hole) if box is None else (
        box[:2], box[2:])
    island = wexler._island_known(hole) if initial else None
    rem = torch.from_numpy(hole.astype(np.float32)).to(device)
    weight = torch.from_numpy(wexler.calculate_weight(hole).astype(np.float32)).to(device)
    island = None if island is None else torch.from_numpy(island.astype(np.float32)).to(device)
    x = torch.from_numpy(img).to(device).float()
    return [wexler._FillPass(x, rem, weight, h, w, initial, cap, (bh, bw, by0, bx0), island,
                             route) for route in ("cuda", "torch")]


FILL_BUFFERS = ("img", "rem", "p", "f", "b2", "valid", "tyx", "state")


@pytest.mark.parametrize("name,initial,cap", [("square", True, 256), ("square", False, 16),
                                              ("border", True, 32), ("annulus", True, 64),
                                              ("annulus", False, 1024), ("lone", True, 16),
                                              ("width 33", True, 32), ("width 33", False, 64),
                                              ("width 65", True, 16), ("width 65", False, 256),
                                              ("one row", True, 8), ("one row", False, 16),
                                              ("left edge", True, 64), ("left edge", False, 128),
                                              ("5c island", True, 1024)])
def test_wexler_fill_kernels_bit_equal_to_plain_pieces(cuda, name, initial, cap):
    """Each piece from the same state: every buffer bit-equal after it (the
    search's keys where a target uses them); the whole-image 5c pass for 8
    iterations, the others to their end."""
    k, p = fill_passes(name, initial, cap, cuda)
    whole = name == "5c island"
    assert (k.island is not None) == (initial and name in ("annulus", "5c island"))
    for _ in range(8 if whole else 64):
        for piece in ("ring_pick", "filters", "search", "commit"):
            for buf in FILL_BUFFERS + ("keys",):
                getattr(p, buf).copy_(getattr(k, buf))
            getattr(k, piece)()
            getattr(p, piece)()
            for buf in FILL_BUFFERS:
                a, b = getattr(k, buf), getattr(p, buf)
                if a.is_floating_point():
                    a, b = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32), \
                        b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32)
                assert torch.equal(a, b), (piece, buf)
            assert torch.equal(k.keys[:cap], p.keys[:cap]), piece
        if not int(k.state[cuda_fill.ACTIVE]):
            break
    assert int(k.state[cuda_fill.ACTIVE]) == whole
    assert int(k.state[cuda_fill.FAIL]) == (name == "lone")


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("shape", [(128, 128), (50, 87)])
def test_wexler_diffusion_kernel_bit_equal_to_plain(cuda, shape, dither):
    h, w = shape
    img = torch.from_numpy(random_image(h, w)).to(cuda)
    hole = np.zeros((h, w), bool)
    hole[h // 5 : h - h // 6, w // 4 : w - w // 5] = True
    (bh, bw), (by0, bx0) = wexler.WexlerInpainting._hole_bbox(hole)
    rem = torch.from_numpy(hole.astype(np.float32)).to(cuda)
    before = cuda_fill.diffusion_launches
    got = wexler._alt_init_device(img, rem, h, w, (bh, bw), (by0, bx0), dither)
    assert cuda_fill.diffusion_launches == before + 1
    want = wexler._alt_init_device(img, rem, h, w, (bh, bw), (by0, bx0), dither, "torch")
    assert torch.equal(got, want)


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("label", [b[0] for b in DIFFUSION_BOXES])
def test_wexler_diffusion_kernel_on_every_box_shape(cuda, label, dither):
    """The cluster kernel on boxes from 1x1 to 128x128 (a row, a column, a
    box with fewer rows than 16 strips, a box at the image border): one
    launch of min(bh, 16) CTAs a channel, bit-equal to the plain version on
    the card and to the CPU strip twin."""
    _, h, w, box = next(b for b in DIFFUSION_BOXES if b[0] == label)
    bh, bw, by0, bx0 = box
    src, rem0 = diffusion_case(h, w, box)
    img, rem = torch.from_numpy(src).to(cuda), torch.from_numpy(rem0).to(cuda)
    assert cuda_fill.diffusion_shape(bh, bw)[0] == min(bh, 16)
    before = cuda_fill.diffusion_launches
    got = wexler._alt_init_device(img, rem, h, w, (bh, bw), (by0, bx0), dither)
    assert cuda_fill.diffusion_launches == before + 1
    want = wexler._alt_init_device(img, rem, h, w, (bh, bw), (by0, bx0), dither, "torch")
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), strip_diffusion(src, rem0, box, dither))


def test_wexler_fill_wrappers_reject_what_the_kernels_do_not_take(cuda):
    k, _ = fill_passes("square", True, 16, cuda)
    box = k.box
    pick = cuda_fill.ring_pick_launcher
    with pytest.raises(TypeError):
        pick(k.rem.double(), k.rem0, None, k.tyx, k.keys, k.state, box, True)
    with pytest.raises(ValueError, match="shape"):
        pick(k.rem, k.rem0[1:].contiguous(), None, k.tyx, k.keys, k.state, box, True)
    with pytest.raises(ValueError, match="box"):
        pick(k.rem, k.rem0, None, k.tyx, k.keys, k.state, (61, 70, 0, 0), True)
    wide = torch.zeros((2, 2048), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="cap"):
        cuda_fill.commit_launcher(k.img, k.rem, k.p, k.keys, k.b2, wide, k.weight, k.state)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_fill.filters_launcher(k.img.cpu(), k.rem, k.tyx, k.state, k.f, k.b2, k.valid, box,
                                   True)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_fill.diffusion(torch.zeros((200, 200, 3), dtype=torch.uint8, device=cuda),
                            torch.zeros((200, 200), device=cuda), (200, 200, 0, 0), False, 1 / 9)


def test_wexler_kernel_path_runs_four_launches_an_iteration(cuda):
    """Filters, search and commit once an iteration, the ring pick once more
    at the end of each onion-peel pass; no plain piece; the host reads the
    mask pyramid, the onion peel's active flag and its energy."""
    img, mask = stripes((72, 72), 20, 120), np.zeros((72, 72), np.uint8)
    mask[30:38, 30:38] = 255
    src, hole = torch.from_numpy(img).to(cuda), torch.from_numpy(mask).to(cuda)
    counts = (cuda_fill.ring_pick_launches, cuda_fill.filters_launches, cuda_search.launches,
              cuda_fill.commit_launches)
    wexler.plain_pieces = wexler.host_syncs = 0
    out = vt.inpainting_wexler(src, hole, multi_start=1)
    ring, filt, search, commit = (b - a for a, b in zip(counts, (
        cuda_fill.ring_pick_launches, cuda_fill.filters_launches, cuda_search.launches,
        cuda_fill.commit_launches)))
    assert filt == search == commit >= 1 and ring == search + 1  # one onion peel
    assert wexler.plain_pieces == 0 and wexler.host_syncs == 3
    assert torch.equal(out, vt.inpainting_wexler(src, hole, multi_start=1, impl="torch"))


# ---------------------------------------------------------------------------
# SLIC, Lab, CIEDE2000 and the class API on the card (the k-means kernels
# held to the plain version on the card and to the CPU path)
# ---------------------------------------------------------------------------

def smooth_u8(shape, seed):
    coarse = torch.from_numpy(random_image(6, 6 + seed)).permute(2, 0, 1)[None].float()
    smooth = torch.nn.functional.interpolate(coarse, size=shape, mode="bicubic",
                                             align_corners=False)
    return smooth.round().clamp(0, 255)[0].permute(1, 2, 0).to(torch.uint8).contiguous()


@pytest.mark.parametrize("shape,s,iters", [((64, 96), 32, 5), ((130, 130), 26, 10),
                                           ((97, 203), 16, 10)])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_slic_on_the_card_bit_equal_to_cpu(cuda, shape, s, iters, kind):
    from various_image_processings_tpu_torch.models import slic

    img = (torch.from_numpy(random_image(*shape)) if kind == "random"
           else smooth_u8(shape, iters))
    cpu_model = vt.SuperpixelSLIC(*shape, s, iters, device="cpu")
    card_model = vt.SuperpixelSLIC(*shape, s, iters)
    want = cpu_model.apply(img)
    got = card_model.apply(img.to(cuda))
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)
    assert card_model.last_max_drift_cells == cpu_model.last_max_drift_cells
    lab = vt.core.bgr2lab_u8_exact(img)
    raw_cpu = slic.slic_device(lab, *shape, s, iters, 20.0)
    raw_card = slic.slic_device(lab.to(cuda), *shape, s, iters, 20.0)
    for a, b in zip(raw_card, raw_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("name", ["ciede2000_square", "ciede2000_ref_square"])
def test_delta_e_on_the_card_within_tolerance(cuda, name):
    """The transcendentals differ by ulps between the CPU and the card: the
    JAX package's tolerance (rtol 5e-4, atol 5e-2) holds."""
    from various_image_processings_tpu_torch.core import ciede2000

    v = torch.from_numpy(np.random.default_rng(7).integers(-255, 256, (6, 1 << 16)).astype(
        np.float32))
    fn = getattr(ciede2000, name)
    want = fn(*v)
    got = fn(*v.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=5e-4, atol=5e-2)


@pytest.mark.parametrize("metric", ["ciede2000", "ciede2000_ref"])
def test_slic_delta_e_on_the_card(cuda, metric):
    img = torch.zeros((40, 40, 3), dtype=torch.uint8)
    img[:20] = torch.tensor([255, 0, 0], dtype=torch.uint8)
    img[20:] = torch.tensor([0, 0, 255], dtype=torch.uint8)
    labels = vt.superpixel_slic(img.to(cuda), 20, 3, metric=metric).cpu()
    assert not set(labels[:20].flatten().tolist()) & set(labels[20:].flatten().tolist())


SLIC_SHAPES = [(512, 512), (2160, 3840), (97, 131), (3, 5)]
SLIC_SIZES = [2, 7, 26, 64, 5000]  # 5000: larger than every image
SLIC_KINDS = ["random", "smooth", "constant", "two"]
SLIC_RUNS = [(10, 20.0), (1, 1.0), (10, 40.0), (10, 1.0)]  # (iterations, m)


def slic_lab(kind, shape, device, seed=0):
    """The Lab image of a BGR image of ``kind`` ("two": two colors in
    vertical stripes, whose equidistant pixels tie)."""
    h, w = shape
    if kind == "random":
        bgr = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                                    dtype=np.uint8))
    elif kind == "smooth":
        bgr = smooth_u8(shape, seed + 3)
    elif kind == "constant":
        bgr = torch.full((h, w, 3), 97, dtype=torch.uint8)
    else:
        bgr = torch.empty((h, w, 3), dtype=torch.uint8)
        bgr[:] = torch.tensor([20, 200, 60], dtype=torch.uint8)
        bgr[:, (torch.arange(w) // 4) % 2 == 1] = torch.tensor([220, 30, 140],
                                                                 dtype=torch.uint8)
    return vt.core.bgr2lab_u8_exact(bgr.to(device))


@pytest.mark.parametrize("kind", SLIC_KINDS)
@pytest.mark.parametrize("s", SLIC_SIZES)
@pytest.mark.parametrize("shape", SLIC_SHAPES)
def test_slic_kernels_bit_equal_to_plain_on_the_card(cuda, shape, s, kind):
    """The kernel route against ``impl="torch"`` on the card: labels,
    distances, centers, drift and the iterations run.  Each (shape, S) takes
    every image kind, each with another (iterations, m)."""
    from various_image_processings_tpu_torch.models import slic

    iters, m = SLIC_RUNS[(SLIC_SIZES.index(s) + SLIC_KINDS.index(kind)) % len(SLIC_RUNS)]
    lab = slic_lab(kind, shape, cuda)
    got = slic.slic_device(lab, *shape, s, iters, m, impl="cuda")
    ran = int(slic.device_iterations)
    slic.iterations = 0
    want = slic.slic_device(lab, *shape, s, iters, m, impl="torch")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ran == slic.iterations


def test_slic_kernel_route_reads_nothing_back(cuda):
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    lab = slic_lab("smooth", (130, 130), cuda)
    slic.host_syncs = slic.iterations = 0
    before = kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches
    slic.slic_device(lab, 130, 130, 26, 10, 20.0)
    torch.cuda.synchronize()
    assert slic.host_syncs == 0 and slic.iterations == 0
    after = kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches
    assert [b - a for a, b in zip(before, after)] == [10, 10, 10]
    model = vt.SuperpixelSLIC(130, 130, 26, 10)
    slic.host_syncs = slic.iterations = 0
    model.apply(smooth_u8((130, 130), 3).to(cuda))
    assert slic.host_syncs == 1 and 1 <= slic.iterations <= 10  # the download


DELTA_E_METRICS = ["ciede2000", "ciede2000_ref"]


@pytest.mark.parametrize("kind", SLIC_KINDS)
@pytest.mark.parametrize("s", SLIC_SIZES)
@pytest.mark.parametrize("shape", SLIC_SHAPES[2:])
@pytest.mark.parametrize("metric", DELTA_E_METRICS)
def test_slic_delta_e_kernels_bit_equal_to_plain_on_the_card(cuda, metric, shape, s, kind):
    """The ΔE kernel route against ``impl="torch"`` on the card, over the
    small shapes of the grid (chip_smoke.py phase 23b takes all of it)."""
    from various_image_processings_tpu_torch.models import slic

    iters, m = SLIC_RUNS[(SLIC_SIZES.index(s) + SLIC_KINDS.index(kind)) % len(SLIC_RUNS)]
    lab = slic_lab(kind, shape, cuda)
    got = slic.slic_device(lab, *shape, s, iters, m, metric, impl="cuda")
    ran = int(slic.device_iterations)
    slic.iterations = 0
    want = slic.slic_device(lab, *shape, s, iters, m, metric, impl="torch")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ran == slic.iterations


@pytest.mark.parametrize("metric", DELTA_E_METRICS)
def test_slic_delta_e_reads_nothing_back(cuda, metric):
    """A ΔE k-means on a CUDA tensor: 3 kernel launches an iteration, those
    of its metric, and no host read; ``apply`` reads once."""
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    lab = slic_lab("smooth", (130, 130), cuda)
    slic.host_syncs = slic.iterations = 0
    kslic.metric_launches.clear()
    before = kslic.update_launches
    slic.slic_device(lab, 130, 130, 26, 10, 20.0, metric)
    torch.cuda.synchronize()
    assert slic.host_syncs == 0 and slic.iterations == 0
    assert dict(kslic.metric_launches) == {("association", metric): 10,
                                           ("snap_keys", metric): 10}
    assert kslic.update_launches - before == 10
    model = vt.SuperpixelSLIC(130, 130, 26, 10, metric=metric)
    slic.host_syncs = slic.iterations = 0
    model.apply(smooth_u8((130, 130), 3).to(cuda))
    assert slic.host_syncs == 1 and 1 <= slic.iterations <= 10


def delta_e_pairs():
    """(6, n) f32 Lab pairs: seeded integers in -255..255 and seeded floats;
    every pair of a lattice of colours (a, b in -130..130 step 10, so a = b
    = 0, a = 0 with b != 0, equal colours and hue differences on both sides
    of ±half, wrapped either way); as chip_smoke.py phase 23a draws them."""
    rng = np.random.default_rng(7)
    ints = rng.integers(-255, 256, (6, 1 << 16)).astype(np.float32)
    floats = rng.uniform(-200.0, 200.0, (6, 1 << 16)).astype(np.float32)
    ab = np.arange(-130, 131, 10, dtype=np.float32)
    aa, bb = np.meshgrid(ab, ab)
    lattice = np.stack([rng.integers(0, 256, aa.size).astype(np.float32), aa.ravel(),
                        bb.ravel()])
    i, j = np.meshgrid(np.arange(aa.size), np.arange(aa.size))
    pairs = np.concatenate([lattice[:, i.ravel()], lattice[:, j.ravel()]])
    return torch.from_numpy(np.concatenate([ints, floats, pairs], 1))


@pytest.mark.parametrize("metric", DELTA_E_METRICS)
def test_delta_e_pair_kernel_bit_equal_on_the_card(cuda, metric):
    from various_image_processings_tpu_torch.core import ciede2000
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    v = delta_e_pairs().to(cuda)
    want = getattr(ciede2000, f"{metric}_square")(*v)
    before = kslic.delta_e_launches
    got = kslic.delta_e(*v.contiguous(), metric)
    assert kslic.delta_e_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("metric", DELTA_E_METRICS)
def test_slic_batched_delta_e_equals_single_calls(cuda, metric):
    """Each of the mesh's 2 batch rows runs its 2 images as one sub-batch:
    5 association launches a sub-batch, not 5 an image."""
    from various_image_processings_tpu_torch import parallel
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    imgs = torch.stack([smooth_u8((64, 96), i) for i in range(4)]).to(cuda)
    mesh = parallel.make_mesh(batch=2, spatial=1, devices=[cuda] * 2)
    kslic.metric_launches.clear()
    out = parallel.superpixel_slic_batched(imgs, 16, 5, 20.0, metric, mesh=mesh)
    assert out.is_cuda and kslic.metric_launches["association", metric] == 2 * 5
    for i in range(4):
        assert torch.equal(out[i], vt.superpixel_slic(imgs[i], 16, 5, 20.0, metric))


SLIC_BATCH_KINDS = ["constant", "random", "smooth", "two"]


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("metric", ["euclidean", *DELTA_E_METRICS])
@pytest.mark.parametrize("shape", [(26, 39), (97, 131)])
def test_slic_batched_kernels_bit_equal_to_single_runs(cuda, shape, metric, batch):
    """One batched kernel route (3 launches an iteration for the whole
    batch) against each image's single kernel route and its plain route:
    labels, centers, distances, drift and iterations run all equal.  The
    batches of 8 stop at different iterations (6 to 10 at 26x39, 9 and 10
    at 97x131, on the CPU's plain route)."""
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    (h, w), s, iters, m = shape, 13, 10, 20.0
    lab = torch.stack([slic_lab(SLIC_BATCH_KINDS[i % 4], (h, w), cuda, seed=i)
                       for i in range(batch)])
    torch.cuda.synchronize()
    before = kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches
    got = slic.slic_device_batched(lab, h, w, s, iters, m, metric)
    ran = slic.device_iterations.cpu().tolist()
    after = kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches
    assert [b - a for a, b in zip(before, after)] == [iters] * 3
    for i in range(batch):
        single = slic.slic_device(lab[i], h, w, s, iters, m, metric)
        assert int(slic.device_iterations) == ran[i]
        slic.iterations = 0
        plain = slic.slic_device(lab[i], h, w, s, iters, m, metric, impl="torch")
        assert slic.iterations == ran[i]
        for a, b, c in zip(got, single, plain):
            assert torch.equal(a[i], b) and torch.equal(a[i], c)
    assert batch < 8 or min(ran) < max(ran), ran


@pytest.mark.parametrize("batch", [4, 8])
@pytest.mark.parametrize("metric", ["euclidean", *DELTA_E_METRICS])
@pytest.mark.parametrize("shape", [(26, 39), (97, 131)])
def test_slic_batched_mixed_convergence_bit_equal(cuda, shape, metric, batch):
    """Batches of 4 and 8 whose images stop at different iterations (on the
    CPU's plain route, 26x39: 6 to 10; 97x131: 9 and 10): one batched kernel
    route bit-equal to each image's single kernel route and plain route."""
    from various_image_processings_tpu_torch.models import slic

    (h, w), s, iters, m = shape, 13, 10, 20.0
    lab = torch.stack([slic_lab(SLIC_BATCH_KINDS[i % 4], (h, w), cuda, seed=i)
                       for i in range(batch)])
    got = slic.slic_device_batched(lab, h, w, s, iters, m, metric)
    ran = slic.device_iterations.cpu().tolist()
    assert min(ran) < max(ran), ran
    for i in range(batch):
        single = slic.slic_device(lab[i], h, w, s, iters, m, metric)
        assert int(slic.device_iterations) == ran[i]
        plain = slic.slic_device(lab[i], h, w, s, iters, m, metric, impl="torch")
        for a, b, c in zip(got, single, plain):
            assert torch.equal(a[i], b) and torch.equal(a[i], c)


# S where the association's 32 x 8 tiles and the cells meet differently: a
# tile of 16 x 4 cells (S = 2), cells that straddle tiles, cells as wide as
# a tile, wider, and past 64 (the snap keys' tile changes there)
ASSOCIATION_SIZES = [2, 3, 4, 8, 9, 16, 31, 32, 33, 40, 64, 65]


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("s", ASSOCIATION_SIZES)
@pytest.mark.parametrize("metric", ["euclidean", *DELTA_E_METRICS])
def test_slic_association_geometry_bit_equal(cuda, metric, s, kind):
    """The kernel route against ``impl="torch"`` on the card at a shape that
    is no whole number of tiles or cells; the association's launch is one
    block a 32 x 8 tile."""
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    shape, iters, m = (97, 131), 5, 20.0
    assert kslic.association_shape(*shape, metric)[0] == 13 * 5
    lab = slic_lab(kind, shape, cuda)
    got = slic.slic_device(lab, *shape, s, iters, m, metric, impl="cuda")
    ran = int(slic.device_iterations)
    slic.iterations = 0
    want = slic.slic_device(lab, *shape, s, iters, m, metric, impl="torch")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ran == slic.iterations


def test_slic_batched_one_program_a_sub_batch(cuda):
    """superpixel_slic_batched on a 1x1 mesh: one sub-batch, ``iters``
    launches of each k-means kernel, one host read before connectivity."""
    from various_image_processings_tpu_torch import parallel
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    imgs = torch.stack([smooth_u8((130, 130), i) for i in range(4)]).to(cuda)
    mesh = parallel.make_mesh(batch=1, spatial=1, devices=[cuda])
    torch.cuda.synchronize()
    before = kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches
    slic.host_syncs = slic.iterations = 0
    out = parallel.superpixel_slic_batched(imgs, 26, 10, 20.0, mesh=mesh)
    syncs, its = slic.host_syncs, slic.iterations
    after = kslic.association_launches, kslic.snap_keys_launches, kslic.update_launches
    assert [b - a for a, b in zip(before, after)] == [10, 10, 10]
    assert syncs == 1 and 4 <= its <= 40
    slic.iterations = 0
    for i in range(4):
        assert torch.equal(out[i], vt.superpixel_slic(imgs[i], 26, 10, 20.0))
    assert slic.iterations == its


@pytest.mark.parametrize("displaced", [0, 1])
def test_slic_each_kernel_against_its_plain_piece(cuda, displaced):
    """One kernel at a time against the plain version's piece on the same
    state, three iterations, center 0 moved off the image before iteration
    ``displaced`` (it then has no pixel, or only stale labels)."""
    each_kernel_against_its_plain_piece(cuda, displaced, "euclidean")


@pytest.mark.parametrize("displaced", [0, 1])
@pytest.mark.parametrize("metric", DELTA_E_METRICS)
def test_slic_delta_e_each_kernel_against_its_plain_piece(cuda, metric, displaced):
    each_kernel_against_its_plain_piece(cuda, displaced, metric)


def each_kernel_against_its_plain_piece(cuda, displaced, metric):
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    h, w, s, m = 97, 131, 13, 20.0
    lab = slic_lab("random", (h, w), cuda)
    grid = slic._Grid(lab, h, w, s, m, metric)
    centers_t = grid.init_centers()
    labels_t = torch.full(grid.pix.shape[1:], -1, dtype=torch.int32, device=cuda)
    dists_t = torch.full(grid.pix.shape[1:], slic._BIG, dtype=torch.float32, device=cuda)
    # the kernels take a batch: one image, the state's views of it below
    batch = slic.kmeans_state(lab[None], h, w, s, 3)
    assert torch.equal(batch[0][0], centers_t.reshape(5, -1).T)
    centers, labels, dists, sums, keys, state = (t[0] for t in batch)
    drift = torch.zeros((), device=cuda)
    for it in range(3):
        state[1 + it, 0] = 1  # each kernel runs, whatever the last iteration changed
        if it == displaced:
            centers[0, :2] = -3.0 * s
            centers_t[:2, 0, 0] = -3.0 * s
        # the kernel widens its neighbourhood with the drift so far (the
        # displaced center's three cells included)
        labels_t, dists_t, changed_t, sums_t = grid.association(
            centers_t, labels_t, dists_t, max(2, 1 + int(drift)))
        kslic.associate(lab[None], *batch[:4], batch[5], it, s, grid.space_norm,
                        grid.color_norm, metric)
        assert torch.equal(labels, grid.from_blocks(labels_t))
        assert torch.equal(dists, grid.from_blocks(dists_t))
        assert torch.equal(sums, sums_t.reshape(6, -1).T)
        assert int(state[1 + it, 1]) == int(changed_t)
        means_t = grid.center_means(centers_t, sums_t)
        keys_t = grid.snap_keys(means_t, labels_t)
        kslic.snap_keys(lab[None], batch[0], batch[1], batch[3], batch[4], batch[5], it, s,
                        metric)
        assert torch.equal(keys, keys_t)
        centers_t = grid.move_centers(centers_t, keys_t)
        drift = torch.maximum(drift, grid.cell_drift(centers_t))
        kslic.update(lab[None], batch[0], batch[4], batch[3], batch[5], it, s)
        assert torch.equal(centers, centers_t.reshape(5, -1).T)
        assert int(state[0, 0]) == int(drift) and int(state[0, 1]) == it + 1
        assert int(state[2 + it, 0]) == int(changed_t)
        assert not sums.any() and bool((keys == slic._BIG_KEY).all())


def test_lab_on_the_card_equals_cpu_on_every_color(cuda):
    c = torch.arange(1 << 24, dtype=torch.int64)
    img = torch.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], -1).to(torch.uint8)
    img = img.reshape(4096, 4096, 3)
    got = vt.core.bgr2lab_u8_exact(img.to(cuda)).cpu()
    for rows in torch.arange(4096).chunk(4):
        band = img[rows[0]:rows[-1] + 1]
        assert torch.equal(got[rows[0]:rows[-1] + 1], vt.core.bgr2lab_u8_exact(band))


def test_device_image_and_warmup_on_the_card(cuda):
    src = random_image(40, 40)
    img = vt.DeviceImage.from_array(src)
    assert img.get().is_cuda
    np.testing.assert_array_equal(img.download(), src)
    f = vt.BilateralFilter(40, 40, 9, 10.0, 30.0)
    assert f.warmup() is f
    assert torch.equal(f(img.get()), vt.bilateral_filter(img.get(), 9, 10.0, 30.0))


@pytest.mark.parametrize("spatial", [2, 4])
def test_parallel_sharded_filters_on_logical_shards(cuda, spatial):
    # logical shards of one card: each shard launches the kernel on its rows
    from various_image_processings_tpu_torch import parallel
    img = torch.from_numpy(random_image(64, 48)).to(cuda)
    mesh = parallel.make_mesh(batch=1, spatial=spatial, devices=[cuda] * spatial)
    before = cuda_bf.launches
    out = parallel.bilateral_filter_sharded(img, 9, mesh=mesh)
    torch.cuda.synchronize()
    assert cuda_bf.launches - before == spatial
    assert out.is_cuda and torch.equal(out, vt.bilateral_filter(img, 9))
    out = parallel.bilateral_texture_filter_sharded(img, 5, 2, mesh=mesh)
    assert torch.equal(out, vt.bilateral_texture_filter(img, 5, 2))
    assert torch.equal(parallel.gradient_sharded(img, mesh=mesh), vt.gradient(img))
    assert torch.equal(parallel.adaptive_bilateral_filter_sharded(img, 9, mesh=mesh),
                       vt.adaptive_bilateral_filter(img, 9))


def test_parallel_batched_btf_on_the_card(cuda):
    from various_image_processings_tpu_torch import parallel
    imgs = torch.stack([torch.from_numpy(random_image(40, 32)).roll(i, 0)
                        for i in range(4)]).to(cuda)
    mesh = parallel.make_mesh(batch=2, spatial=1, devices=[cuda] * 2)
    out = parallel.bilateral_texture_filter_batched(imgs, 5, 2, mesh=mesh)
    assert out.is_cuda and out.shape == imgs.shape
    for i in range(4):
        assert torch.equal(out[i], vt.bilateral_texture_filter(imgs[i], 5, 2))
    both = parallel.bilateral_filter_batch_spatial(
        imgs, 9, mesh=parallel.make_mesh(batch=2, spatial=2, devices=[cuda] * 4))
    for i in range(4):
        assert torch.equal(both[i], vt.bilateral_filter(imgs[i], 9))
