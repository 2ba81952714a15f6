"""A NumPy twin of the unrolled path of the bilateral kernel (path 4,
csrc/bilateral_circle.cuh: radius 1 to 4, the inscribed circle unrolled at
compile time, a thread holding H x V adjacent outputs, or 1 x V on small
frames), held to the plain version on the CPU.

The twin repeats the kernel's visit order: the H + 2R source rows a
thread's windows cover, top to bottom; each row's words, left to right,
those that serve any output; and for each word the outputs whose circle
holds it.  Every output must see the circle's taps once each, in (ky, kx)
order, and its f32 sums, with weight 0 where the table has no tap, must be
bit-equal to ``_taps_math``.  H and V are read from the kernel's source.
Besides: the tile layout's banks, every tap-table producer's taps inside
the circle, the filter modules' check of host-built space kernels, and the
wrapper's path and counters on a fake library behind
``_build.load_library``.  The kernel itself runs only on the card
(tests/test_torch_cuda.py); this file imports no JAX.
"""

import contextlib
import itertools
import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.luts import (  # noqa: E402
    color_table, space_kernel, tap_table)
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops import bilateral_texture as obt  # noqa: E402
from various_image_processings_tpu_torch.ops.bilateral import _pad2d, _taps_math  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import _build  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral as kbf  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as kbt  # noqa: E402

SOURCE = (_build.CSRC_DIR / "bilateral_circle.cuh").read_text()


def constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


V = constant("kCircleCols")   # adjacent output columns a thread
ROWS = (1, constant("kCircleRows"))   # adjacent output rows a thread: small frames, the rest
MAX_RADIUS = constant("kCircleMaxRadius")
RADII = range(1, MAX_RADIUS + 1)


def in_circle(r: int, ky: int, kx: int) -> bool:
    return 0 <= ky <= 2 * r and 0 <= kx <= 2 * r and (ky - r) ** 2 + (kx - r) ** 2 <= r * r


def serves(r: int, rows: int, s: int, j: int) -> bool:
    """Word j of source row s serves some output (h, u) as its tap (s - h, j - u)."""
    return any(in_circle(r, s - h, j - u) for h in range(rows) for u in range(V))


def walk(r: int, rows: int) -> tuple[dict, int]:
    """({(h, u): the taps (ky, kx) output (h, u) adds, in the order the walk
    adds them}, the words a thread loads), for a thread of ``rows`` rows."""
    seen = {(h, u): [] for h in range(rows) for u in range(V)}
    words = 0
    for s in range(2 * r + rows):
        for j in range(2 * r + V):
            if not serves(r, rows, s, j):
                continue
            words += 1
            for h, u in itertools.product(range(rows), range(V)):
                if in_circle(r, s - h, j - u):
                    seen[h, u].append((s - h, j - u))
    return seen, words


def circle_taps(r: int) -> list[tuple[int, int]]:
    return [(ky, kx) for ky in range(2 * r + 1) for kx in range(2 * r + 1) if in_circle(r, ky, kx)]


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("r", RADII)
def test_each_output_sees_the_circle_once_in_table_order(r, rows):
    seen, words = walk(r, rows)
    want = circle_taps(r)
    assert want == [tuple(t) for t in tap_table(space_kernel(2 * r + 1, 10.0))[:, :2].tolist()]
    for taps in seen.values():
        assert taps == want
    # a word is loaded once for all the outputs it serves
    assert words < len(want) * rows * V


def circle_col(c: int) -> int:
    """csrc/bilateral_circle.cuh::circle_col: a pad word after every V columns."""
    return c + c // V


@pytest.mark.parametrize("word_bytes", [4, 8])
@pytest.mark.parametrize("r", RADII)
def test_a_warps_tile_reads_fall_on_distinct_banks(r, word_bytes):
    """Lane l's word j lies at (V + 1) l + circle_col(j) of its tile row:
    32 lanes on 32 banks (4-byte words), or each half warp on 16 bank pairs
    (8-byte words, the joint filter)."""
    lanes = 32 if word_bytes == 4 else 16
    for j in range(2 * r + V):
        for half in range(32 // lanes):
            slots = [((V + 1) * l + circle_col(j)) % lanes
                     for l in range(half * lanes, (half + 1) * lanes)]
            assert len(set(slots)) == lanes
    assert circle_col(V * 5 + 2) == (V + 1) * 5 + circle_col(2)


def padded(src: np.ndarray, guide: np.ndarray, r: int, border: str):
    return (_pad2d(torch.from_numpy(src.astype(np.float32)), r, border).numpy(),
            _pad2d(torch.from_numpy(guide.astype(np.int64)), r, border).numpy())


def add_tap(sums, sumk, src_p, guide_p, guide, y, x, ky, kx, ws, lut) -> None:
    """Tap (ky, kx) of weight ws added to the pixels (y, x), in f32, every
    product and sum rounded on its own."""
    d = np.abs(guide_p[y + ky, x + kx] - guide[y, x].astype(np.int64)).sum(axis=-1)
    wk = np.float32(ws) * lut[d]
    sums[y, x] = sums[y, x] + src_p[y + ky, x + kx] * wk[..., None]
    sumk[y, x] = sumk[y, x] + wk


def unrolled_sums(src: np.ndarray, guide: np.ndarray, table: np.ndarray, lut: np.ndarray,
                  r: int, border: str, rows: int) -> tuple[np.ndarray, np.ndarray]:
    """(sums, sumk) as the kernel forms them: in the walk's order, over the
    dense weights (0 where the table has no tap); a pixel at row y and
    column x is output (y mod rows, x mod V) of its thread."""
    h, w, _ = src.shape
    src_p, guide_p = padded(src, guide, r, border)
    dense = np.zeros((2 * r + 1, 2 * r + 1), np.float32)
    for dy, dx, bits in table[:, :3].tolist():
        dense[dy, dx] = np.int32(bits).view(np.float32)
    sums = np.zeros((h, w, 3), np.float32)
    sumk = np.zeros((h, w), np.float32)
    seen, _ = walk(r, rows)
    for (oh, ou), taps in seen.items():
        y, x = np.ix_(np.arange(oh, h, rows), np.arange(ou, w, V))
        for ky, kx in taps:
            add_tap(sums, sumk, src_p, guide_p, guide, y, x, ky, kx, dense[ky, kx], lut)
    return sums, sumk


def table_sums(src: np.ndarray, guide: np.ndarray, table: np.ndarray, lut: np.ndarray,
               r: int, border: str) -> tuple[np.ndarray, np.ndarray]:
    """(sums, sumk) as the plain version forms them: the table's taps, in
    its order, every pixel at once."""
    h, w, _ = src.shape
    src_p, guide_p = padded(src, guide, r, border)
    sums = np.zeros((h, w, 3), np.float32)
    sumk = np.zeros((h, w), np.float32)
    y, x = np.ix_(np.arange(h), np.arange(w))
    for dy, dx, bits in table[:, :3].tolist():
        add_tap(sums, sumk, src_p, guide_p, guide, y, x, dy, dx,
                np.int32(bits).view(np.float32), lut)
    return sums, sumk


def to_u8(sums: np.ndarray, sumk: np.ndarray, rounding: str) -> np.ndarray:
    out = sums / sumk[:, :, None]
    if rounding == "rint":
        return np.rint(out).astype(np.uint8)
    return np.floor(out + np.float32(0.5)).astype(np.uint8)


def subset_table(r: int, seed: int) -> np.ndarray:
    """About half the circle's taps, the centre always: the kernel adds the
    others with weight 0."""
    table = tap_table(space_kernel(2 * r + 1, 10.0))
    keep = np.random.default_rng(seed).random(len(table)) < 0.5
    keep[len(table) // 2] = True
    return table[keep]


SHAPES = [(1, 1), (3, 5), (17, 33), (37, 45)]


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"), ("reflect101", "rint")])
@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("table_kind", ["circle", "subset"])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("r", RADII)
def test_unrolled_sums_bit_equal_to_plain(r, rows, table_kind, joint, border, rounding):
    if table_kind == "circle":
        table, lut = tap_table(space_kernel(2 * r + 1, 10.0 if r < 3 else 2.0)), color_table(30.0)
    else:
        table, lut = subset_table(r, r), color_table(5.0)
    for shape in SHAPES:
        src = random_image(*shape)
        guide = src[::-1, ::-1].copy() if joint else src
        sums, sumk = unrolled_sums(src, guide, table, lut, r, border, rows)
        want_sums, want_sumk = table_sums(src, guide, table, lut, r, border)
        np.testing.assert_array_equal(sums.view(np.uint32), want_sums.view(np.uint32))
        np.testing.assert_array_equal(sumk.view(np.uint32), want_sumk.view(np.uint32))
        want = _taps_math(torch.from_numpy(src), torch.from_numpy(guide), table,
                          torch.from_numpy(lut), r, border, rounding)
        np.testing.assert_array_equal(to_u8(sums, sumk, rounding), want.numpy())


# -- the tables every producer gives the kernel --

def inside_circle(taps: torch.Tensor, r: int) -> bool:
    table = taps.cpu().numpy()
    return all(in_circle(r, dy, dx) for dy, dx in table[:, :2].tolist())


@pytest.mark.parametrize("sigma_space", [0.1, 1.0, 3.0, 10.0, 1000.0])
@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_bf_tables_lie_inside_the_circle(ksize, sigma_space):
    taps, _ = kbf.device_tables(ksize, sigma_space, 30.0, torch.device("cpu"))
    assert inside_circle(taps, ksize // 2)
    module = vt.BilateralFilter(8, 8, ksize, sigma_space, 30.0, device="cpu")
    assert torch.equal(module.taps, taps)


@pytest.mark.parametrize("ksize", [2, 3, 4, 5])
def test_btf_joint_filter_tables_lie_inside_the_circle(ksize):
    """The BTF's joint filter of window 2k − 1 has radius k − 1 <= 4."""
    taps, _ = obt.jbf_tables(ksize, torch.device("cpu"))
    assert inside_circle(taps, ksize - 1)
    if ksize % 2:
        assert torch.equal(vt.BilateralTextureFilter(8, 8, ksize, 1, device="cpu").taps, taps)


@pytest.mark.parametrize("ksize", [5, 9])
def test_modules_reject_a_space_kernel_outside_the_circle(ksize):
    assert kbf.UNROLLED_MAX_RADIUS == MAX_RADIUS
    square = np.ones((ksize, ksize), np.float32)
    with pytest.raises(ValueError, match="inscribed circle"):
        vt.BilateralFilter.from_numpy_tables(square, color_table(30.0), 8, 8, device="cpu")
    with pytest.raises(ValueError, match="inscribed circle"):
        vt.BilateralTextureFilter.from_numpy_tables(square, color_table(3.0), 8, 8,
                                                    device="cpu")
    inside = space_kernel(ksize, 10.0)
    module = vt.BilateralFilter.from_numpy_tables(inside, color_table(30.0), 8, 8, device="cpu")
    assert torch.equal(module.taps, vt.BilateralFilter(8, 8, ksize, device="cpu").taps)


def test_a_square_space_kernel_past_the_unrolled_radii_is_taken():
    square = np.ones((11, 11), np.float32)
    module = vt.BilateralFilter.from_numpy_tables(square, color_table(30.0), 8, 8, device="cpu")
    assert module.taps.shape == (121, 4)


# -- the wrapper's path and counters, on a fake library --

class FakeLibrary:
    """The planners answer as csrc/bilateral.cu::path_of does (4 at radius 1
    to 4; 1 from radius 5 to 31 on frames over 16 rows; else 2);
    ``vip_bilateral_u8`` records its arguments and returns 0."""

    def __init__(self):
        self.launched = []

    @staticmethod
    def vip_bilateral_path(radius, joint, height):
        if 1 <= radius <= 4:
            return kbf.UNROLLED
        return kbf.BLOCKED if 5 <= radius <= 31 and height > 16 else kbf.FOUR_PIXELS

    @staticmethod
    def vip_bilateral_smem_bytes(radius, joint, height):
        return 1024 * radius

    @staticmethod
    def vip_blur_rtv_smem_bytes(radius):
        return 1024

    vip_guide_smem_bytes = vip_blur_rtv_smem_bytes

    def vip_bilateral_u8(self, *args):
        self.launched.append(args)
        return 0


@pytest.fixture
def fake(monkeypatch):
    """A fake library behind load_library; CPU tensors pass the wrapper's
    checks, the stream and the device guard are stand-ins; the plans are
    asked anew and forgotten after."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0x5000))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    for check in ("check_color_image", "check_taps", "check_table"):
        monkeypatch.setattr(kbf, check, lambda *args: None)
    caches = (_build.plan, kbf._launch_plan, kbt._texture_plan)
    for cache in caches:
        cache.cache_clear()
    try:
        yield lib
    finally:
        for cache in caches:
            cache.cache_clear()


def rises(fn) -> tuple[int, int, int]:
    """(launches, unrolled_calls, blocked_calls) that ``fn()`` adds."""
    before = (kbf.launches, kbf.unrolled_calls, kbf.blocked_calls)
    fn()
    return tuple(b - a for a, b in zip(before, (kbf.launches, kbf.unrolled_calls,
                                                kbf.blocked_calls)))


# (ksize, height, (launches, unrolled_calls, blocked_calls) a launch)
@pytest.mark.parametrize("ksize,height,rise", [(3, 45, (1, 1, 0)), (5, 2, (1, 1, 0)),
                                               (7, 600, (1, 1, 0)), (9, 45, (1, 1, 0)),
                                               (9, 16, (1, 1, 0)), (11, 45, (1, 0, 1)),
                                               (11, 16, (1, 0, 0)), (1, 45, (1, 0, 0))])
@pytest.mark.parametrize("joint", [False, True])
def test_the_unrolled_path_is_counted_once_a_launch(fake, joint, ksize, height, rise):
    src = torch.zeros((height, 7, 3), dtype=torch.uint8)
    guide = src.clone() if joint else None
    for n in range(1, 4):
        assert rises(lambda: kbf.bilateral(src, guide, ksize, 10.0, 30.0)) == rise
        assert len(fake.launched) == n
    args = fake.launched[-1]
    assert args[3:5] == (height, 7) and args[8] == ksize // 2 and args[-1] == 0x5000
    assert kbf._launch_plan(ksize // 2, joint, height)[1] == fake.vip_bilateral_path(
        ksize // 2, joint, height)


@pytest.mark.parametrize("ksize,path", [(2, kbf.UNROLLED), (3, kbf.UNROLLED), (5, kbf.UNROLLED),
                                        (7, kbf.BLOCKED), (9, kbf.BLOCKED)])
def test_the_btf_plan_names_its_joint_filters_path(fake, ksize, path):
    """A BTF of window k: its joint filter of radius k − 1 takes the unrolled
    path up to k = 5 (k′ = 9); the benchmark's k = 9 (k′ = 17) path 1."""
    assert kbt._texture_plan(ksize, 45)[0] == path
