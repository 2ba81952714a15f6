"""A NumPy twin of the blocked path of csrc/bilateral.cu (path 1: a thread
computes 4 adjacent output pixels of one row), held to the plain version on
the CPU.  The twin repeats what the kernel decides: each tap row's runs of
consecutive taps, found from a 64-bit mask with the kernel's bit arithmetic;
the words of a run and the outputs each serves (two ramps of 3 words around
the words that serve all 4 outputs, or straight code for a run shorter than
4); and the f32 sums in that order.  Every output must see its taps in the
table's (ky, kx) order, once each, and the sums must be bit-equal to
``_taps_math``.  The kernel itself runs only on the card
(tests/test_torch_cuda.py); this file imports no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from various_image_processings_tpu_torch.core.luts import (  # noqa: E402
    color_table, space_kernel, tap_table)
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops.bilateral import _pad2d, _taps_math  # noqa: E402

COLS = 4  # output columns a thread


def ffs(m: int) -> int:
    """__ffsll: one plus the index of the lowest set bit, 0 for 0."""
    return (m & -m).bit_length()


def row_runs(table: np.ndarray, radius: int) -> list[list[tuple[int, int]]]:
    """Each tap row's runs (first tap, length), as the kernel finds them from
    the row's mask."""
    ksize = 2 * radius + 1
    masks = [0] * ksize
    for dy, dx in table[:, :2].tolist():
        masks[dy] |= 1 << dx
    runs = []
    for m in masks:
        row = []
        while m:
            a = ffs(m) - 1
            n = ffs(~(m >> a) & (2**64 - 1)) - 1
            row.append((a, n))
            m &= ~((1 << (a + n)) - 1)
        runs.append(row)
    return runs


def word_set(n: int, j: int) -> list[int]:
    """The outputs word j of a run of n <= 4 taps serves: 0 <= j - u < n,
    with the kernel's bit formula."""
    hi = min(j, COLS - 1)
    lo = j - n + 1 if j >= n else 0
    bits = ((2 << hi) - 1) & ~((1 << lo) - 1)
    return [u for u in range(COLS) if bits >> u & 1]


def run_words(a: int, n: int) -> list[tuple[int, list[int]]]:
    """(word column, outputs it serves) of a run of n taps from a, in the
    kernel's order."""
    if n < COLS:
        return [(a + j, word_set(n, j)) for j in range(n + COLS - 1)]
    words = [(a + j, word_set(COLS, j)) for j in range(COLS - 1)]        # ramp in
    words += [(a + c, list(range(COLS))) for c in range(COLS - 1, n)]    # the loop
    base = a + n - COLS  # the last 3 words: words 4..6 of a run of 4 ending at a + n
    words += [(base + j, word_set(COLS, j)) for j in range(COLS, COLS + 3)]
    return words


def walk(table: np.ndarray, radius: int) -> list[list[tuple[int, int]]]:
    """The taps (ky, kx) each of a thread's outputs adds, in the order the
    walk adds them."""
    seen = [[] for _ in range(COLS)]
    for ky, runs in enumerate(row_runs(table, radius)):
        for a, n in runs:
            for c, outputs in run_words(a, n):
                for u in outputs:
                    seen[u].append((ky, c - u))
    return seen


def sparse_table(radius: int, density: float, seed: int) -> np.ndarray:
    """Taps at random positions of the window, in (ky, kx) order: runs of
    every length, gaps, empty rows."""
    d = 2 * radius + 1
    rng = np.random.default_rng(seed)
    keep = rng.random((d, d)) < density
    keep[radius, radius] = True
    dy, dx = np.nonzero(keep)
    ws = (0.0625 + rng.random(len(dy))).astype(np.float32)
    table = np.zeros((len(dy), 4), np.int32)
    table[:, 0], table[:, 1] = dy, dx
    table[:, 2] = ws.view(np.int32)
    return table


CIRCLES = [(5, 10.0), (8, 8.0), (13, 10.0), (31, 10.0)]


@pytest.mark.parametrize("radius,sigma", CIRCLES)
def test_each_output_sees_the_circle_in_table_order(radius, sigma):
    table = tap_table(space_kernel(2 * radius + 1, sigma))
    want = [tuple(t) for t in table[:, :2].tolist()]
    for seen in walk(table, radius):
        assert seen == want


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("radius,density", [(5, 0.3), (6, 0.7), (12, 0.5), (31, 0.15)])
def test_each_output_sees_a_sparse_table_in_table_order(radius, density, seed):
    table = sparse_table(radius, density, seed)
    want = [tuple(t) for t in table[:, :2].tolist()]
    runs = row_runs(table, radius)
    assert sum(n for row in runs for _, n in row) == len(table)
    for seen in walk(table, radius):
        assert seen == want


def blocked_sums(src: np.ndarray, guide: np.ndarray, table: np.ndarray, lut: np.ndarray,
                 radius: int, border: str, rounding: str) -> np.ndarray:
    """The kernel's arithmetic in the walk's order, in f32, every product and
    sum rounded on its own; columns whose index is u mod 4 are output u of
    their thread."""
    h, w, _ = src.shape
    src_p = _pad2d(torch.from_numpy(src.astype(np.float32)), radius, border).numpy()
    guide_p = _pad2d(torch.from_numpy(guide.astype(np.int64)), radius, border).numpy()
    ws_of = {(int(dy), int(dx)): np.float32(np.int32(bits).view(np.float32))
             for dy, dx, bits in table[:, :3].tolist()}
    sums = np.zeros((h, w, 3), np.float32)
    sumk = np.zeros((h, w), np.float32)
    cols = np.arange(w)
    for u, seen in enumerate(walk(table, radius)):
        x = cols[cols % COLS == u]
        for ky, kx in seen:
            sp = src_p[ky:ky + h, x + kx]
            d = np.abs(guide_p[ky:ky + h, x + kx] - guide[:, x].astype(np.int64)).sum(axis=2)
            wk = np.float32(ws_of[ky, kx]) * lut[d]
            sums[:, x] = sums[:, x] + sp * wk[:, :, None]
            sumk[:, x] = sumk[:, x] + wk
    out = sums / sumk[:, :, None]
    if rounding == "rint":
        return np.rint(out).astype(np.uint8)
    return np.floor(out + np.float32(0.5)).astype(np.uint8)


@pytest.mark.parametrize("border,rounding", [("replicate", "trunc"), ("reflect101", "rint")])
@pytest.mark.parametrize("case", ["bf_k11", "btf_jbf_k17", "sparse_r6"])
def test_blocked_sums_bit_equal_to_plain(case, border, rounding):
    src = random_image(37, 45)
    if case == "bf_k11":
        radius, guide, table = 5, src, tap_table(space_kernel(11, 10.0))
        lut = color_table(30.0)
    elif case == "btf_jbf_k17":  # the texture filter's joint stage
        radius, guide, table = 8, src[::-1].copy(), tap_table(space_kernel(17, 8.0))
        lut = color_table(float(np.sqrt(3.0)))
    else:
        radius, guide, table = 6, src[::-1].copy(), sparse_table(6, 0.4, 7)
        lut = color_table(30.0)
    got = blocked_sums(src, guide, table, lut, radius, border, rounding)
    want = _taps_math(torch.from_numpy(src), torch.from_numpy(guide), table,
                      torch.from_numpy(lut), radius, border, rounding)
    np.testing.assert_array_equal(got, want.numpy())
