"""The PyTorch port's Wexler search against the JAX package on the CPU: the
candidate planes (``_build_p117`` / ``_update_p117``), the plain search
``ops/wexler_search.py::_search_min_math`` against JAX's conv path and its
Pallas kernel (interpret mode, as the JAX tests run it), an f64 brute force,
and the CUDA wrapper's key decoding.

With image values in 0..127 every partial sum of the masked SSD is an integer
below 2²⁴, so every f32 summation order gives the same bits: there the port
is held bit-equal, energies and picks.  On full-range images sums round in
each framework's order: energies within rtol 1e-6, atol 4 and equal picks,
the tolerance of tests/test_inpainting.py:213-215."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from various_image_processings_tpu.models import inpainting as JM  # noqa: E402
from various_image_processings_tpu.ops.pallas.wexler_search import (  # noqa: E402
    search_min_pallas)
from various_image_processings_tpu_torch.models import inpainting as M  # noqa: E402
from various_image_processings_tpu_torch.ops import wexler_search as search  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import wexler_search as cuda_search  # noqa: E402


@pytest.mark.parametrize("box", [(10, 15, 8, 12), (0, 0, 6, 6), (32, 40, 8, 12),
                                 (0, 40, 5, 12), (0, 0, 40, 52)])
def test_p117_build_and_update_bit_equal_to_jax(box):
    by0, bx0, bh, bw = box
    rng = np.random.default_rng(11)
    h, w = 40, 52
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    p117 = M._build_p117(torch.from_numpy(img), w)
    assert p117.dtype == torch.bfloat16 and p117.shape == (h, w - 12, 117)
    np.testing.assert_array_equal(p117.float().numpy(),
                                  np.asarray(JM._build_p117(jnp.asarray(img), w), np.float32))
    img2 = img.copy()
    img2[by0:by0 + bh, bx0:bx0 + bw] = rng.integers(0, 256, (bh, bw, 3)).astype(np.float32)
    upd = M._update_p117(p117.clone(), torch.from_numpy(img2), h, w, bh, bw, by0, bx0)
    jupd = JM._update_p117(JM._build_p117(jnp.asarray(img), w), jnp.asarray(img2), h, w,
                           bh, bw, jnp.int32(by0), jnp.int32(bx0))
    np.testing.assert_array_equal(upd.float().numpy(), np.asarray(jupd, np.float32))
    np.testing.assert_array_equal(upd.float().numpy(),
                                  M._build_p117(torch.from_numpy(img2), w).float().numpy())


def search_case(shape, max_value, seed):
    """A random image with values 0..max_value, a 5×5 hole, its boundary
    targets and a border-hugging one (tests/test_inpainting.py:79-128)."""
    h, w = shape
    rng = np.random.default_rng(seed)
    img = rng.integers(0, max_value + 1, (h, w, 3)).astype(np.float32)
    rem = np.zeros((h, w), np.float32)
    y0, x0 = h // 2 - 2, w // 2 - 2
    rem[y0:y0 + 5, x0:x0 + 5] = 1.0
    targets = [(y0, x0), (y0, x0 + 4), (y0 + 4, x0 + 2), (3, 0)]
    rem[3, 0] = 1.0
    ty = np.array([t[0] for t in targets], np.int64)
    tx = np.array([t[1] for t in targets], np.int64)
    return img, rem, ty, tx


def port_search(img, rem, ty, tx, initial):
    h, w = rem.shape
    img_t = torch.from_numpy(img)
    return [v.numpy() for v in M._ring_targets_search(
        img_t, M._build_p117(img_t, w), torch.from_numpy(rem), torch.from_numpy(ty),
        torch.from_numpy(tx), torch.ones(len(ty), dtype=torch.bool), h, w, initial)]


def jax_search(img, rem, ty, tx, initial, impl, monkeypatch):
    h, w = rem.shape
    monkeypatch.setattr(JM, "_search_impl", lambda: impl)
    img_j = jnp.asarray(img)
    return [np.asarray(v) for v in JM._ring_targets_search(
        img_j, JM._build_p117(img_j, w), jnp.asarray(rem), jnp.asarray(ty.astype(np.int32)),
        jnp.asarray(tx.astype(np.int32)), jnp.ones(len(ty), bool), h, w, initial=initial)]


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("impl", ["conv", "pallas"])
@pytest.mark.parametrize("shape", [(33, 41), (34, 45)])
def test_plain_search_bit_equal_to_jax_in_the_exact_regime(shape, impl, initial, monkeypatch):
    img, rem, ty, tx = search_case(shape, 127, 3)
    e, by, bx = port_search(img, rem, ty, tx, initial)
    je, jby, jbx = jax_search(img, rem, ty, tx, initial, impl, monkeypatch)
    np.testing.assert_array_equal(by, jby)
    np.testing.assert_array_equal(bx, jbx)
    np.testing.assert_array_equal(e, je)


@pytest.mark.parametrize("impl", ["conv", "pallas"])
@pytest.mark.parametrize("shape", [(33, 41), (34, 45)])
def test_plain_search_within_jax_tolerance_on_full_range_images(shape, impl, monkeypatch):
    img, rem, ty, tx = search_case(shape, 255, 7)
    e, by, bx = port_search(img, rem, ty, tx, False)
    je, jby, jbx = jax_search(img, rem, ty, tx, False, impl, monkeypatch)
    np.testing.assert_array_equal(by, jby)
    np.testing.assert_array_equal(bx, jbx)
    np.testing.assert_allclose(e, je, rtol=1e-6, atol=4.0)


@pytest.mark.parametrize("t", [1, 16, 100])
def test_search_min_bit_equal_to_the_pallas_kernel(t):
    """(emin, flat index) straight from both searches, T not a tile multiple."""
    img, rem, _, _ = search_case((34, 45), 127, 5)
    h, w = rem.shape
    rng = np.random.default_rng(t)
    ty = torch.from_numpy(rng.integers(0, h, t))
    tx = torch.from_numpy(rng.integers(0, w, t))
    img_t = torch.from_numpy(img)
    f13, valid, _ = M._search_filters(img_t, torch.from_numpy(rem), ty, tx, h, w, False)
    p117 = M._build_p117(img_t, w)
    emin, idx = search.search_min(p117, f13, valid)
    jemin, jidx = search_min_pallas(jnp.asarray(p117.float().numpy(), jnp.bfloat16),
                                    jnp.asarray(f13.float().numpy(), jnp.bfloat16),
                                    jnp.asarray(valid.numpy()), 13, h, w)
    np.testing.assert_array_equal(emin.numpy(), np.asarray(jemin))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert emin.dtype == torch.float32 and idx.dtype == torch.int32


@pytest.mark.parametrize("max_value", [127, 255])
def test_search_matches_f64_brute_force(max_value):
    """E[t] = min_c Σ_i m_ti (a_ci − b_ti)² over the candidates whose window
    misses the hole, first minimum in raster order; energies exact in the
    exact regime, within max(4, 1e-6·E) on full-range images."""
    h, w = 33, 41
    img, rem, ty, tx = search_case((h, w), max_value, 9)
    e, by, bx = port_search(img, rem, ty, tx, False)
    pad = M.WHALF
    k = M.WINDOW_SIZE
    img_p = np.pad(img.astype(np.float64), [(pad, pad), (pad, pad), (0, 0)])
    for i, (y, x) in enumerate(zip(ty, tx)):
        b = img_p[y : y + k, x : x + k]
        yy, xx = np.mgrid[y - pad : y + pad + 1, x - pad : x + pad + 1]
        m = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).astype(np.float64)
        best = (np.inf, -1, -1)
        for cy in range(pad, h - pad):
            for cx in range(pad, w - pad):
                if rem[cy - pad : cy + pad + 1, cx - pad : cx + pad + 1].any():
                    continue
                a = img[cy - pad : cy + pad + 1, cx - pad : cx + pad + 1].astype(np.float64)
                en = float((m[:, :, None] * (a - b) ** 2).sum())
                if en < best[0]:
                    best = (en, cy, cx)
        assert (by[i], bx[i]) == best[1:], i
        if max_value == 127:
            assert e[i] == best[0], i
        else:
            assert abs(e[i] - best[0]) <= max(4.0, 1e-6 * best[0]), i


def test_search_failure_gives_inf_and_index_zero(monkeypatch):
    """Every 13×13 window of a 20×20 image covers (9, 9): no candidate is
    valid.  emin is +inf and the index 0, the conv path's convention (the
    Pallas path clamps its sentinel to ncand − 1 instead)."""
    h, w = 20, 20
    img = np.full((h, w, 3), 50, np.float32)
    rem = np.zeros((h, w), np.float32)
    rem[9, 9] = 1.0
    ty = np.array([9], np.int64)
    tx = np.array([9], np.int64)
    e, by, bx = port_search(img, rem, ty, tx, False)
    assert np.isinf(e[0]) and (by[0], bx[0]) == (M.WHALF, M.WHALF)
    je, jby, jbx = jax_search(img, rem, ty, tx, False, "conv", monkeypatch)
    assert np.isinf(je[0]) and (jby[0], jbx[0]) == (by[0], bx[0])
    img_t = torch.from_numpy(img)
    f13, valid, _ = M._search_filters(img_t, torch.from_numpy(rem), torch.from_numpy(ty),
                                      torch.from_numpy(tx), h, w, False)
    emin, idx = search.search_min(M._build_p117(img_t, w), f13, valid)
    assert not valid.any() and torch.isinf(emin).all() and idx.tolist() == [0]


def test_search_min_rejects_images_smaller_than_the_window():
    p117 = torch.zeros((12, 4, 117), dtype=torch.bfloat16)
    f13 = torch.zeros((13, 117, 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="smaller than the 13x13"):
        search.search_min(p117, f13, torch.zeros((0, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="valid must have shape"):
        search.search_min(torch.zeros((14, 4, 117), dtype=torch.bfloat16), f13,
                          torch.zeros((3, 4), dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensor"):
        search.search_min(torch.zeros((14, 4, 117), dtype=torch.bfloat16), f13,
                          torch.zeros((2, 4), dtype=torch.bool), impl="cuda")


def pack_keys(energies, indices):
    """The kernel's key: order-preserving bits of the energy (−0.0 made
    +0.0) in the high word, the flat index in the low word."""
    bits = (np.asarray(energies, np.float32) + np.float32(0.0)).view(np.uint32)
    ordered = np.where(bits & np.uint32(0x80000000), ~bits, bits | np.uint32(0x80000000))
    keys = (ordered.astype(np.uint64) << np.uint64(32)) | np.asarray(indices, np.uint64)
    return torch.from_numpy(keys.view(np.int64))


def test_key_order_is_the_lexicographic_energy_index_order():
    energies = np.array([-3.3e7, -5.5, -0.0, 0.0, 1.0, 1.0, 2.0 ** 24 + 2, 3.3e7], np.float32)
    indices = np.array([9, 4, 7, 3, 2, 5, 0, 1], np.uint32)
    keys = pack_keys(energies, indices).numpy().view(np.uint64)
    order = np.lexsort((indices, energies))  # -0.0 and 0.0 compare equal: index breaks the tie
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), order)


def test_decode_keys_inverts_the_kernel_packing():
    energies = np.array([-3.3e7, -5.5, -0.0, 0.0, 123456.0, 3.3e7], np.float32)
    indices = np.array([1, 2, 3, 4, 268319, 0], np.uint32)
    keys = torch.cat([pack_keys(energies, indices), torch.full((3,), -1, dtype=torch.int64)])
    emin, idx = cuda_search.decode_keys(keys, 8)
    np.testing.assert_array_equal(emin.numpy()[:6], energies + np.float32(0.0))
    assert not np.signbit(emin.numpy()[2])  # −0.0 came back as +0.0
    assert np.isinf(emin.numpy()[6:]).all()
    assert idx.dtype == torch.int32 and idx.tolist() == [1, 2, 3, 4, 268319, 0, 0, 0]
