"""The PyTorch port's Wexler inpainting (``models/inpainting.py``,
``ops/inpainting.py``, the CLI) against the JAX package on the CPU.

- host helpers (contour trace, weights, priority, known islands, hole box):
  equal;
- ``_boundary_ring``: equal; one fill pass: the image bit-equal, the energy
  within 1e-6 relative (each framework sums e·weight in its own order);
- ``_alt_init``: within 1 u8 (Jacobi sweeps of non-integer means);
- ``inpainting_wexler(multi_start=1)``: bit-equal on 72×72 stripe textures
  whose every partial sum is exact in f32 (values 20/120 and 40/220);
- the default ``multi_start=3``: the JAX test's criteria and a hole PSNR no
  more than 0.5 dB below JAX's;
- checkpoints: a round trip, and a JAX-written mid-run state resumed by the
  port to the JAX run's output."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from various_image_processings_tpu.models import inpainting as JM  # noqa: E402
from various_image_processings_tpu.ops.inpainting import (  # noqa: E402
    inpainting_wexler as jax_inpaint)
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.cli import wexler_inpainting as cli  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.models import inpainting as M  # noqa: E402


def stripes(size, lo, hi):
    row = ((np.arange(size) // 4) % 2 * (hi - lo) + lo).astype(np.uint8)
    return np.ascontiguousarray(np.broadcast_to(row[None, :, None], (size, size, 3)))


def square_hole(size, y0=30, y1=38, x0=30, x1=38):
    m = np.zeros((size, size), np.uint8)
    m[y0:y1, x0:x1] = 255
    return m


def mask_cases():
    yy, xx = np.mgrid[:60, :70]
    square = np.zeros((60, 70), bool)
    square[20:30, 25:37] = True
    ell = np.zeros((60, 70), bool)
    ell[10:40, 10:18] = True
    ell[32:40, 10:45] = True
    multi = ell.copy()
    multi[(yy - 20) ** 2 + (xx - 55) ** 2 <= 36] = True
    multi[52:54, 5:60] = True
    annulus = ((yy - 30) ** 2 + (xx - 35) ** 2 <= 144) & ((yy - 30) ** 2 + (xx - 35) ** 2 > 9)
    border = np.zeros((60, 70), bool)
    border[0:9, 50:70] = True
    return {"square": square, "L": ell, "multi": multi, "annulus": annulus, "border": border}


MASKS = mask_cases()


def texture(shape):
    """A periodic exact-regime texture: tiles of random_image(37, 53) // 2."""
    h, w = shape
    return np.tile(random_image(37, 53) // 2, (-(-h // 37), -(-w // 53), 1))[:h, :w].copy()


def hole_psnr(out, truth, mask):
    d = out.astype(np.float64)[mask > 0] - truth.astype(np.float64)[mask > 0]
    return 10 * np.log10(255.0 ** 2 / max(np.mean(d ** 2), 1e-12))


@pytest.mark.parametrize("name", list(MASKS))
def test_host_helpers_equal_to_jax(name):
    hole = MASKS[name]
    start = M._first_masked(hole)
    assert start == JM._first_masked(hole)
    assert M.extract_mask_contour(hole, *start) == JM.extract_mask_contour(hole, *start)
    np.testing.assert_array_equal(M.calculate_weight(hole), JM.calculate_weight(hole))
    assert M.contour_with_priority(hole) == JM.contour_with_priority(hole)
    assert M.WexlerInpainting._hole_bbox(hole) == JM.WexlerInpainting._hole_bbox(hole)
    island, j_island = M._island_known(hole), JM._island_known(hole)
    assert (island is None) == (j_island is None) == (name != "annulus")
    if island is not None:
        np.testing.assert_array_equal(island, j_island)


@pytest.mark.parametrize("seeded", [False, True])
def test_boundary_ring_equal_to_jax(seeded):
    rng = np.random.default_rng(4)
    rem = (rng.random((23, 31)) < 0.4).astype(np.float32)
    seed = ((rem == 0) & (rng.random((23, 31)) < 0.5)).astype(np.float32) if seeded else None
    got = M._boundary_ring(torch.from_numpy(rem), 23, 31,
                           None if seed is None else torch.from_numpy(seed))
    want = JM._boundary_ring(jnp.asarray(rem), 23, 31, None if seed is None else jnp.asarray(seed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def pass_inputs(name, prefill):
    hole = MASKS[name]
    img = texture(hole.shape)
    if prefill:  # an energy pass refines an existing fill
        img = img.copy()
        img[hole] = 64
    bbox = M.WexlerInpainting._hole_bbox(hole)
    island = M._island_known(hole)
    return img, hole.astype(np.float32), M.calculate_weight(hole).astype(np.float32), bbox, island


@pytest.mark.parametrize("name,initial,cap", [("square", True, M.RING_CAP),
                                              ("annulus", True, M.RING_CAP),
                                              ("multi", True, 32),
                                              ("L", False, 64), ("border", False, 16)])
def test_fill_pass_equal_to_jax(name, initial, cap):
    img, rem, weight, bbox, island = pass_inputs(name, not initial)
    h, w = rem.shape
    island = island if initial else None
    out, energy = M._fill_pass_device(
        torch.from_numpy(img), torch.from_numpy(rem), torch.from_numpy(weight), h, w, initial,
        cap=cap, bbox_size=bbox[0], bbox_origin=bbox[1],
        island=None if island is None else torch.from_numpy(island.astype(np.float32)))
    j_out, j_energy = JM._fill_pass_device(
        jnp.asarray(img), jnp.asarray(rem), jnp.asarray(weight), h, w, initial, cap=cap,
        bbox_size=bbox[0], bbox_origin=jnp.asarray(bbox[1], jnp.int32),
        island=None if island is None else jnp.asarray(island.astype(np.float32)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    assert float(energy) > 0
    np.testing.assert_allclose(float(energy), float(j_energy), rtol=1e-6)
    np.testing.assert_array_equal(out.numpy()[rem == 0], img[rem == 0])


def test_fill_pass_discards_a_failed_search():
    """Every window of a 20×20 image covers (9, 9): the search fails, the
    energy is −1, as in the JAX package."""
    img = texture((20, 20))
    rem = np.zeros((20, 20), np.float32)
    rem[9, 9] = 1.0
    weight = M.calculate_weight(rem > 0).astype(np.float32)
    _, energy = M._fill_pass_device(torch.from_numpy(img), torch.from_numpy(rem),
                                    torch.from_numpy(weight), 20, 20, True)
    _, j_energy = JM._fill_pass_device(jnp.asarray(img), jnp.asarray(rem), jnp.asarray(weight),
                                       20, 20, True)
    assert float(energy) == float(j_energy) == -1.0


@pytest.mark.parametrize("dither", [False, True])
def test_alt_init_within_one_of_jax(dither):
    img, rem, _, bbox, _ = pass_inputs("L", False)
    h, w = rem.shape
    got = M._alt_init_device(torch.from_numpy(img), torch.from_numpy(rem), h, w, bbox[0],
                             bbox[1], dither).numpy()
    want = np.asarray(JM._alt_init_device(jnp.asarray(img), jnp.asarray(rem), h, w,
                                          bbox_size=bbox[0],
                                          bbox_origin=jnp.asarray(bbox[1], jnp.int32),
                                          dither=dither))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(got[rem == 0], img[rem == 0])


@pytest.mark.parametrize("lo,hi", [(20, 120), (40, 220)])
def test_inpaint_multi_start_1_bit_equal_to_jax(lo, hi):
    img, mask = stripes(72, lo, hi), square_hole(72)
    out = vt.inpainting_wexler(img, mask, multi_start=1, device="cpu")
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), jax_inpaint(img, mask, multi_start=1))


def test_inpaint_periodic_texture_default_beam():
    """tests/test_inpainting.py::test_inpaint_periodic_texture's criteria, and
    the hole PSNR against the true stripes within 0.5 dB of JAX's."""
    img, mask = stripes(72, 40, 220), square_hole(72)
    out = vt.inpainting_wexler(img, mask, device="cpu").numpy()
    diff = np.abs(out.astype(int) - img.astype(int))[30:38, 30:38]
    assert np.median(diff) <= 2
    assert diff.mean() <= 30
    j_out = jax_inpaint(img, mask)
    assert hole_psnr(out, img, mask) >= hole_psnr(j_out, img, mask) - 0.5
    np.testing.assert_array_equal(out[mask == 0], img[mask == 0])


def test_inpaint_validates_inputs():
    with pytest.raises(ValueError, match="sizes differ"):
        M.WexlerInpainting(device="cpu")(np.zeros((10, 10, 3), np.uint8),
                                         np.zeros((9, 10), np.uint8))
    with pytest.raises(ValueError, match="at least 13x13"):
        vt.inpainting_wexler(np.zeros((10, 20, 3), np.uint8), np.full((10, 20), 255, np.uint8),
                             device="cpu")
    with pytest.raises(ValueError, match="impl"):
        M.WexlerInpainting(impl="pallas", device="cpu")


def test_module_keeps_nn_module_apply_and_tensor_devices():
    module = M.WexlerInpainting(multi_start=1, device="cpu")
    assert M.WexlerInpainting.apply is torch.nn.Module.apply
    assert list(module.parameters()) == [] and module.state_dict() == {}
    img, mask = stripes(72, 20, 120), square_hole(72)
    out = module(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), module(img, mask).numpy())


def jax_states(monkeypatch, img, mask, tmp_path):
    """Every state the JAX package checkpoints while it fills (multi_start=1)."""
    states, savez = [], np.savez

    def record(path, **arrays):
        states.append({k: np.asarray(v) for k, v in arrays.items()})
        savez(path, **arrays)

    monkeypatch.setattr(JM.np, "savez", record)
    out = JM.WexlerInpainting(checkpoint_dir=str(tmp_path / "jax"), multi_start=1).apply(img, mask)
    monkeypatch.setattr(JM.np, "savez", savez)
    return out, states


def test_checkpoint_roundtrip(tmp_path):
    img, mask = stripes(72, 40, 220), square_hole(72)
    direct = vt.inpainting_wexler(img, mask, device="cpu").numpy()
    ckdir = str(tmp_path / "ck")
    with_ck = vt.inpainting_wexler(img, mask, device="cpu", checkpoint_dir=ckdir).numpy()
    np.testing.assert_array_equal(with_ck, direct)
    state = np.load(os.path.join(ckdir, "wexler_state.npz"))
    assert set(state.files) == {"num_layers", "next_layer", "do_initial", "src_0", "src_1"}
    assert int(state["next_layer"]) == -1
    resumed = vt.inpainting_wexler(img, mask, device="cpu", checkpoint_dir=ckdir).numpy()
    np.testing.assert_array_equal(resumed, direct)
    other = vt.inpainting_wexler(stripes(80, 40, 220), square_hole(80), device="cpu",
                                 checkpoint_dir=ckdir)  # a shape change ignores the state
    assert other.shape == (80, 80, 3)


def test_jax_written_mid_run_checkpoint_resumed_by_the_port(monkeypatch, tmp_path):
    img, mask = stripes(72, 20, 120), square_hole(72)
    j_out, states = jax_states(monkeypatch, img, mask, tmp_path)
    mid = states[0]
    assert int(mid["num_layers"]) == 2 and int(mid["next_layer"]) == 0
    assert not bool(mid["do_initial"])
    ckdir = tmp_path / "port"
    ckdir.mkdir()
    np.savez(ckdir / "wexler_state.npz", **mid)
    out = vt.inpainting_wexler(img, mask, multi_start=1, device="cpu",
                               checkpoint_dir=str(ckdir)).numpy()
    np.testing.assert_array_equal(out, j_out)
    final = np.load(ckdir / "wexler_state.npz")
    np.testing.assert_array_equal(final["src_0"], states[-1]["src_0"])


def test_cli_on_the_cpu(tmp_path, capsys):
    img, mask = stripes(72, 20, 120), square_hole(72)
    img_path, mask_path = str(tmp_path / "img.png"), str(tmp_path / "mask.png")
    out_path = str(tmp_path / "out.png")
    cv2.imwrite(img_path, img)
    cv2.imwrite(mask_path, mask)
    assert cli.main([img_path, mask_path, "-o", out_path, "--device", "cpu"]) == 0
    assert "Layer 0..." in capsys.readouterr().out
    np.testing.assert_array_equal(cv2.imread(out_path),
                                  vt.inpainting_wexler(img, mask, device="cpu").numpy())
