"""The Wexler fill loop as a device program (``models/inpainting.py::
_FillPass``, ``_pass_core``, ``_energy_loops_device``, ``_alt_init_device``)
on the CPU, where every piece runs its plain version.

- Each plain piece against the JAX package's pass, iteration by iteration,
  on the mask cases of tests/test_torch_inpainting.py: the ring pick's
  targets and count against JAX's ring and ``jnp.nonzero`` (:446-488), the
  target filters and search against ``_ring_targets_search`` (energies and
  picks bit-equal: the images are exact-regime textures), the commit against
  JAX's scatters (image and mask bit-equal, the planes equal to
  ``_build_p117`` of the committed image, the pass energy within 1e-6
  relative: each framework sums in its own order); the diffusion start
  within 1 u8 (Jacobi sweeps of non-integer means), as before.
- The schedule (no host read inside an energy pass, the active flag read
  every ``SYNC_EVERY`` onion-peel iterations, no-op iterations after a
  failure or a stop) against JAX ``_fill_pass_device`` and
  ``_energy_loops_device``: images bit-equal, energies within 1e-6
  relative, the failing 20x20 case and caps smaller than a ring included.
- ``host_syncs`` of a 72x72 inpaint against the schedule's formula.
- NumPy twins of what the kernels (csrc/wexler_fill.cu) do differently from
  the plain pieces: the ring pick's word masks (ballot words, funnel-shift
  neighbours, the box edge as known, bands of rows with a halo row, one
  block scan a band, a slot a thread by binary search over the threads'
  first slots), the filters' separable validity recount (staged bits,
  13-wide runs by shifts, the 13-tall AND, 4-byte stores inside a tile
  row), their filter rows (scale * m or -2 (b m), 4 columns a lane), the
  commit's in-place p117 scatter (held to ``_build_p117`` of the committed
  image), and b2's per-warp tree (held to ``_tree_sum``).
- Routing: a CPU tensor with ``impl="cuda"`` raises, as do the kernel
  wrappers; ``encode_keys`` inverts ``decode_keys``."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from various_image_processings_tpu.models import inpainting as JM  # noqa: E402
from various_image_processings_tpu.ops.inpainting import (  # noqa: E402
    inpainting_wexler as jax_inpaint)
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.models import inpainting as M  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import wexler_fill as kfill  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import wexler_search as kws  # noqa: E402

K = M.WINDOW_SIZE
FILL_CU = (Path(__file__).resolve().parents[1] / "various_image_processings_tpu_torch" / "csrc"
           / "wexler_fill.cu").read_text()


def cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", FILL_CU).group(1))


PICK_THREADS = cu_constant("kPickThreads")  # the ring pick's one block
PICK_WORDS = cu_constant("kPickWords")      # a band's mask words
TILE_ROWS = cu_constant("kTileRows")        # a validity tile's candidate rows
TILE_WORDS = cu_constant("kTileWords")      # ... and 32-candidate words a row


def mask_cases():
    """tests/test_torch_inpainting.py:40-55."""
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


def lone_pixel():
    """Every 13x13 window of a 20x20 image covers (9, 9): the search fails."""
    hole = np.zeros((20, 20), bool)
    hole[9, 9] = True
    return hole


def case(name, initial):
    """(image u8, hole f32, weight f32, box (bh, bw, by0, bx0), island f32 or
    None); energy passes start from a flat fill of the hole."""
    hole = lone_pixel() if name == "lone" else MASKS[name]
    img = texture(hole.shape)
    if not initial:
        img[hole] = 64
    (bh, bw), (by0, bx0) = M.WexlerInpainting._hole_bbox(hole)
    island = M._island_known(hole) if initial else None
    return (img, hole.astype(np.float32), M.calculate_weight(hole).astype(np.float32),
            (bh, bw, by0, bx0), None if island is None else island.astype(np.float32))


def plain_pass(img, rem, weight, box, island, initial, cap):
    h, w = rem.shape
    return M._FillPass(torch.from_numpy(img).float(), torch.from_numpy(rem),
                       torch.from_numpy(weight), h, w, initial, cap, box,
                       None if island is None else torch.from_numpy(island), "torch")


def state_energy(fp):
    return float(fp.state.view(torch.float32)[kfill.ENERGY])


# -- each plain piece against the JAX package's pass ------------------------

def jax_targets(rem, rem0, island, box, initial, cap):
    """The JAX body's targets (:446-488): (ty, tx, count)."""
    bh, bw, by0, bx0 = box
    rem_box = jnp.asarray(rem)[by0 : by0 + bh, bx0 : bx0 + bw]
    if not initial:
        ring = rem_box > 0
    elif island is None:
        ring = JM._boundary_ring(rem_box, bh, bw)
    else:
        filled = (jnp.asarray(rem0)[by0 : by0 + bh, bx0 : bx0 + bw] > 0) & (rem_box == 0)
        isl = jnp.asarray(island)[by0 : by0 + bh, bx0 : bx0 + bw]
        seed = ((rem_box == 0) & (filled | (isl == 0))).astype(jnp.float32)
        ring_r = JM._boundary_ring(rem_box, bh, bw, seed=seed)
        ring = jnp.where(jnp.any(ring_r), ring_r, JM._boundary_ring(rem_box, bh, bw))
    tys, txs = jnp.nonzero(ring, size=cap, fill_value=0)
    return np.asarray(tys) + by0, np.asarray(txs) + bx0, int(jnp.sum(ring))


@pytest.mark.parametrize("name,initial,cap", [
    ("square", True, 256), ("L", True, 32), ("multi", True, 256), ("annulus", True, 256),
    ("border", True, 64), ("square", False, 64), ("L", False, 1024), ("multi", False, 32),
    ("annulus", False, 256), ("border", False, 16)])
def test_plain_pieces_step_by_step_equal_to_jax(name, initial, cap, monkeypatch):
    monkeypatch.setattr(JM, "_search_impl", lambda: "conv")
    img, rem, weight, box, island = case(name, initial)
    h, w = rem.shape
    fp = plain_pass(img, rem, weight, box, island, initial, cap)
    iterations, j_energy = 0, np.float32(0.0)
    while True:
        cur_img, cur_rem = fp.img.numpy().copy(), fp.rem.numpy().copy()
        fp.ring_pick()
        ty, tx, count = jax_targets(cur_rem, rem, island, box, initial, cap)
        assert int(fp.state[kfill.ACTIVE]) == (count > 0)
        if count == 0:
            break
        np.testing.assert_array_equal(fp.tyx.numpy(), np.stack([ty, tx]))
        assert int(fp.state[kfill.COUNT]) == min(count, cap)
        fp.filters()
        fp.search()
        # the search's target side and picks against _ring_targets_search
        tvalid = np.arange(cap) < count
        je, jby, jbx = JM._ring_targets_search(
            jnp.asarray(cur_img), JM._build_p117(jnp.asarray(cur_img), w), jnp.asarray(cur_rem),
            jnp.asarray(ty.astype(np.int32)), jnp.asarray(tx.astype(np.int32)),
            jnp.asarray(tvalid), h, w, initial)
        emin, idx = kws.decode_keys(fp.keys, cap)
        e = np.where(tvalid, (emin + fp.b2).numpy(), 0.0)
        n_cx = w - 2 * M.WHALF
        idx = idx.numpy().astype(np.int64)
        np.testing.assert_array_equal(e, np.asarray(je))
        np.testing.assert_array_equal((idx // n_cx + M.WHALF)[tvalid], np.asarray(jby)[tvalid])
        np.testing.assert_array_equal((idx % n_cx + M.WHALF)[tvalid], np.asarray(jbx)[tvalid])
        fp.commit()
        # the commit against JAX's scatters (:491-501)
        do = tvalid & np.isfinite(np.asarray(je)).all()
        want_img, want_rem = cur_img.copy(), cur_rem.copy()
        want_img[ty[do], tx[do]] = cur_img[np.asarray(jby)[do], np.asarray(jbx)[do]]
        want_rem[ty[do], tx[do]] = 0.0
        np.testing.assert_array_equal(fp.img.numpy(), want_img)
        np.testing.assert_array_equal(fp.rem.numpy(), want_rem)
        np.testing.assert_array_equal(
            fp.p[..., : 9 * K].float().numpy(),
            np.asarray(JM._build_p117(jnp.asarray(want_img), w), np.float32))
        j_energy = j_energy + np.float32(
            jnp.sum(jnp.where(jnp.asarray(do), je * jnp.asarray(weight)[ty, tx], 0.0)))
        np.testing.assert_allclose(state_energy(fp), j_energy, rtol=1e-6)
        assert int(fp.state[kfill.FAIL]) == (not do.any())
        iterations += 1
    assert iterations >= 1 and not (fp.rem.numpy()[rem > 0] > 0).any()
    assert int(fp.state[kfill.ITERATIONS]) == iterations


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("dither", [False, True])
def test_diffusion_start_within_one_of_jax(name, dither):
    img, rem, _, box, _ = case(name, True)
    h, w = rem.shape
    bh, bw, by0, bx0 = box
    got = M._alt_init_device(torch.from_numpy(img), torch.from_numpy(rem), h, w, (bh, bw),
                             (by0, bx0), dither).numpy()
    want = np.asarray(JM._alt_init_device(jnp.asarray(img), jnp.asarray(rem), h, w,
                                          bbox_size=(bh, bw),
                                          bbox_origin=jnp.asarray((by0, bx0), jnp.int32),
                                          dither=dither))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(got[rem == 0], img[rem == 0])


# -- the schedule against JAX's while_loops ---------------------------------

def run_fill_pass(name, initial, cap):
    img, rem, weight, box, island = case(name, initial)
    h, w = rem.shape
    bh, bw, by0, bx0 = box
    out, energy = M._fill_pass_device(
        torch.from_numpy(img), torch.from_numpy(rem), torch.from_numpy(weight), h, w, initial,
        cap=cap, bbox_size=(bh, bw), bbox_origin=(by0, bx0),
        island=None if island is None else torch.from_numpy(island))
    j_out, j_energy = JM._fill_pass_device(
        jnp.asarray(img), jnp.asarray(rem), jnp.asarray(weight), h, w, initial, cap=cap,
        bbox_size=(bh, bw), bbox_origin=jnp.asarray((by0, bx0), jnp.int32),
        island=None if island is None else jnp.asarray(island))
    return out.numpy(), float(energy), np.asarray(j_out), float(j_energy)


@pytest.mark.parametrize("name,initial,cap", [("multi", True, 16), ("annulus", True, 32),
                                              ("L", False, 16), ("lone", True, 256),
                                              ("lone", False, 16)])
def test_schedule_fill_pass_equal_to_jax(name, initial, cap, monkeypatch):
    """Caps below a ring (many iterations, several flag reads), an island
    mask, an energy pass of ⌈hole / cap⌉ iterations, and the failing 20x20
    search, whose pass is −1 with the partial fill JAX keeps."""
    monkeypatch.setattr(JM, "_search_impl", lambda: "conv")
    out, energy, j_out, j_energy = run_fill_pass(name, initial, cap)
    np.testing.assert_array_equal(out, j_out)
    if name == "lone":
        assert energy == j_energy == -1.0
    else:
        assert energy > 0
        np.testing.assert_allclose(energy, j_energy, rtol=1e-6)


@pytest.mark.parametrize("name,cap,max_loop,ran", [("square", 16, 5, 5), ("border", 64, 5, None),
                                                   ("multi", 64, 5, 2), ("L", 64, 4, 2),
                                                   ("lone", 16, 4, 1)])
def test_schedule_energy_loops_equal_to_jax(name, cap, max_loop, ran, monkeypatch):
    """All max_loop passes enqueued, the stop and commit decided on the
    device: the passes after the stop (``ran`` passes ran: the L and multi
    masks stop at a non-decrease) leave the image, the committed energy and
    the NaN of their energies as JAX's while_loop leaves them; the 20x20
    case fails its first pass (−1, then NaN, and +inf committed)."""
    monkeypatch.setattr(JM, "_search_impl", lambda: "conv")
    img, rem, weight, box, _ = case(name, False)
    h, w = rem.shape
    bh, bw, by0, bx0 = box
    out, energies, cur_e = M._energy_loops_device(
        torch.from_numpy(img), torch.from_numpy(rem), torch.from_numpy(weight), h, w,
        max_loop=max_loop, cap=cap, bbox_size=(bh, bw), bbox_origin=(by0, bx0),
        nhole=int((rem > 0).sum()))
    j_out, j_energies, j_cur = JM._energy_loops_device(
        jnp.asarray(img), jnp.asarray(rem), jnp.asarray(weight), h, w, max_loop=max_loop,
        cap=cap, bbox_size=(bh, bw), bbox_origin=jnp.asarray((by0, bx0), jnp.int32))
    energies, j_energies = energies.numpy(), np.asarray(j_energies)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(np.isnan(energies), np.isnan(j_energies))
    np.testing.assert_allclose(energies, j_energies, rtol=1e-6)
    np.testing.assert_allclose(float(cur_e), float(j_cur), rtol=1e-6)
    if ran is not None:
        assert not np.isnan(energies[:ran]).any() and np.isnan(energies[ran:]).all()
    if name == "lone":
        assert energies[0] == -1.0 and float(cur_e) == np.inf


def test_energy_pass_reads_its_count_only_when_not_given():
    img, rem, weight, box, _ = case("square", False)
    h, w = rem.shape
    bh, bw, by0, bx0 = box
    args = (torch.from_numpy(img).float(), torch.from_numpy(rem), torch.from_numpy(weight), h, w,
            False, 64, (bh, bw), (by0, bx0))
    M.host_syncs = 0
    given, e_given = M._pass_core(*args, n_iter=-(-int(rem.sum()) // 64))
    assert M.host_syncs == 0
    read, e_read = M._pass_core(*args)
    assert M.host_syncs == 1
    assert torch.equal(given, read) and torch.equal(e_given, e_read)


# -- host syncs ---------------------------------------------------------------

def twin_rings(hole, island, cap):
    """Onion-peel iterations of a pass over ``hole``'s box (NumPy, the
    kernel's chunked scan): how many rings, each of at most cap targets."""
    (bh, bw), (by0, bx0) = M.WexlerInpainting._hole_bbox(hole)
    rem = hole.astype(np.float32)
    rings = 0
    while True:
        ty, tx, count = twin_ring_pick(rem, hole.astype(np.float32), island, (bh, bw, by0, bx0),
                                       cap, True)
        if count == 0:
            return rings
        rem[ty[:count], tx[:count]] = 0.0
        rings += 1


def stripes(size, lo, hi):
    row = ((np.arange(size) // 4) % 2 * (hi - lo) + lo).astype(np.uint8)
    return np.ascontiguousarray(np.broadcast_to(row[None, :, None], (size, size, 3)))


@pytest.mark.parametrize("multi_start", [1, 3])
def test_host_syncs_of_a_72x72_inpaint_follow_the_schedule(multi_start):
    """1 (the mask pyramid) + for each onion-peel pass ⌊rings / SYNC_EVERY⌋
    + 1 flag reads + 1 for the coarsest level's energy; energy passes read
    nothing.  With the beam (72 ≤ BEAM_MAX_DIM) the finest level adds a
    from-scratch onion peel whose energy is not read."""
    img = stripes(72, 20, 120)
    mask = np.zeros((72, 72), np.uint8)
    mask[30:38, 30:38] = 255
    module = M.WexlerInpainting(multi_start=multi_start, device="cpu")
    _, masks = module._construct_pyramid(torch.from_numpy(img), torch.from_numpy(mask))
    holes = [m > 0 for m in masks]
    assert [h.shape for h in holes] == [(72, 72), (36, 36)]

    def flag_reads(hole):
        island = M._island_known(hole)
        rings = twin_rings(hole, None if island is None else island.astype(np.float32),
                           M.RING_CAP)
        return rings // M.SYNC_EVERY + 1

    want = 1 + flag_reads(holes[1]) + 1 + (flag_reads(holes[0]) if multi_start > 1 else 0)
    M.host_syncs = M.plain_pieces = 0
    out = module(img, mask)
    assert M.host_syncs == want
    assert M.plain_pieces > 0
    np.testing.assert_array_equal(out.numpy(), jax_inpaint(img, mask, multi_start=multi_start))


# -- NumPy twins of the kernels ----------------------------------------------

def twin_on_ring(rem, rem0, island, box, initial, restricted):
    """(bh, bw) bool: on_ring() of csrc/wexler_fill.cu for every box pixel."""
    bh, bw, by0, bx0 = box
    r = rem[by0 : by0 + bh, bx0 : bx0 + bw]
    if not initial:
        return r > 0
    if restricted:
        known = (r == 0) & ((rem0[by0 : by0 + bh, bx0 : bx0 + bw] > 0)
                            | (island[by0 : by0 + bh, bx0 : bx0 + bw] == 0))
    else:
        known = (np.float32(1.0) - r) > 0
    padded = np.pad(known, 1, constant_values=True)  # the box edge is known
    neigh = np.zeros_like(known)
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                neigh |= padded[dy : dy + bh, dx : dx + bw]
    return (r > 0) & neigh


def ballot_words(bits):
    """(rows, 32 n) bool → (rows, n) uint32: bit i of word w is column
    32 w + i, as a warp's ballot over 32 coalesced loads packs it."""
    rows, cols = bits.shape
    b = bits.reshape(rows, cols // 32, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def popcount(words):
    words = np.atleast_1d(np.asarray(words, np.uint32))
    return np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)


def across(known, centre):
    """across() of the kernel on every word of (rows, n) uint32 rows: bit i
    set where the left or right neighbour of pixel 32 w + i is known (funnel
    shifts across words; past the box's left and right edges known), or with
    ``centre`` the pixel itself."""
    ones = np.full((known.shape[0], 1), 0xFFFFFFFF, np.uint32)
    left = np.concatenate([ones, known[:, :-1]], 1)
    right = np.concatenate([known[:, 1:], ones], 1)
    sides = (known << 1) | (left >> 31) | (known >> 1) | (right << 31)
    return sides | known if centre else sides


def nth_bit(v, r):
    """The position of the r-th set bit of v, by the kernel's halving steps."""
    b = 0
    for step in (16, 8, 4, 2, 1):
        low = bin(v & ((1 << step) - 1)).count("1")
        if r >= low:
            r, v, b = r - low, v >> step, b + step
    return b


def band_words(rem, rem0, island, box, initial, restricted, r0, rows):
    """A band's ring words (rows, n) uint32: the remaining mask's ballot
    words and, in onion peels, the known mask's with a halo row on each
    side, every pixel outside the box known."""
    bh, bw, by0, bx0 = box
    words = -(-bw // 32)
    remaining = np.zeros((rows, 32 * words), bool)
    remaining[:, :bw] = rem[by0 + r0 : by0 + r0 + rows, bx0 : bx0 + bw] > 0
    ring = ballot_words(remaining)
    if not initial:
        return ring
    ys = np.arange(r0 - 1, r0 + rows + 1)
    inside = (ys >= 0) & (ys < bh)
    rows_in = by0 + ys[inside]
    rn = rem[rows_in, bx0 : bx0 + bw]
    if restricted:
        kn = (rn == 0) & ((rem0[rows_in, bx0 : bx0 + bw] > 0)
                          | (island[rows_in, bx0 : bx0 + bw] == 0))
    else:
        kn = (np.float32(1.0) - rn) > 0
    known = np.ones((rows + 2, 32 * words), bool)
    known[inside, :bw] = kn
    k = ballot_words(known)
    return ring & (across(k[:-2], True) | across(k[1:-1], False) | across(k[2:], True))


def twin_ring_pick(rem, rem0, island, box, cap, initial, pick_words=PICK_WORDS):
    """The ring pick kernel's scan: bands of rows whose mask words fit
    ``pick_words``; a band's ring words split into contiguous runs, one a
    thread of PICK_THREADS; each thread's first slot from a warp scan and a
    scan of the warp totals; then each slot below cap from the last thread
    whose first slot is at most it (binary search), its word, the bit; the
    next band from the band's total, stopping once cap targets are taken;
    the seed-restricted ring first where there are islands.  → (ty (cap,),
    tx (cap,), count ≤ cap)."""
    bh, bw, by0, bx0 = box
    words = -(-bw // 32)
    band = pick_words // words - (2 if initial else 0)
    ty = np.full(cap, by0, np.int32)
    tx = np.full(cap, bx0, np.int32)
    base = 0
    for restricted in ([True, False] if initial and island is not None else [False]):
        base = 0
        for r0 in range(0, bh, band):
            if base >= cap:
                break
            flat = band_words(rem, rem0, island, box, initial, restricted, r0,
                              min(band, bh - r0)).reshape(-1)
            per = -(-flat.size // PICK_THREADS)
            counts = np.zeros(PICK_THREADS * per, np.int64)
            counts[: flat.size] = popcount(flat)
            own = counts.reshape(PICK_THREADS, per).sum(1).reshape(-1, 32)
            incl = np.cumsum(own, axis=1)                       # the warps' scans
            warp_base = np.cumsum(incl[:, -1]) - incl[:, -1]    # warp 0's scan
            thread_base = (warp_base[:, None] + incl - own).reshape(-1)
            band_total = int(incl[:, -1].sum())
            for j in range(min(band_total, cap - base)):
                t = 0
                step = PICK_THREADS // 2
                while step >= 1:
                    if thread_base[t + step] <= j:
                        t += step
                    step //= 2
                r, i = j - int(thread_base[t]), t * per
                while r >= int(flat[i]).bit_count():
                    r -= int(flat[i]).bit_count()
                    i += 1
                k = i // words
                ty[base + j] = by0 + r0 + k
                tx[base + j] = bx0 + 32 * (i - k * words) + nth_bit(int(flat[i]), r)
            base += band_total
        if base > 0:
            break
    count = min(base, cap)
    ty[count:], tx[count:] = by0, bx0
    return ty, tx, count


def random_state(seed, h, w, box, density):
    """A remaining mask inside the box, a pass-start mask that holds it, and
    known islands."""
    rng = np.random.default_rng(seed)
    bh, bw, by0, bx0 = box
    rem0 = np.zeros((h, w), np.float32)
    rem0[by0 : by0 + bh, bx0 : bx0 + bw] = rng.random((bh, bw)) < density
    rem = rem0 * (rng.random((h, w)) < 0.7)
    island = ((rem0 == 0) & (rng.random((h, w)) < 0.3)).astype(np.float32)
    return rem.astype(np.float32), rem0, island


@pytest.mark.parametrize("cap", [1, 5, 16, 256, 1024])
@pytest.mark.parametrize("shape,box", [((60, 70), (60, 70, 0, 0)), ((90, 80), (64, 64, 13, 9)),
                                       ((40, 45), (17, 23, 20, 20))])
def test_ring_pick_chunked_scan_twin_equals_plain_piece(cap, shape, box):
    """The word-mask twin (one band at these sizes); energy passes, onion
    peels with and without islands, an empty ring."""
    h, w = shape
    for seed, (initial, islands, density) in enumerate(
            [(False, False, 0.6), (True, False, 0.6), (True, True, 0.9), (True, True, 0.0)]):
        rem, rem0, island = random_state(seed, h, w, box, density)
        check_ring_pick(rem, rem0, island if islands else None, box, cap, initial)


def check_ring_pick(rem, rem0, island, box, cap, initial, pick_words=PICK_WORDS):
    """The twin's targets and count against ``_FillPass.ring_pick``; → count."""
    h, w = rem.shape
    ty, tx, count = twin_ring_pick(rem, rem0, island, box, cap, initial, pick_words)
    fp = M._FillPass(torch.zeros((h, w, 3)), torch.from_numpy(rem0), torch.zeros((h, w)), h, w,
                     initial, cap, box, None if island is None else torch.from_numpy(island),
                     "torch")
    fp.rem.copy_(torch.from_numpy(rem))
    fp.ring_pick()
    np.testing.assert_array_equal(fp.tyx.numpy(), np.stack([ty, tx]))
    assert int(fp.state[kfill.COUNT]) == count
    assert int(fp.state[kfill.ACTIVE]) == (count > 0)
    assert (fp.keys == -1).all()
    return count


def test_ring_pick_bands_as_the_twin_takes_them():
    """The kernel's band rows are the twin's: its masks' words fit
    kPickWords, an onion peel's known mask with a halo row on each side."""
    assert PICK_THREADS == 1024 and PICK_WORDS % PICK_THREADS == 0
    assert ("return kPickWords / ((bw + 31) / 32) - (mode == kEnergyMode ? 0 : 2);"
            in FILL_CU)


@pytest.mark.parametrize("bw", [1, 31, 32, 33, 63, 64, 65])
@pytest.mark.parametrize("initial,islands", [(False, False), (True, False), (True, True)])
def test_ring_pick_word_twin_on_box_widths(bw, initial, islands):
    """Box widths a word and a pixel either side of 32 and 64, at the image
    border and inside it; caps reached mid-word (5, 37) and not (1024)."""
    for seed, (h, w, box) in enumerate([(30, bw + 16, (19, bw, 0, 0)),
                                        (40, bw + 20, (23, bw, 9, 11))]):
        rem, rem0, island = random_state(seed, h, w, box, 0.7)
        for cap in (5, 37, 1024):
            check_ring_pick(rem, rem0, island if islands else None, box, cap, initial)


@pytest.mark.parametrize("box", [(1, 57, 12, 3), (44, 1, 2, 20)])
@pytest.mark.parametrize("initial", [False, True])
def test_ring_pick_word_twin_on_one_row_and_one_column_boxes(box, initial):
    rem, rem0, island = random_state(4, 50, 64, box, 0.8)
    for cap in (3, 16, 256):
        for isl in (None, island) if initial else (None,):
            check_ring_pick(rem, rem0, isl, box, cap, initial)


@pytest.mark.parametrize("pick_words", [12, 24])
@pytest.mark.parametrize("initial,islands", [(False, False), (True, False), (True, True)])
def test_ring_pick_word_twin_in_bands(pick_words, initial, islands):
    """Bands of a few rows (a small word budget: 12 or 24 words), the base
    carried across bands and the scan stopping once cap targets are taken,
    mid-band and mid-word; 70-pixel rows take 3 words."""
    box = (37, 70, 5, 4)
    rem, rem0, island = random_state(9, 50, 80, box, 0.5)
    assert pick_words // 3 - 2 * initial < 37  # more than one band
    counts = [check_ring_pick(rem, rem0, island if islands else None, box, cap, initial,
                              pick_words) for cap in (1, 29, 300, 1024)]
    assert counts[-1] < 1024 and counts[1] == 29


def test_ring_pick_word_twin_falls_back_to_the_plain_ring():
    """An island around a hole pixel: once the annulus is filled, the
    restricted ring is empty and the plain ring takes the inner hole."""
    yy, xx = np.mgrid[:40, :40]
    d = (yy - 20) ** 2 + (xx - 20) ** 2
    hole = ((d <= 100) & (d > 9)) | (d == 0)
    island = M._island_known(hole).astype(np.float32)
    rem0 = hole.astype(np.float32)
    rem = (d == 0).astype(np.float32)  # the annulus filled in this pass
    box = (21, 21, 10, 10)
    restricted = band_words(rem, rem0, island, box, True, True, 0, 21)
    assert not restricted.any()  # the seeds exclude the island
    for pick_words in (PICK_WORDS, 3):
        assert check_ring_pick(rem, rem0, island, box, 16, True, pick_words) == 1


@pytest.mark.parametrize("restricted", [False, True])
def test_ring_words_equal_on_ring(restricted):
    """The funnel-shift ring, unpacked, against the per-pixel on_ring()."""
    box = (45, 67, 3, 2)
    rem, rem0, island = random_state(11, 50, 75, box, 0.6)
    words = band_words(rem, rem0, island, box, True, restricted, 0, 45)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little").reshape(45, -1)[:, :67]
    np.testing.assert_array_equal(bits.astype(bool),
                                  twin_on_ring(rem, rem0, island, box, True, restricted))


def test_ring_pick_clears_active_after_a_failure_or_a_stop():
    rem, rem0, _ = random_state(3, 30, 40, (30, 40, 0, 0), 0.5)
    for slot in (kfill.FAIL, kfill.LIVE):
        fp = M._FillPass(torch.zeros((30, 40, 3)), torch.from_numpy(rem0), torch.zeros((30, 40)),
                         30, 40, False, 16, (30, 40, 0, 0), None, "torch")
        fp.rem.copy_(torch.from_numpy(rem))
        fp.tyx.fill_(7)
        fp.keys.fill_(5)
        fp.state[slot] = 1 if slot == kfill.FAIL else 0
        before = fp.state.clone()
        fp.ring_pick()
        assert int(fp.state[kfill.ACTIVE]) == 0 and (fp.tyx == 7).all() and (fp.keys == 5).all()
        assert fp.state[kfill.COUNT] == before[kfill.COUNT]
        assert fp.state[kfill.ITERATIONS] == before[kfill.ITERATIONS]


def run13(v):
    """Bit x of the uint64 words v: bits x .. x + 12 all set."""
    a2 = v & (v >> np.uint64(1))
    a4 = a2 & (a2 >> np.uint64(2))
    a8 = a4 & (a4 >> np.uint64(4))
    return a8 & (a4 >> np.uint64(8)) & (v >> np.uint64(12))


def twin_validity(rem, region, out):
    """The filters kernel's validity recount into ``out`` ((H - 12) * (W -
    12) u8, flat) over the candidates of ``region`` (vy0, vx0, vh, vw): tiles
    of TILE_ROWS x 32 TILE_WORDS candidates; a tile's window of the mask
    staged as "rem == 0" words (set past the image), each row's 13-wide runs
    from a pair of words as one uint64, the AND of 13 run rows; then each
    tile row's bytes through the 4-byte words of ``out`` it meets, only
    those inside the tile row written."""
    h, w = rem.shape
    n_cx = w - 2 * M.WHALF
    vy0, vx0, vh, vw = region
    cols = 32 * TILE_WORDS
    ys_off = np.arange(TILE_ROWS + K - 1)
    xs_off = np.arange(32 * (TILE_WORDS + 1))
    for cy0 in range(vy0, vy0 + vh, TILE_ROWS):
        for cx0 in range(vx0, vx0 + vw, cols):
            ys, xs = cy0 + ys_off, cx0 + xs_off
            zero = np.ones((ys.size, xs.size), bool)
            inside = (ys < h)[:, None] & (xs < w)[None, :]
            zero[inside] = (rem[np.minimum(ys, h - 1)][:, np.minimum(xs, w - 1)] == 0)[inside]
            known = ballot_words(zero).astype(np.uint64)
            runs = run13(known[:, :-1] | (known[:, 1:] << np.uint64(32))) & np.uint64(0xFFFFFFFF)
            ok = np.bitwise_and.reduce(np.stack([runs[k : k + TILE_ROWS] for k in range(K)]), 0)
            n = min(cols, vx0 + vw - cx0)
            for r in range(TILE_ROWS):
                if cy0 + r >= vy0 + vh:
                    continue
                bits = sum(int(ok[r, i]) << (32 * i) for i in range(TILE_WORDS))
                start = (cy0 + r) * n_cx + cx0
                for q in range(cols // 4 + 1):
                    at = (start & ~3) + 4 * q
                    for i in range(4):
                        c = at + i - start
                        if 0 <= c < n:
                            out[at + i] = bits >> c & 1
    return out


@pytest.mark.parametrize("shape,box", [((60, 70), (20, 33, 0, 37)), ((60, 70), (14, 23, 26, 0)),
                                       ((60, 70), (60, 70, 0, 0)), ((45, 140), (40, 100, 5, 40)),
                                       ((77, 90), (9, 12, 68, 78))])
def test_validity_tiles_twin_equals_validity(shape, box):
    """Regions at the image's top, left, bottom and right edges, the whole
    image, and regions of several tiles: the region's map equals
    ``_validity`` and nothing outside it is written."""
    h, w = shape
    rem, _, _ = random_state(3, h, w, box, 0.4)
    rem[: h // 2 + 4, : w // 2] = 0.0  # some valid windows in every region
    rem[-9:, :20] = 0.0
    region = kfill.validity_region(h, w, box)
    vy0, vx0, vh, vw = region
    out = np.full((h - K + 1) * (w - K + 1), 7, np.uint8)
    got = twin_validity(rem, region, out).reshape(h - K + 1, w - K + 1)
    want = np.full_like(got, 7)
    want[vy0 : vy0 + vh, vx0 : vx0 + vw] = M._validity(torch.from_numpy(rem)).numpy()[
        vy0 : vy0 + vh, vx0 : vx0 + vw]
    np.testing.assert_array_equal(got, want)
    assert (got[vy0 : vy0 + vh, vx0 : vx0 + vw] == 1).any()
    assert (got[vy0 : vy0 + vh, vx0 : vx0 + vw] == 0).any()


def twin_filter_rows(m, b):
    """The filters kernel's rows of one target from its staged window, m
    (169,) and b (3, 169) f32: lane l's columns 4 l .. 4 l + 3 of each row,
    column 9 kx + j = scale_j * m, or -2 (b m) for the planes j >= 6, and 0
    past column 116.  → (13, 128) f32."""
    rows = np.zeros((K, 128), np.float32)
    for col in range(128):
        kx, j = divmod(col, 9)
        if col >= 9 * K:
            continue
        scale = np.float32(256.0 if j < 3 else 1.0 if j < 6 else -2.0)
        for ky in range(K):
            mm = m[ky * K + kx]
            rows[ky, col] = scale * (b[j - 6, ky * K + kx] * mm if j >= 6 else mm)
    return rows


def test_filter_rows_twin_equals_target_filters():
    img, rem, _, _, _ = case("border", True)
    h, w = rem.shape
    ty = torch.tensor([0, 3, 30, 59, 59, 12])
    tx = torch.tensor([0, 69, 35, 0, 69, 55])
    filt, _ = M._target_filters(torch.from_numpy(img).float(), torch.from_numpy(rem), ty, tx, h,
                                w, True)
    pad = np.pad(img.astype(np.float32), [(6, 6), (6, 6), (0, 0)])
    rp = np.pad(rem, 6, constant_values=1.0)  # outside the image m = 0
    for i in range(ty.shape[0]):
        y, x = int(ty[i]), int(tx[i])
        m = (rp[y : y + K, x : x + K] == 0).astype(np.float32).reshape(-1)
        b = pad[y : y + K, x : x + K].transpose(2, 0, 1).reshape(3, -1)
        rows = twin_filter_rows(m, b)
        np.testing.assert_array_equal(rows[:, : 9 * K].view(np.uint32),
                                      filt[:, i].numpy().view(np.uint32))
        assert not rows[:, 9 * K :].view(np.uint32).any()


def twin_commit_planes(p, img, ty, tx, sy, sx):
    """The commit kernel's scatter: each target's new pixel (its pick's)
    rewrites p[ty, tx − kx, 9·kx + j] for the kx with 0 ≤ tx − kx < n_cx."""
    p = p.copy()
    n_cx = p.shape[1]
    for y, x, py, px in zip(ty, tx, sy, sx):
        a = img[py, px].astype(np.float32)
        sq = a * a
        hi = np.floor(sq * np.float32(1.0 / 256.0))
        planes = np.concatenate([hi, sq - hi * np.float32(256.0), a])
        for kx in range(K):
            if 0 <= x - kx < n_cx:
                p[y, x - kx, 9 * kx : 9 * kx + 9] = planes
    return p


@pytest.mark.parametrize("seed,max_value", [(0, 255), (1, 127), (2, 255)])
def test_commit_scatter_twin_equals_build_p117_of_the_committed_image(seed, max_value):
    rng = np.random.default_rng(seed)
    h, w = 31, 47
    img = rng.integers(0, max_value + 1, (h, w, 3)).astype(np.float32)
    p = np.asarray(M._build_p117(torch.from_numpy(img), w).float())
    n = 40
    # picks: centres of candidate windows; targets: other pixels, distinct
    interior = np.flatnonzero(np.pad(np.ones((h - 12, w - 12), bool), 6).reshape(-1))
    picks = rng.choice(interior, n, replace=False)
    targets = rng.choice(np.setdiff1d(np.arange(h * w), picks), n, replace=False)
    ty, tx, sy, sx = targets // w, targets % w, picks // w, picks % w
    committed = img.copy()
    committed[ty, tx] = img[sy, sx]
    want = M._build_p117(torch.from_numpy(committed), w).float().numpy()
    np.testing.assert_array_equal(twin_commit_planes(p, img, ty, tx, sy, sx), want)
    # and the plain commit, fed the same picks as search keys (e = 1, weight 1)
    fp = M._FillPass(torch.from_numpy(img), torch.zeros((h, w)), torch.ones((h, w)), h, w,
                     False, 64, (h, w, 0, 0), None, "torch")
    fp.tyx[0, :n], fp.tyx[1, :n] = torch.from_numpy(ty), torch.from_numpy(tx)
    n_cx = w - 2 * M.WHALF
    flat = torch.from_numpy((sy - M.WHALF) * n_cx + (sx - M.WHALF)).to(torch.int32)
    fp.keys[:n] = kws.encode_keys(torch.ones(n), flat)
    fp.state[kfill.ACTIVE], fp.state[kfill.COUNT] = 1, n
    fp.commit()
    np.testing.assert_array_equal(fp.p[..., : 9 * K].float().numpy(), want)
    np.testing.assert_array_equal(fp.img.numpy(), committed)
    assert float(fp.state.view(torch.float32)[kfill.ENERGY]) == n
    assert int(fp.state[kfill.FAIL]) == 0


def test_commit_fails_the_iteration_when_a_target_finds_no_candidate():
    h, w = 20, 20
    img = texture((h, w)).astype(np.float32)
    fp = M._FillPass(torch.from_numpy(img), torch.zeros((h, w)), torch.ones((h, w)), h, w,
                     False, 16, (h, w, 0, 0), None, "torch")
    fp.tyx[0, :3], fp.tyx[1, :3] = torch.tensor([1, 2, 3]), torch.tensor([4, 5, 6])
    fp.keys[0] = kws.encode_keys(torch.tensor([3.0]), torch.tensor([0], dtype=torch.int32))
    fp.state[kfill.ACTIVE], fp.state[kfill.COUNT] = 1, 3  # keys 1 and 2 untouched: +inf
    fp.commit()
    assert int(fp.state[kfill.FAIL]) == 1 and float(fp.energy()) == -1.0
    np.testing.assert_array_equal(fp.img.numpy(), img)
    assert float(fp.state.view(torch.float32)[kfill.ENERGY]) == 0.0


def twin_warp_b2(x):
    """The filters kernel's b2 of one target: lane l holds x[l + 32 i] for
    i < 16; halve over i (v[i] + v[i + h], h = 8 .. 1), then shuffle-down
    adds at offsets 16 .. 1; lane 0's value."""
    v = x.reshape(16, 32).copy()  # v[i, l] = x[l + 32 i]
    for h in (8, 4, 2, 1):
        v[:h] = v[:h] + v[h : 2 * h]
    s = v[0].copy()
    for off in (16, 8, 4, 2, 1):
        s[:32 - off] = s[:32 - off] + s[off:]
    return s[0]


def test_b2_warp_tree_twin_equals_tree_sum():
    rng = np.random.default_rng(5)
    for _ in range(50):
        b = rng.integers(0, 256, 507).astype(np.float32)
        m = (rng.random(507) < 0.8).astype(np.float32)
        x = np.zeros(512, np.float32)
        x[:507] = (b * m) * b
        got = M._tree_sum(torch.from_numpy(x[:507])[None], 512)[0]
        assert twin_warp_b2(x).view(np.uint32) == got.numpy().view(np.uint32)


def test_target_filters_layout_and_b2_order():
    """The target-major filters are the search's (13, 117, T) filters
    transposed; b2 is ``_tree_sum`` over the (c, ky, kx) products."""
    img, rem, _, _, _ = case("square", True)
    h, w = rem.shape
    rng = np.random.default_rng(8)
    ty = torch.from_numpy(rng.integers(0, h, 37))
    tx = torch.from_numpy(rng.integers(0, w, 37))
    filt, b2 = M._target_filters(torch.from_numpy(img).float(), torch.from_numpy(rem), ty, tx,
                                 h, w, True)
    f13, valid, b2_s = M._search_filters(torch.from_numpy(img).float(), torch.from_numpy(rem),
                                         ty, tx, h, w, True)
    assert filt.shape == (K, 37, 9 * K) and f13.is_contiguous()
    assert torch.equal(filt.permute(0, 2, 1).to(torch.bfloat16), f13) and torch.equal(b2, b2_s)
    want_valid = np.array([[not rem[cy : cy + K, cx : cx + K].any() for cx in range(w - K + 1)]
                           for cy in range(h - K + 1)])
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    pad = np.pad(img.astype(np.float32), [(6, 6), (6, 6), (0, 0)])
    rp = np.pad(rem, 6)
    for i in range(37):
        y, x = int(ty[i]), int(tx[i])
        bb = pad[y : y + K, x : x + K].transpose(2, 0, 1)            # (c, ky, kx)
        yy, xx = np.mgrid[y - 6 : y + 7, x - 6 : x + 7]
        m = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w) & (rp[y : y + K, x : x + K] == 0))
        prods = ((bb * m.astype(np.float32)) * bb).reshape(-1)
        want = M._tree_sum(torch.from_numpy(prods)[None], 512)[0]
        assert b2[i].numpy().view(np.uint32) == want.numpy().view(np.uint32)


# -- routing ------------------------------------------------------------------

def test_cuda_route_on_cpu_tensors_raises():
    img, rem, weight, box, _ = case("square", True)
    h, w = rem.shape
    bh, bw, by0, bx0 = box
    with pytest.raises(ValueError, match="CUDA tensor"):
        M._fill_pass_device(torch.from_numpy(img), torch.from_numpy(rem),
                            torch.from_numpy(weight), h, w, True, bbox_size=(bh, bw),
                            bbox_origin=(by0, bx0), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        M._alt_init_device(torch.from_numpy(img), torch.from_numpy(rem), h, w, (bh, bw),
                           (by0, bx0), False, impl="cuda")
    fp = plain_pass(img, rem, weight, box, None, True, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kfill.ring_pick_launcher(fp.rem, fp.rem0, None, fp.tyx, fp.keys, fp.state, box, True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kfill.filters_launcher(fp.img, fp.rem, fp.tyx, fp.state, fp.f, fp.b2, fp.valid, box,
                               True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kfill.commit_launcher(fp.img, fp.rem, fp.p, fp.keys, fp.b2, fp.tyx, fp.weight, fp.state)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kfill.diffusion(torch.from_numpy(img), torch.from_numpy(rem), box, False, 1 / 9)


def pack_keys(energies, indices):
    """tests/test_torch_wexler_search.py's packing of the kernel's keys."""
    bits = (np.asarray(energies, np.float32) + np.float32(0.0)).view(np.uint32)
    ordered = np.where(bits & np.uint32(0x80000000), ~bits, bits | np.uint32(0x80000000))
    keys = (ordered.astype(np.uint64) << np.uint64(32)) | np.asarray(indices, np.uint64)
    return keys.view(np.int64)


def test_encode_keys_packs_as_the_kernel_and_inverts_decode_keys():
    energies = np.array([-3.3e7, -5.5, -0.0, 0.0, 123456.0, 3.3e7, np.inf], np.float32)
    indices = np.array([1, 2, 3, 4, 268319, 0, 9], np.int32)
    keys = kws.encode_keys(torch.from_numpy(energies), torch.from_numpy(indices))
    np.testing.assert_array_equal(keys.numpy()[:6], pack_keys(energies[:6], indices[:6]))
    assert int(keys[6]) == -1  # no valid candidate: the untouched key
    emin, idx = kws.decode_keys(keys, 7)
    np.testing.assert_array_equal(emin.numpy(), energies + np.float32(0.0))
    assert idx.tolist() == [1, 2, 3, 4, 268319, 0, 0]


@pytest.mark.parametrize("initial", [False, True])
def test_image_smaller_than_the_window_fails_a_hole_and_keeps_an_empty_one(initial):
    """No candidate window fits a 10x20 image: a pass with a hole fails
    (−1, as every search would), one without returns the image and 0; an
    inpaint of an empty mask returns the image unchanged."""
    img = texture((10, 20))
    hole = np.zeros((10, 20), np.float32)
    weight = np.zeros((10, 20), np.float32)
    args = (torch.from_numpy(img), torch.from_numpy(hole), torch.from_numpy(weight), 10, 20,
            initial)
    out, energy = M._fill_pass_device(*args)
    assert float(energy) == 0.0 and torch.equal(out, torch.from_numpy(img))
    hole[4, 5] = 1.0
    _, energy = M._fill_pass_device(*args)
    assert float(energy) == -1.0
    out = vt.inpainting_wexler(img, np.zeros((10, 20), np.uint8), device="cpu")
    np.testing.assert_array_equal(out.numpy(), img)


def test_inpaint_module_takes_the_plain_pieces_on_the_cpu():
    img, mask = stripes(72, 40, 220), np.zeros((72, 72), np.uint8)
    mask[30:38, 30:38] = 255
    M.plain_pieces = 0
    out = vt.inpainting_wexler(img, mask, device="cpu", impl="torch")
    assert M.plain_pieces > 0
    np.testing.assert_array_equal(out.numpy(), vt.inpainting_wexler(img, mask,
                                                                    device="cpu").numpy())
