"""Wexler exemplar-based inpainting.

PyTorch counterpart of ``various_image_processings_tpu/models/inpainting.py``
(reference: ``WexlerInpaintingImpl``, include/cpp/wexler_inpainting.hpp:10-332):
a coarse-to-fine Gaussian pyramid; at the coarsest level an onion-peel fill
that batches each boundary ring of the hole; at every level up to
``MAX_LOOP`` energy passes that re-fill the whole hole in raster chunks and
are kept only while the weighted energy falls.  The exemplar search of every
ring or chunk scans all candidate windows at once (``ops/wexler_search.py``:
the Hopper kernel on the card, the plain im2col product on the CPU).

The port keeps the JAX package's semantics and its documented divergences
from the sequential reference (all targets of a ring read the ring-start
image; the ring is the morphological boundary of the remaining hole, peeled
outside-in when the mask has known islands; the overflow of a ring beyond
``RING_CAP`` waits for the next iteration in raster order; candidate
rejection is global; a pass whose search fails is discarded; odd pyramid
levels crop the pyrUp output).  Its ``lax.while_loop``s become Python loops
over device tensors: each iteration reads one boolean back to the host to
decide whether to go on.  ``host_syncs`` counts those reads and every other
device-to-host transfer of a fill.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from torch import nn

from ..core.pad import replicate_pad
from ..ops import _validate
from ..ops._dispatch import check_impl
from ..ops.pyramid import pyr_down, pyr_up
from ..ops.wexler_search import search_min

WINDOW_SIZE = 13          # include/cpp/wexler_inpainting.hpp:326
WHALF = WINDOW_SIZE // 2
PYRAMID_BOTTOM_SIZE = 32  # :324
MAX_LOOP = 5              # :325
WEIGHT_BASE = 1.2         # :172
RING_CAP = 256            # max ring targets batched per iteration
ENERGY_CAP = 1024         # max targets per chunk in energy (non-initial) passes
BEAM_MAX_DIM = 128        # the multi-start beam runs on levels whose max dim is ≤ this

host_syncs = 0  # device-to-host reads made by fills since the last reset


def _host(t: torch.Tensor):
    """``t`` on the host (a Python scalar for a 0-d tensor), counted."""
    global host_syncs
    host_syncs += 1
    return t.item() if t.ndim == 0 else t.cpu().numpy()


# ---------------------------------------------------------------------------
# host-side helpers (sequential by nature in the reference)
# ---------------------------------------------------------------------------

_CHAIN = [(1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1)]
_NEXT_CODE = [7, 7, 1, 1, 3, 3, 5, 5]


def extract_mask_contour(mask: np.ndarray, start_x: int, start_y: int):
    """Freeman chain-code boundary trace (reference :94-145), as (x, y)
    pairs.  Raises instead of std::exit on malformed masks; rotates past
    out-of-bounds neighbours; a single-pixel hole yields a 1-pixel contour."""
    h, w = mask.shape
    contour = []
    code_index = 5
    cx, cy = start_x, start_y
    length = 0
    while True:
        if cx == start_x and cy == start_y and length > 0:
            break
        if length > h * w:
            raise RuntimeError("contour did not converge")
        contour.append((cx, cy))
        x = cx + _CHAIN[code_index][0]
        y = cy + _CHAIN[code_index][1]
        search = 0
        while (not (0 <= x < w and 0 <= y < h) or mask[y, x] == 0) and search < 8:
            code_index = (code_index + 1) % 8
            x = cx + _CHAIN[code_index][0]
            y = cy + _CHAIN[code_index][1]
            search += 1
        if search >= 8:
            if length == 0:
                return contour  # isolated single-pixel hole
            raise RuntimeError("next contour pixel not found")
        cx, cy = x, y
        code_index = _NEXT_CODE[code_index]
        length += 1
    return contour


def _first_masked(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    i = np.lexsort((xs, ys))[0]  # raster order
    return int(xs[i]), int(ys[i])


def calculate_weight(mask: np.ndarray) -> np.ndarray:
    """w = 1.2^(−min distance to contour) for hole pixels (reference :147-189)."""
    start = _first_masked(mask)
    if start is None:
        return mask.astype(np.float64)
    contour = np.array(extract_mask_contour(mask, *start), np.float64)  # (Nc, 2) x, y
    weight = np.zeros(mask.shape, np.float64)
    ys, xs = np.nonzero(mask)
    for i in range(0, len(ys), 4096):  # chunked exact min distance
        yb = ys[i : i + 4096].astype(np.float64)
        xb = xs[i : i + 4096].astype(np.float64)
        d2 = (xb[:, None] - contour[None, :, 0]) ** 2 + (yb[:, None] - contour[None, :, 1]) ** 2
        dmin = np.minimum(np.sqrt(d2).min(axis=1), mask.shape[0] * mask.shape[1])
        weight[ys[i : i + 4096], xs[i : i + 4096]] = WEIGHT_BASE ** (-dmin)
    return weight


def contour_with_priority(mask: np.ndarray):
    """Contour pixels sorted by priority = #known pixels in the 13×13 window,
    descending (reference :191-218); the stable sort keeps contour order on
    ties."""
    start = _first_masked(mask)
    if start is None:
        return []
    contour = extract_mask_contour(mask, *start)
    h, w = mask.shape
    ii = np.zeros((h + 1, w + 1), np.int64)
    ii[1:, 1:] = (mask == 0).astype(np.int32)
    np.cumsum(ii, axis=0, out=ii)
    np.cumsum(ii, axis=1, out=ii)

    def box(y, x):
        y0, y1 = max(y - WHALF, 0), min(y + WHALF + 1, h)
        x0, x1 = max(x - WHALF, 0), min(x + WHALF + 1, w)
        return ii[y1, x1] - ii[y1, x0] - ii[y0, x1] + ii[y0, x0]

    prio = [int(box(y, x)) for x, y in contour]
    order = np.argsort(-np.array(prio), kind="stable")
    return [contour[i] for i in order]


def _island_known(hole: np.ndarray):
    """Known pixels not 8-connected to the image border: the known islands
    of a cavity mask.  None when there are none, or when every known pixel
    is one (no outside to peel from)."""
    known = ~hole
    if known.all() or not known.any():
        return None
    lbl, _ = ndimage.label(known, structure=np.ones((3, 3), bool))
    border = np.unique(np.concatenate([lbl[0], lbl[-1], lbl[:, 0], lbl[:, -1]]))
    border = border[border > 0]
    if border.size == 0:
        return None
    island = known & ~np.isin(lbl, border)
    return island if island.any() else None


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _pack_planes(planes_src: torch.Tensor, n: int) -> torch.Tensor:
    """(h, n + 12, 3) f32 image strip → (h, n, 117) bf16: the 9 planes
    (hi, lo, a) of a² = 256·hi + lo, packed over the 13 kx taps."""
    sq = planes_src * planes_src                       # exact ints
    hi = torch.floor(sq * (1.0 / 256.0))
    lo = sq - hi * 256.0
    planes = torch.cat([hi, lo, planes_src], dim=2)    # (h, n + 12, 9)
    return torch.cat([planes[:, kx : kx + n] for kx in range(WINDOW_SIZE)],
                     dim=2).to(torch.bfloat16)


def _build_p117(image_f: torch.Tensor, width: int) -> torch.Tensor:
    """The kx-packed (H, n_cx, 117) bf16 candidate planes of an (H, W, 3)
    f32 integer-valued image.  Every entry is an integer ≤ 255, so the bf16
    cast is exact."""
    return _pack_planes(image_f, width - 2 * WHALF)


def _update_p117(p117, image_f, height, width, bh, bw, by0, bx0):
    """Refresh, in place, the p117 columns that the (bh, bw)-at-(by0, bx0)
    box of ``image_f`` feeds: image columns [bx0, bx0+bw) feed p117 columns
    [bx0−12, bx0+bw)."""
    n_cx = width - 2 * WHALF
    uw = min(bw + 2 * WHALF, n_cx)
    ux0 = min(max(bx0 - 2 * WHALF, 0), n_cx - uw)
    strip = image_f[by0 : by0 + bh, ux0 : ux0 + uw + 2 * WHALF]
    p117[by0 : by0 + bh, ux0 : ux0 + uw] = _pack_planes(strip, uw)
    return p117


def _search_filters(image_f, remained, ty, tx, height, width, initial: bool):
    """The search's target side for targets (ty, tx) (T,) int64.
    image_f: (H, W, 3) f32 integer-valued; remained: (H, W) f32, 1 = hole.
    Returns (f13 (13, 117, T) bf16 per-target filters, valid (n_cy, n_cx)
    bool candidate windows that miss the hole, b2 (T,) f32 = Σ m b²), so that
    a target's energy at candidate c is E'[c] + b2."""
    t = ty.shape[0]
    k = WINDOW_SIZE
    dev = image_f.device
    img_pad = F.pad(image_f, (0, 0, WHALF, WHALF, WHALF, WHALF))
    rem_pad = F.pad(remained, (WHALF, WHALF, WHALF, WHALF))
    taps = torch.arange(k, device=dev)
    ys = (ty[:, None] + taps)[:, :, None]               # centre → padded top-left
    xs = (tx[:, None] + taps)[:, None, :]
    patches = img_pad[ys, xs]                          # (T, 13, 13, 3)
    rems = rem_pad[ys, xs]                             # (T, 13, 13)
    dy = taps - WHALF
    in_y = (ty[:, None] + dy >= 0) & (ty[:, None] + dy < height)
    in_x = (tx[:, None] + dy >= 0) & (tx[:, None] + dy < width)
    m = in_y[:, :, None] & in_x[:, None, :]
    if initial:
        m = m & (rems == 0)  # skip the target's own unknown pixels (:244-246)
    # channel-major (c, ky, kx) flattening
    b = patches.permute(0, 3, 1, 2).reshape(t, 3 * k * k)
    mflat = m[:, None].expand(t, 3, k, k).reshape(t, 3 * k * k).to(torch.float32)

    # candidate validity: no remaining pixel in the window (box sum == 0)
    ii = F.pad(torch.cumsum(torch.cumsum(remained, 0), 1), (1, 0, 1, 0))
    valid = (ii[k:, k:] - ii[k:, :-k] - ii[:-k, k:] + ii[:-k, :-k]) == 0

    b_masked = b * mflat
    b2 = torch.sum(b_masked * b, dim=1)
    # E'[t, c] = Σ m a² − 2 Σ m b a, with a² = 256·hi + lo riding the planes;
    # every filter entry (256·m, m, −2·m·b) has ≤ 8 significant bits
    m4 = mflat.reshape(t, 3, k, k)
    filt = torch.cat([m4 * 256.0, m4, -2.0 * b_masked.reshape(t, 3, k, k)], dim=1)
    f13 = filt.permute(2, 3, 1, 0).reshape(k, k * 9, t).to(torch.bfloat16)
    return f13, valid, b2


def _ring_targets_search(image_f, p117, remained, ty, tx, tvalid, height, width,
                         initial: bool, impl: str = "auto"):
    """Exemplar search for the targets (ty, tx) (T,) int64 against all
    candidates; p117: the candidate planes of ``image_f``; tvalid: (T,)
    bool.  Returns (energy (T,) f32 — inf where no candidate, 0 where
    invalid —, best_y, best_x (T,) int64)."""
    f13, valid, b2 = _search_filters(image_f, remained, ty, tx, height, width, initial)
    emin, idx = search_min(p117, f13, valid, impl)
    n_cx = width - 2 * WHALF
    idx = idx.to(torch.int64)
    best_e = torch.where(tvalid, emin + b2, 0.0)
    return best_e, idx // n_cx + WHALF, idx % n_cx + WHALF


def _boundary_ring(rem, height, width, seed=None):
    """Hole pixels with a known 8-neighbour (the image border counts as
    known).  seed: optional f32 map of the known pixels that may seed the
    ring (1 = may); None = every known pixel."""
    known = (1.0 - rem) if seed is None else seed
    known = F.pad(known, (1, 1, 1, 1), value=1.0)
    neigh = torch.zeros((height, width), dtype=torch.float32, device=rem.device)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            neigh = torch.maximum(neigh, known[dy : dy + height, dx : dx + width])
    return (rem > 0) & (neigh > 0)


def _pass_core(img_f, rem_f, weight, height, width, initial: bool, cap: int,
               bbox_size, bbox_origin, island=None, impl: str = "auto"):
    """One exemplar_based_inpainting pass (reference :271-322) over f32
    state: each iteration peels ≤ cap targets.  Returns (filled f32 image,
    energy f32 — −1.0 on search failure, when the fill must be discarded).

    bbox_size, bbox_origin: the hole's bucketed box (``WexlerInpainting._hole_bbox``), or None
    for the whole image.  The hole never grows, so the ring and its
    compaction run on the box."""
    if bbox_size is None:
        (bh, bw), (by0, bx0) = (height, width), (0, 0)
    else:
        (bh, bw), (by0, bx0) = bbox_size, bbox_origin
    dev = img_f.device
    img_f = img_f.clone()
    rem = rem_f.clone()
    p117 = _build_p117(img_f, width)
    energy = torch.zeros((), dtype=torch.float32, device=dev)
    fail = torch.zeros((), dtype=torch.bool, device=dev)
    slots = torch.arange(cap, device=dev)
    box_pixels = torch.arange(bh * bw, device=dev)
    box = (slice(by0, by0 + bh), slice(bx0, bx0 + bw))
    while True:
        rem_box = rem[box]
        if not _host((rem_box.sum() > 0) & ~fail):
            break
        if not initial:
            # energy passes re-fill pixels whose values exist from the
            # previous pass: all remaining pixels, in raster chunks of cap
            # (the Jacobi-style update of Wexler et al.'s EM iteration)
            ring = rem_box > 0
        elif island is None:
            ring = _boundary_ring(rem_box, bh, bw)
        else:
            # known islands inside the hole: seed only from border-connected
            # known pixels and pixels filled in this pass, so the fill
            # advances outside-in; a hole component enclosed by an island
            # has no such seed, so fall back to the unrestricted ring
            filled = (rem_f[box] > 0) & (rem_box == 0)
            seed = ((rem_box == 0) & (filled | (island[box] == 0))).to(torch.float32)
            ring_r = _boundary_ring(rem_box, bh, bw, seed=seed)
            ring = torch.where(ring_r.any(), ring_r, _boundary_ring(rem_box, bh, bw))
        # the first cap ring pixels in raster order, without a host sync
        flat = ring.reshape(-1)
        pos = torch.cumsum(flat, 0) - 1
        dest = torch.where(flat & (pos < cap), pos, cap)
        picked = torch.zeros(cap + 1, dtype=torch.int64, device=dev).scatter_(0, dest, box_pixels)
        tys = picked[:cap] // bw + by0
        txs = picked[:cap] % bw + bx0
        tvalid = slots < flat.sum()
        e, sy, sx = _ring_targets_search(img_f, p117, rem, tys, txs, tvalid, height, width,
                                         initial, impl)
        fail_now = torch.any(tvalid & ~torch.isfinite(e))
        do = tvalid & ~fail_now
        # scatter the picks (read from the ring-start image) onto the targets;
        # padded and failing entries add 0, so their repeated index is harmless
        gain = (img_f[sy, sx] - img_f[tys, txs]) * do[:, None]
        img_f.index_put_((tys, txs), gain, accumulate=True)
        rem.index_put_((tys, txs), -do.to(torch.float32), accumulate=True)
        p117 = _update_p117(p117, img_f, height, width, bh, bw, by0, bx0)
        energy = energy + torch.sum(torch.where(do, e * weight[tys, txs], 0.0))
        fail = fail | fail_now
    return img_f, torch.where(fail, -1.0, energy)


def _fill_pass_device(image_u8, remained0, weight, height, width, initial: bool,
                      cap: int = RING_CAP, bbox_size=None, bbox_origin=(0, 0),
                      island=None, impl: str = "auto"):
    """One pass, u8 in/out (see _pass_core)."""
    img_f, energy = _pass_core(image_u8.to(torch.float32), remained0.to(torch.float32),
                               weight, height, width, initial, cap, bbox_size, bbox_origin,
                               island, impl)
    return torch.clamp(img_f, 0.0, 255.0).to(torch.uint8), energy


def _energy_loops_device(image_u8, remained0, weight, height, width, max_loop: int,
                         cap: int = RING_CAP, bbox_size=None, bbox_origin=(0, 0),
                         impl: str = "auto"):
    """The per-level energy-minimisation loop (reference :40-50): ≤ max_loop
    non-initial passes, a pass's fill kept only when its weighted energy
    strictly fell, stopping at the first that did not or whose search
    failed.  Returns (final u8 image, energies (max_loop,) f32 — NaN for
    passes that never ran —, final committed energy — +inf when none)."""
    rem_f = remained0.to(torch.float32)
    dev = image_u8.device
    energies = torch.full((max_loop,), torch.nan, dtype=torch.float32, device=dev)
    img_f = image_u8.to(torch.float32)
    cur_e = torch.full((), torch.inf, dtype=torch.float32, device=dev)
    for i in range(max_loop):
        cand_f, e = _pass_core(img_f, rem_f, weight, height, width, False, cap, bbox_size,
                               bbox_origin, impl=impl)
        energies[i] = e
        stop = (e < 0) | (cur_e <= e)
        img_f = torch.where(stop, img_f, cand_f)
        cur_e = torch.where(stop, cur_e, e)
        if _host(stop):
            break
    return torch.clamp(img_f, 0.0, 255.0).to(torch.uint8), energies, cur_e


def _alt_init_device(image_u8, remained0, height, width, bbox_size, bbox_origin,
                     dither: bool):
    """Alternative coarsest-level start for the multi-start beam: the hole
    filled by Jacobi diffusion from its boundary (bh + bw sweeps of a 3×3
    edge-padded mean over the box), with ``dither`` a deterministic ±12
    coordinate-hashed jitter on top."""
    bh, bw = bbox_size
    by0, bx0 = bbox_origin
    dev = image_u8.device
    img = image_u8.to(torch.float32)
    box_img = img[by0 : by0 + bh, bx0 : bx0 + bw]
    box_rem = remained0.to(torch.float32)[by0 : by0 + bh, bx0 : bx0 + bw]
    hole = (box_rem > 0)[:, :, None]
    known = 1.0 - box_rem
    mean = (box_img * known[:, :, None]).sum((0, 1)) / torch.clamp(known.sum(), min=1.0)
    cur = torch.where(hole, mean, box_img)
    ninth = torch.tensor(1.0 / 9.0, dtype=torch.float32, device=dev)
    for _ in range(bh + bw):
        p = replicate_pad(cur, 1, 1, 1, 1)
        s = torch.zeros_like(cur)
        for dy in range(3):
            for dx in range(3):
                s = s + p[dy : dy + bh, dx : dx + bw]
        cur = torch.where(hole, s * ninth, cur)
    if dither:
        yy = torch.arange(bh, device=dev)[:, None] + by0
        xx = torch.arange(bw, device=dev)[None, :] + bx0
        # the JAX package's int32 hash with wrap-around, in int64 arithmetic
        h32 = ((yy * 92837111) & 0xFFFFFFFF) ^ ((xx * 689287499) & 0xFFFFFFFF)
        jit8 = ((h32 >> 8) % 25 - 12).to(torch.float32)
        cur = torch.where(hole, cur + jit8[:, :, None], cur)
    out = img.clone()
    out[by0 : by0 + bh, bx0 : bx0 + bw] = torch.where(hole, cur, box_img)
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

class WexlerInpainting(nn.Module):
    """Wexler exemplar-based inpainting of (H, W, 3) u8 images;
    ``forward(src, mask)`` is the JAX class's ``apply``.

    checkpoint_dir: if set, the per-level state is saved after each pyramid
    level to ``wexler_state.npz`` (the JAX package's keys, so either package
    resumes the other's checkpoint) and a fill resumes from the deepest
    completed level.  multi_start: the beam width of the coarsest level's
    fill (1 disables): onion-peel exemplar fill, smooth diffusion and
    dithered diffusion, refined through the cheap ≤ BEAM_MAX_DIM levels, then
    collapsed to the lowest weighted energy.  impl: the search's ``auto`` |
    ``torch`` | ``cuda``.  device: where NumPy inputs go (the GPU unless the
    caller passes ``device="cpu"``); a tensor is filled on its own device.
    The module has no parameters or buffers."""

    def __init__(self, max_loop: int = MAX_LOOP,
                 pyramid_bottom_size: int = PYRAMID_BOTTOM_SIZE,
                 verbose: bool = False, checkpoint_dir: str | None = None,
                 multi_start: int = 3, impl: str = "auto", device="cuda"):
        super().__init__()
        check_impl(impl)
        self.device = _validate.check_device(device)
        self.max_loop = max_loop
        self.pyramid_bottom_size = pyramid_bottom_size
        self.verbose = verbose
        self.checkpoint_dir = checkpoint_dir
        self.multi_start = multi_start
        self.impl = impl

    def _log(self, *args):
        if self.verbose:
            print(*args, flush=True)

    @staticmethod
    def _hole_bbox(hole: np.ndarray):
        """((bh, bw), (by0, bx0)) of the hole's 1-margin bounding box, the size
        bucketed up to multiples of 64 (clamped to the image) and the box kept
        inside the image.  The growth keeps a margin of ≥ 1 known pixel, so the
        box's edges count as known in ``_boundary_ring``."""
        h, w = hole.shape
        ys, xs = np.nonzero(hole)
        if len(ys) == 0:
            return (min(64, h), min(64, w)), (0, 0)
        y0 = max(int(ys.min()) - 1, 0)
        y1 = min(int(ys.max()) + 2, h)
        x0 = max(int(xs.min()) - 1, 0)
        x1 = min(int(xs.max()) + 2, w)
        bh = min(-(-(y1 - y0) // 64) * 64, h)
        bw = min(-(-(x1 - x0) // 64) * 64, w)
        return (bh, bw), (min(y0, h - bh), min(x0, w - bw))

    def _construct_pyramid(self, src: torch.Tensor, mask: torch.Tensor):
        """Reference :68-91: pyrDown until the next level's floor-halved min
        dimension drops below pyramid_bottom_size.  The image pyramid stays
        on the device; the mask pyramid comes to the host in one transfer."""
        srcs, masks = [src], [mask]
        while min(srcs[-1].shape[0] // 2, srcs[-1].shape[1] // 2) >= self.pyramid_bottom_size:
            srcs.append(pyr_down(srcs[-1]))
            masks.append(pyr_down(masks[-1]))
        flat = _host(torch.cat([m.reshape(-1) for m in masks]))
        sizes = [m.numel() for m in masks]
        host = np.split(flat, np.cumsum(sizes)[:-1])
        return srcs, [h.reshape(m.shape) for h, m in zip(host, masks)]

    def _fill_pass(self, image, hole, weight, bbox, initial: bool, island=None):
        """One pass; returns (filled image, float energy — −1.0 on failure,
        when the caller keeps its current image)."""
        h, w = hole.shape
        filled, energy = _fill_pass_device(image, hole, weight, h, w, initial,
                                           bbox_size=bbox[0], bbox_origin=bbox[1],
                                           island=island, impl=self.impl)
        return filled, float(_host(energy))

    def forward(self, src, mask) -> torch.Tensor:
        """(H, W, 3) u8 image + (H, W) u8 mask (hole > 0) → (H, W, 3) u8."""
        src = _validate.as_tensor(src, self.device)
        mask = _validate.as_tensor(mask, src.device)
        if tuple(src.shape[:2]) != tuple(mask.shape):
            raise ValueError("src and mask sizes differ")
        _validate.check_u8_color("src", src)
        if mask.device != src.device:
            raise ValueError(f"mask on {mask.device}, image on {src.device}")
        if min(src.shape[:2]) < WINDOW_SIZE and bool(_host((mask > 0).any())):
            raise ValueError(f"the image must be at least {WINDOW_SIZE}x{WINDOW_SIZE} (the "
                             f"search window) to inpaint, got {tuple(src.shape[:2])}")
        dev = src.device
        srcs, masks = self._construct_pyramid(src.contiguous(), mask.contiguous())
        num_layers = len(srcs)

        do_initial = True
        start_layer = num_layers - 1
        ckpt_path = None
        if self.checkpoint_dir is not None:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            ckpt_path = os.path.join(self.checkpoint_dir, "wexler_state.npz")
            if os.path.exists(ckpt_path):
                state = np.load(ckpt_path)
                if (int(state["num_layers"]) == num_layers
                        and state["src_0"].shape == tuple(srcs[0].shape)):
                    start_layer = int(state["next_layer"])
                    do_initial = bool(state["do_initial"])
                    for i in range(num_layers):
                        srcs[i] = torch.from_numpy(state[f"src_{i}"]).to(dev)
                    self._log(f"resuming from layer {start_layer}")

        branches = None      # multi-start beam states at the current layer
        branch_layer = None  # the layer the beam was created at
        for layer in range(start_layer, -1, -1):
            self._log(f"Layer {layer}...")
            hole = masks[layer] > 0
            h, w = hole.shape
            weight = calculate_weight(hole)
            bbox = self._hole_bbox(hole)
            img = srcs[layer]
            hole_dev = torch.from_numpy(hole.astype(np.float32)).to(dev)
            weight_dev = torch.from_numpy(weight.astype(np.float32)).to(dev)
            island = _island_known(hole)
            island_dev = (None if island is None
                          else torch.from_numpy(island.astype(np.float32)).to(dev))

            if do_initial:
                filled, energy = self._fill_pass(img, hole_dev, weight_dev, bbox,
                                                 initial=True, island=island_dev)
                if energy < 0:
                    self._log(f"failed to inpaint layer {layer}")
                else:
                    img = filled
                    do_initial = False
                    if (self.multi_start > 1 and hole.any()
                            and max(hole.shape) <= BEAM_MAX_DIM):
                        branches = [img]
                        branch_layer = layer
                        for dither in (False, True)[: self.multi_start - 1]:
                            branches.append(_alt_init_device(srcs[layer], hole_dev, h, w,
                                                             bbox[0], bbox[1], dither))

            # chunk size: small holes get fine chunks (~8 a pass, pow-2
            # bucketed), large ones whole-hole chunks in multiples of 256 —
            # within a chunk the refill is Jacobi, so chunking is a quality
            # knob as well as a speed one (PARITY.md D4)
            nhole = int(hole.sum())
            if nhole <= 1024:
                ecap = 16
                while ecap * 8 < nhole:
                    ecap *= 2
            else:
                ecap = max(RING_CAP, min(ENERGY_CAP, -(-nhole // 256) * 256))
            cand_states = branches if branches is not None else [img]
            if branches is not None and layer != branch_layer and hole.any():
                # the pyramid-skip branch: a from-scratch onion-peel fill at
                # this level, competing on energy with the coarse-seeded ones
                fresh, _ = _fill_pass_device(img, hole_dev, weight_dev, h, w, True,
                                             bbox_size=bbox[0], bbox_origin=bbox[1],
                                             island=island_dev, impl=self.impl)
                cand_states = branches + [fresh]
            results = [_energy_loops_device(b, hole_dev, weight_dev, h, w,
                                            max_loop=self.max_loop, cap=ecap,
                                            bbox_size=bbox[0], bbox_origin=bbox[1],
                                            impl=self.impl)
                       for b in cand_states]
            if len(results) == 1:
                img, energies = results[0][0], results[0][1]
            else:
                # lowest final committed energy; argmin's first occurrence
                # gives the onion-peel branch (index 0) ties and all-failed +inf
                fins = torch.stack([r[2] for r in results])
                best = torch.argmin(fins).reshape(1)
                img = torch.stack([r[0] for r in results]).index_select(0, best)[0]
                energies = torch.stack([r[1] for r in results]).index_select(0, best)[0]
                if self.verbose:
                    self._log("  multi-start energies: "
                              + ", ".join(f"{float(e):.6g}" for e in _host(fins))
                              + f" -> branch {int(_host(best)[0])}")
            srcs[layer] = img
            if self.verbose:
                for i, e in enumerate(_host(energies)):
                    if np.isnan(e):
                        break
                    self._log(f"  loop {i + 1}: energy {e}")

            if layer > 0:
                # pyrUp masked copy (reference :52-57)
                out_shape = masks[layer - 1].shape[:2]
                hole_next = torch.from_numpy(masks[layer - 1] > 0).to(dev)[:, :, None]
                base_next = srcs[layer - 1]

                def lift(b):
                    return torch.where(hole_next, pyr_up(b, out_shape=out_shape), base_next)

                if branches is not None and max(out_shape) <= BEAM_MAX_DIM:
                    branches = [lift(r[0]) for r in results]  # carry the whole beam up
                else:
                    branches = None
                srcs[layer - 1] = lift(img)

            if ckpt_path is not None:
                np.savez(ckpt_path, num_layers=num_layers, next_layer=layer - 1,
                         do_initial=do_initial,
                         **{f"src_{i}": _host(srcs[i]) for i in range(num_layers)})

        return srcs[0]
