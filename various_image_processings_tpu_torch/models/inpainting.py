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
levels crop the pyrUp output).

As in the JAX package, each fill pass is a device program with no host read
inside it.  An iteration is four pieces (``_FillPass``): ring pick, target
filters, search, commit; on the card each is one hand-written kernel
(``csrc/wexler_fill.cu``, ``csrc/wexler_search.cu``) and the loop body holds
no torch op.  The host enqueues iterations without looking: an energy pass
has ⌈hole / cap⌉ of them (each takes min(cap, remaining) targets), and the
energy loop enqueues all its passes, the stop and commit decided on the
device; an onion-peel pass reads its active flag every ``SYNC_EVERY``
iterations.  An iteration past the last ring, a failure or a stop changes
nothing.  The diffusion start of the beam is one kernel a branch.  Off the
card every piece runs its plain version on the same schedule.
``host_syncs`` counts every device-to-host read of a fill.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from torch import nn

from ..core.pad import replicate_pad, round_up
from ..ops import _validate
from ..ops._dispatch import check_impl, resolve_impl
from ..ops.cuda import wexler_fill as kfill
from ..ops.cuda import wexler_search as kws
from ..ops.cuda.wexler_search import K_PAD, TARGET_TILE
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
SYNC_EVERY = 8            # onion-peel iterations between two reads of the active flag

# device-to-host reads made by fills since the last reset: the mask
# pyramid's download, an onion-peel pass's active flag every SYNC_EVERY
# iterations and its energy (energy passes read nothing), and what the
# verbose log and checkpoints print or save
host_syncs = 0
plain_pieces = 0  # fill-loop pieces (and diffusion starts) that took the plain version


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
    [bx0−12, bx0+bw).  The JAX package's strip re-pack; the fill loop's
    commit rewrites only the entries its targets feed instead."""
    n_cx = width - 2 * WHALF
    uw = min(bw + 2 * WHALF, n_cx)
    ux0 = min(max(bx0 - 2 * WHALF, 0), n_cx - uw)
    strip = image_f[by0 : by0 + bh, ux0 : ux0 + uw + 2 * WHALF]
    p117[by0 : by0 + bh, ux0 : ux0 + uw] = _pack_planes(strip, uw)
    return p117


def _tree_sum(x: torch.Tensor, size: int) -> torch.Tensor:
    """Σ over the last axis of ``x`` in the kernels' fixed order: zero-padded
    to ``size`` (a power of two), then halved, x[:h] + x[h:], down to one
    element.  Elementwise adds, so every device gives the same bits."""
    x = F.pad(x, (0, size - x.shape[-1]))
    while size > 1:
        size //= 2
        x = x[..., :size] + x[..., size:]
    return x[..., 0]


def _validity(remained: torch.Tensor) -> torch.Tensor:
    """(n_cy, n_cx) bool: candidate windows with no remaining pixel (a box
    sum of the 0/1 mask, exact below 2²⁴ pixels)."""
    k = WINDOW_SIZE
    ii = F.pad(torch.cumsum(torch.cumsum(remained, 0), 1), (1, 0, 1, 0))
    return (ii[k:, k:] - ii[k:, :-k] - ii[:-k, k:] + ii[:-k, :-k]) == 0


def _target_filters(image_f, remained, ty, tx, height, width, initial: bool):
    """The search's target side for targets (ty, tx) (T,) int64.
    image_f: (H, W, 3) f32 integer-valued; remained: (H, W) f32, 1 = hole.
    Returns (filters (13, T, 117) f32, target-major: entry (ky, t, 9·kx + j)
    is 256·m, m or −2·m·b of plane j — hi, lo, a of channel j % 3 — at tap
    (ky, kx); b2 (T,) f32 = Σ m b² as a halving tree over the 507 products
    in (c, ky, kx) order, zero-padded to 512), so that a target's energy at
    candidate c is E'[c] + b2."""
    t = ty.shape[0]
    k = WINDOW_SIZE
    img_pad = F.pad(image_f, (0, 0, WHALF, WHALF, WHALF, WHALF))
    rem_pad = F.pad(remained, (WHALF, WHALF, WHALF, WHALF))
    taps = torch.arange(k, device=image_f.device)
    ys = (ty[:, None] + taps)[:, :, None]              # centre → padded top-left
    xs = (tx[:, None] + taps)[:, None, :]
    b = img_pad[ys, xs]                                # (T, ky, kx, c)
    dy = taps - WHALF
    in_y = (ty[:, None] + dy >= 0) & (ty[:, None] + dy < height)
    in_x = (tx[:, None] + dy >= 0) & (tx[:, None] + dy < width)
    m = in_y[:, :, None] & in_x[:, None, :]
    if initial:
        m = m & (rem_pad[ys, xs] == 0)  # skip the target's own unknown pixels (:244-246)
    m = m.to(torch.float32)[..., None].expand(t, k, k, 3)
    b_masked = b * m
    b2 = _tree_sum((b_masked * b).permute(0, 3, 1, 2).reshape(t, 3 * k * k), 512)
    # E'[t, c] = Σ m a² − 2 Σ m b a, with a² = 256·hi + lo riding the planes;
    # every filter entry (256·m, m, −2·m·b) has ≤ 8 significant bits
    filt = torch.cat([m * 256.0, m, -2.0 * b_masked], dim=3)   # (T, ky, kx, 9)
    return filt.permute(1, 0, 2, 3).reshape(k, t, k * 9), b2


def _search_filters(image_f, remained, ty, tx, height, width, initial: bool):
    """``_target_filters`` in the search's (13, 117, T) bf16 layout, with the
    candidate validity map: (f13, valid (n_cy, n_cx) bool, b2 (T,) f32)."""
    filt, b2 = _target_filters(image_f, remained, ty, tx, height, width, initial)
    f13 = filt.permute(0, 2, 1).to(torch.bfloat16).contiguous()
    return f13, _validity(remained), b2


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


class _FillPass:
    """The buffers of one fill pass and the four pieces of its iteration:
    ``ring_pick``, ``filters``, ``search`` and ``commit``.  On the card
    (route ``cuda``) each piece is one kernel launch (``ops/cuda/
    wexler_fill.py``, ``ops/cuda/wexler_search.py``) and the host reads
    nothing; elsewhere each runs its plain version, the same function in
    torch ops, which reads nothing back either.

    Buffers, made once a pass: the image (H, W, 3) f32 and the remaining
    mask (H, W) f32 (1 = hole), each with one element past its end where the
    plain commit drops its masked writes; the candidate planes ``p``
    (H, n_cx, 128) bf16 with one element more, the filters ``f``
    (13, Tp, 128) bf16 target-major, ``b2`` (cap,) f32, the validity map
    (n_cy, n_cx) u8, the search's keys (Tp,) int64, the targets ``tyx``
    (2, cap) int32, and ``state`` (``STATE_SIZE``,) int32: active, fail, live,
    count, energy (f32 bits), iterations run.  Every piece after the ring
    pick changes nothing where active is 0; the ring pick clears active once
    the pass failed or ``live`` is 0 (the energy loop stopped)."""

    def __init__(self, img_f, rem_f, weight, height, width, initial: bool, cap: int,
                 box: tuple, island, route: str, live=None):
        dev = img_f.device
        self.height, self.width = height, width
        self.n_cy, self.n_cx = height - 2 * WHALF, width - 2 * WHALF
        self.box, self.initial, self.cap, self.route = box, initial, cap, route
        self.island = None if island is None else island.to(torch.float32).contiguous()
        self.rem0 = rem_f.contiguous()
        self.weight = weight.to(torch.float32).contiguous()
        hw = height * width
        self._img = torch.empty((hw + 1) * 3, dtype=torch.float32, device=dev)
        self.img = self._img[: hw * 3].view(height, width, 3)
        self.img.copy_(img_f)
        self._rem = torch.empty(hw + 1, dtype=torch.float32, device=dev)
        self.rem = self._rem[:hw].view(height, width)
        self.rem.copy_(rem_f)
        n_p = height * self.n_cx * K_PAD
        self._p = torch.zeros(n_p + 1, dtype=torch.bfloat16, device=dev)
        self.p = self._p[:n_p].view(height, self.n_cx, K_PAD)
        self.p[..., : 9 * WINDOW_SIZE] = _build_p117(self.img, width)
        tp = round_up(cap, TARGET_TILE)
        self.f = torch.zeros((WINDOW_SIZE, tp, K_PAD), dtype=torch.bfloat16, device=dev)
        self.b2 = torch.zeros(cap, dtype=torch.float32, device=dev)
        self.valid = _validity(self.rem).to(torch.uint8)
        self.keys = torch.full((tp,), -1, dtype=torch.int64, device=dev)
        self.tyx = torch.zeros((2, cap), dtype=torch.int32, device=dev)
        self.state = torch.zeros(kfill.STATE_SIZE, dtype=torch.int32, device=dev)
        self.state[kfill.LIVE] = 1 if live is None else live
        if route == "cuda":  # the kernels, bound to these buffers once
            self._launch = {
                "ring_pick": kfill.ring_pick_launcher(self.rem, self.rem0, self.island, self.tyx,
                                                      self.keys, self.state, box, initial),
                "filters": kfill.filters_launcher(self.img, self.rem, self.tyx, self.state,
                                                  self.f, self.b2, self.valid, box, initial),
                "search": kws.launcher(self.p, self.f, self.valid, self.keys, self.n_cy,
                                       active=self.state[kfill.ACTIVE]),
                "commit": kfill.commit_launcher(self.img, self.rem, self.p, self.keys, self.b2,
                                                self.tyx, self.weight, self.state),
            }

    def _box(self):
        bh, bw, by0, bx0 = self.box
        return slice(by0, by0 + bh), slice(bx0, bx0 + bw)

    def iteration(self) -> None:
        self.ring_pick()
        self.filters()
        self.search()
        self.commit()

    def energy(self) -> torch.Tensor:
        """The pass's energy, 0-d f32: −1.0 where a search failed."""
        energy = self.state.view(torch.float32)[kfill.ENERGY]
        return torch.where(self.state[kfill.FAIL] != 0, -1.0, energy)

    # -- the pieces ----------------------------------------------------------

    def ring_pick(self) -> None:
        """The iteration's targets, count and active flag (JAX :446-488 and
        the loop's cond :503-506): the first cap ring pixels of the box in
        raster order, padded with the box origin; keys reset to all ones."""
        if self.route == "cuda":
            self._launch["ring_pick"]()
            return
        global plain_pieces
        plain_pieces += 1
        bh, bw, by0, bx0 = self.box
        cap, st = self.cap, self.state
        box = self._box()
        rem_box = self.rem[box]
        if not self.initial:
            # energy passes re-fill pixels whose values exist from the
            # previous pass: all remaining pixels, in raster chunks of cap
            # (the Jacobi-style update of Wexler et al.'s EM iteration)
            ring = rem_box > 0
        elif self.island is None:
            ring = _boundary_ring(rem_box, bh, bw)
        else:
            # known islands inside the hole: seed only from border-connected
            # known pixels and pixels filled in this pass, so the fill
            # advances outside-in; a hole component enclosed by an island
            # has no such seed, so fall back to the unrestricted ring
            filled = (self.rem0[box] > 0) & (rem_box == 0)
            seed = ((rem_box == 0) & (filled | (self.island[box] == 0))).to(torch.float32)
            ring_r = _boundary_ring(rem_box, bh, bw, seed=seed)
            ring = torch.where(ring_r.any(), ring_r, _boundary_ring(rem_box, bh, bw))
        flat = ring.reshape(-1)
        pos = torch.cumsum(flat, 0) - 1
        dest = torch.where(flat & (pos < cap), pos, cap)
        box_pixels = torch.arange(bh * bw, device=flat.device)
        picked = torch.zeros(cap + 1, dtype=torch.int64, device=flat.device)
        picked = picked.scatter_(0, dest, box_pixels)[:cap]
        tyx = torch.stack([picked // bw + by0, picked % bw + bx0]).to(torch.int32)
        count = torch.clamp(flat.sum(), max=cap).to(torch.int32)
        go = (st[kfill.LIVE] != 0) & (st[kfill.FAIL] == 0)
        active = go & (count > 0)
        self.tyx.copy_(torch.where(go, tyx, self.tyx))
        self.keys.copy_(torch.where(go, -1, self.keys))
        st[kfill.COUNT] = torch.where(go, count, st[kfill.COUNT])
        st[kfill.ITERATIONS] += active.to(torch.int32)
        st[kfill.ACTIVE] = active.to(torch.int32)

    def filters(self) -> None:
        """The targets' filters into ``f``, b2, and the validity map
        recounted over the candidates whose window meets the box
        (JAX :275-340)."""
        if self.route == "cuda":
            self._launch["filters"]()
            return
        global plain_pieces
        plain_pieces += 1
        cap = self.cap
        active = self.state[kfill.ACTIVE] != 0
        ty, tx = self.tyx.to(torch.int64)
        filt, b2 = _target_filters(self.img, self.rem, ty, tx, self.height, self.width,
                                   self.initial)
        f = self.f[:, :cap, : 9 * WINDOW_SIZE]
        f.copy_(torch.where(active, filt.to(torch.bfloat16), f))
        self.b2.copy_(torch.where(active, b2, self.b2))
        vy0, vx0, vh, vw = kfill.validity_region(self.height, self.width, self.box)
        k = WINDOW_SIZE
        region = self.rem[vy0 : vy0 + vh + k - 1, vx0 : vx0 + vw + k - 1]
        valid = self.valid[vy0 : vy0 + vh, vx0 : vx0 + vw]
        valid.copy_(torch.where(active, _validity(region).to(torch.uint8), valid))

    def search(self) -> None:
        """Each target's least energy and first candidate reaching it, as the
        keys of ``ops/cuda/wexler_search.py``."""
        if self.route == "cuda":
            self._launch["search"]()
            return
        cap = self.cap
        emin, idx = search_min(self.p[..., : 9 * WINDOW_SIZE],
                               self.f[:, :cap, : 9 * WINDOW_SIZE].transpose(1, 2),
                               self.valid.bool(), impl="torch")
        keys = self.keys[:cap]
        keys.copy_(torch.where(self.state[kfill.ACTIVE] != 0, kws.encode_keys(emin, idx), keys))

    def commit(self) -> None:
        """The iteration's fill (JAX :491-501): the pass fails where a valid
        target got +inf; otherwise each target takes its pick's pixel (read
        from the ring-start image: a pick lies in a valid window, so it is
        never a target), leaves the hole, and rewrites the 13 × 9 entries
        p[ty, tx − kx, 9·kx + j] its pixel feeds; Σ e·weight is added to the
        energy as a halving tree over the cap slots."""
        if self.route == "cuda":
            self._launch["commit"]()
            return
        global plain_pieces
        plain_pieces += 1
        cap, st, n_cx = self.cap, self.state, self.n_cx
        active = st[kfill.ACTIVE] != 0
        emin, idx = kws.decode_keys(self.keys, cap)
        slots = torch.arange(cap, device=emin.device)
        target = active & (slots < st[kfill.COUNT])
        e = torch.where(target, emin + self.b2, 0.0)
        fail_now = torch.any(target & ~torch.isfinite(e))
        do = target & ~fail_now
        ty, tx = self.tyx.to(torch.int64)
        idx = idx.to(torch.int64)
        vals = self.img[idx // n_cx + WHALF, idx % n_cx + WHALF]          # (cap, 3)
        hw = self.height * self.width
        at = torch.where(do, ty * self.width + tx, hw)                     # hw: dropped
        self._img.view(-1, 3).index_put_((at,), vals)
        self._rem.index_put_((at,), torch.zeros_like(e))
        sq = vals * vals
        hi = torch.floor(sq * (1.0 / 256.0))
        planes = torch.cat([hi, sq - hi * 256.0, vals], dim=1).to(torch.bfloat16)  # (cap, 9)
        kx = torch.arange(WINDOW_SIZE, device=e.device)
        xp = tx[:, None] - kx                                              # (cap, 13)
        ok = do[:, None] & (xp >= 0) & (xp < n_cx)
        at = ((ty[:, None] * n_cx + xp) * K_PAD + 9 * kx)[:, :, None] + torch.arange(
            9, device=e.device)
        at = torch.where(ok[:, :, None], at, self.p.numel())               # the dropped slot
        self._p.index_put_((at.reshape(-1),),
                           planes[:, None, :].expand(cap, WINDOW_SIZE, 9).reshape(-1))
        w = torch.where(do, e * self.weight[ty, tx], 0.0)
        energy = st.view(torch.float32)[kfill.ENERGY]
        total = energy + _tree_sum(w, max(32, 1 << (cap - 1).bit_length()))
        st.view(torch.float32)[kfill.ENERGY] = torch.where(active, total, energy)
        st[kfill.FAIL] |= fail_now.to(torch.int32)


def _pass_core(img_f, rem_f, weight, height, width, initial: bool, cap: int,
               bbox_size, bbox_origin, island=None, impl: str = "auto", live=None,
               n_iter: int | None = None):
    """One exemplar_based_inpainting pass (reference :271-322) over f32
    state: each iteration fills ≤ cap targets.  Returns (filled f32 image,
    energy f32 — −1.0 on search failure, when the fill must be discarded).

    bbox_size, bbox_origin: the hole's bucketed box
    (``WexlerInpainting._hole_bbox``), or None for the whole image.  The hole
    never grows, so the ring runs on the box.  live: a 0-d bool on the
    image's device, False to make every iteration a no-op (the energy loop
    stopped); n_iter: an energy pass's iteration count, ⌈remaining / cap⌉ —
    read from the device when None.

    The schedule (the JAX package's while_loop without its per-iteration
    cond on the host): an energy pass runs n_iter iterations and reads
    nothing; an onion-peel pass reads the active flag every ``SYNC_EVERY``
    iterations.  Iterations past the last ring, a failure or a stop change
    nothing."""
    route = resolve_impl(impl, img_f)
    rem_f = rem_f.to(torch.float32)
    if bbox_size is None:
        (bh, bw), (by0, bx0) = (height, width), (0, 0)
    else:
        (bh, bw), (by0, bx0) = bbox_size, bbox_origin
    if height < WINDOW_SIZE or width < WINDOW_SIZE:
        # no candidate window: any hole in the box fails its first search
        hole = (rem_f[by0 : by0 + bh, bx0 : bx0 + bw] > 0).any()
        return img_f.clone(), torch.where(hole, -1.0, torch.zeros((), device=img_f.device))
    fp = _FillPass(img_f, rem_f, weight, height, width, initial, cap, (bh, bw, by0, bx0),
                   island, route, live)
    if not initial:
        if n_iter is None:
            n_iter = -(-int(_host((fp.rem[fp._box()] > 0).sum())) // cap)
        for _ in range(n_iter):
            fp.iteration()
    else:
        it = 0
        while True:
            fp.ring_pick()
            if it and it % SYNC_EVERY == 0 and not _host(fp.state[kfill.ACTIVE]):
                break
            fp.filters()
            fp.search()
            fp.commit()
            it += 1
    return fp.img, fp.energy()


def _fill_pass_device(image_u8, remained0, weight, height, width, initial: bool,
                      cap: int = RING_CAP, bbox_size=None, bbox_origin=(0, 0),
                      island=None, impl: str = "auto"):
    """One pass, u8 in/out (see _pass_core)."""
    img_f, energy = _pass_core(image_u8.to(torch.float32), remained0.to(torch.float32),
                               weight, height, width, initial, cap, bbox_size, bbox_origin,
                               island, impl)
    return torch.clamp(img_f, 0.0, 255.0).to(torch.uint8), energy


def _energy_loops_device(image_u8, remained0, weight, height, width, max_loop: int,
                         nhole: int, cap: int = RING_CAP, bbox_size=None, bbox_origin=(0, 0),
                         impl: str = "auto"):
    """The per-level energy-minimisation loop (reference :40-50): ≤ max_loop
    non-initial passes, a pass's fill kept only when its weighted energy
    strictly fell, stopping at the first that did not or whose search
    failed.  Returns (final u8 image, energies (max_loop,) f32 — NaN for
    passes that never ran —, final committed energy — +inf when none).

    As in the JAX package the stop is decided on the device: all max_loop
    passes are enqueued, and those after the stop are no-ops.  nhole: the
    hole's pixel count (the host knows it), which fixes each pass's
    iteration count."""
    rem_f = remained0.to(torch.float32)
    dev = image_u8.device
    energies = torch.full((max_loop,), torch.nan, dtype=torch.float32, device=dev)
    img_f = image_u8.to(torch.float32)
    cur_e = torch.full((), torch.inf, dtype=torch.float32, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(max_loop):
        cand_f, e = _pass_core(img_f, rem_f, weight, height, width, False, cap, bbox_size,
                               bbox_origin, impl=impl, live=~stopped, n_iter=-(-nhole // cap))
        energies[i] = torch.where(stopped, torch.nan, e)
        stopped = stopped | (e < 0) | (cur_e <= e)
        img_f = torch.where(stopped, img_f, cand_f)
        cur_e = torch.where(stopped, cur_e, e)
    return torch.clamp(img_f, 0.0, 255.0).to(torch.uint8), energies, cur_e


def _alt_init_device(image_u8, remained0, height, width, bbox_size, bbox_origin,
                     dither: bool, impl: str = "auto"):
    """Alternative coarsest-level start for the multi-start beam: the hole
    filled by Jacobi diffusion from its boundary (bh + bw sweeps of a 3×3
    edge-padded mean over the box), with ``dither`` a deterministic ±12
    coordinate-hashed jitter on top.  On the card one kernel launch
    (``ops/cuda/wexler_fill.py::diffusion``); the plain version below."""
    bh, bw = bbox_size
    by0, bx0 = bbox_origin
    if resolve_impl(impl, image_u8) == "cuda":
        return kfill.diffusion(image_u8.contiguous(), remained0.to(torch.float32).contiguous(),
                               (bh, bw, by0, bx0), dither, float(np.float32(1.0 / 9.0)))
    global plain_pieces
    plain_pieces += 1
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
    collapsed to the lowest weighted energy.  impl: the fill's ``auto`` |
    ``torch`` | ``cuda`` (the fill-loop kernels and the search kernel, or
    their plain versions).  device: where NumPy inputs go (the GPU unless the
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
                                                             bbox[0], bbox[1], dither,
                                                             self.impl))

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
                                            impl=self.impl, nhole=nhole)
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
