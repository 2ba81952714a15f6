"""Wrappers of the Hopper Wexler fill-loop kernels (csrc/wexler_fill.cu).

One iteration of a fill pass is the ring pick, the target filters, the
search kernel (``ops/cuda/wexler_search.py::launcher`` with the active
flag) and the commit, in that order, on the buffers of one pass
(``models/inpainting.py::_FillPass``).  Each ``*_launcher`` checks those
buffers once and returns a function that launches its kernel on them with
one ctypes call, on the stream that was current when it was bound: the
kernels update the buffers in place and read nothing back to the host.
``state`` is the pass's int32 vector; its slots are the ``ACTIVE`` ..
``ITERATIONS`` constants below, the energy an f32 stored by its bits.  ``diffusion`` is
the multi-start beam's diffusion start, one launch a branch.

Anything the kernels do not take raises, and so does a launch the runtime
refuses.  ``ring_pick_launches``, ``filters_launches``, ``commit_launches``
and ``diffusion_launches`` count successful launches, so a run can show its
main path went through the kernels; a launch is the span
``cuda_wrappers.wexler_<kernel>`` around ``enqueue.wexler_<kernel>``, kernel
``ring_pick``, ``filters``, ``commit`` or ``diffusion``.
"""

from __future__ import annotations

import torch

from ._build import bind, check_tensor, kernel_wrapper, launch, plan

# slots of a pass's int32 state vector
ACTIVE, FAIL, LIVE, COUNT, ENERGY, ITERATIONS = range(6)
STATE_SIZE = 8
# ring pick modes: an energy pass, an onion peel, an onion peel seeded from
# outside the known islands
ENERGY_MODE, RING_MODE, ISLAND_MODE = range(3)
WINDOW = 13
CHANNELS = 128                     # the search's padded channels
MAX_CAP = 1024                     # targets a commit takes (one block)
MAX_DIFFUSION_PIXELS = 128 * 128   # the diffusion start's box, in a cluster's shared memory

ring_pick_launches = 0
filters_launches = 0
commit_launches = 0
diffusion_launches = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    check_tensor(name, t, (dtype,), (len(shape),))
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the image on {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _check_box(box: tuple, height: int, width: int) -> None:
    bh, bw, by0, bx0 = box
    if not (1 <= bh and 1 <= bw and 0 <= by0 and 0 <= bx0 and by0 + bh <= height
            and bx0 + bw <= width):
        raise ValueError(f"hole box {box} (bh, bw, by0, bx0) outside the {height}x{width} image")


def _check_targets(tyx: torch.Tensor, state: torch.Tensor, device) -> int:
    """cap, from the (2, cap) int32 targets; checks the state vector."""
    check_tensor("tyx", tyx, (torch.int32,), (2,))
    cap = tyx.shape[1]
    if tyx.shape[0] != 2 or not 1 <= cap <= MAX_CAP:
        raise ValueError(f"tyx must be (2, cap) with 1 <= cap <= {MAX_CAP}, got "
                         f"{tuple(tyx.shape)}")
    if tyx.device != device:
        raise ValueError(f"tyx on {tyx.device}, the image on {device}")
    _check("state", state, torch.int32, (STATE_SIZE,), device)
    return cap


def _bind(kernel: str, like: torch.Tensor, *args):
    """A launch of ``vip_wexler_<kernel>`` with fixed arguments (``bind``),
    counted by ``<kernel>_launches``, recorded as the spans of
    ``wexler_<kernel>``."""
    go = bind("vip_wexler_" + kernel, "wexler_" + kernel, like, *args)
    return kernel_wrapper("wexler_" + kernel, kernel + "_launches", globals())(go)


def ring_pick_launcher(rem: torch.Tensor, rem0: torch.Tensor, island: torch.Tensor | None,
                       tyx: torch.Tensor, keys: torch.Tensor, state: torch.Tensor, box: tuple,
                       initial: bool):
    """The ring pick bound to a pass's buffers (checked once), on the stream
    current now.  Each launch takes the iteration's targets: writes ``tyx``
    (2, cap) int32, the count and the active flag, and resets ``keys``
    (Tp,) int64 to all ones, unless the pass failed or its energy loop
    stopped (then only active, to 0).  rem, rem0, island: (H, W) f32; box:
    (bh, bw, by0, bx0)."""
    check_tensor("rem", rem, (torch.float32,), (2,))
    height, width = rem.shape
    dev = rem.device
    _check("rem0", rem0, torch.float32, (height, width), dev)
    if island is not None:
        _check("island", island, torch.float32, (height, width), dev)
    cap = _check_targets(tyx, state, dev)
    check_tensor("keys", keys, (torch.int64,), (1,))
    if keys.shape[0] < cap or keys.device != dev:
        raise ValueError(f"keys must hold at least cap = {cap} on {dev}")
    _check_box(box, height, width)
    mode = ENERGY_MODE if not initial else RING_MODE if island is None else ISLAND_MODE
    return _bind("ring_pick", rem, rem.data_ptr(), rem0.data_ptr(),
                 None if island is None else island.data_ptr(), tyx.data_ptr(), keys.data_ptr(),
                 state.data_ptr(), *box, width, cap, keys.shape[0], mode)


def validity_region(height: int, width: int, box: tuple) -> tuple[int, int, int, int]:
    """(vy0, vx0, vh, vw): the candidates whose 13x13 window meets the box,
    the only ones whose validity a commit inside the box can change."""
    bh, bw, by0, bx0 = box
    n_cy, n_cx = height - (WINDOW - 1), width - (WINDOW - 1)
    vy0, vx0 = max(by0 - (WINDOW - 1), 0), max(bx0 - (WINDOW - 1), 0)
    return vy0, vx0, min(by0 + bh, n_cy) - vy0, min(bx0 + bw, n_cx) - vx0


def filters_launcher(img: torch.Tensor, rem: torch.Tensor, tyx: torch.Tensor,
                     state: torch.Tensor, f: torch.Tensor, b2: torch.Tensor,
                     valid: torch.Tensor, box: tuple, initial: bool):
    """The target filters bound to a pass's buffers (checked once).  Each
    launch writes the targets' filters into ``f`` (13, Tp, 128) bf16
    (columns 0..116 of rows 0..cap-1) and ``b2`` (cap,) f32, and recounts
    the validity map ``valid`` (H - 12, W - 12) u8 over the candidates whose
    window meets the box.  img: (H, W, 3) f32; rem: (H, W) f32."""
    check_tensor("img", img, (torch.float32,), (3,))
    height, width, channels = img.shape
    dev = img.device
    if channels != 3 or min(height, width) < WINDOW:
        raise ValueError(f"img must be an (H, W, 3) image at least {WINDOW}x{WINDOW}, got "
                         f"{tuple(img.shape)}")
    _check("rem", rem, torch.float32, (height, width), dev)
    cap = _check_targets(tyx, state, dev)
    check_tensor("f", f, (torch.bfloat16,), (3,))
    if f.shape[0] != WINDOW or f.shape[1] < cap or f.shape[2] != CHANNELS or f.device != dev:
        raise ValueError(f"f must be ({WINDOW}, Tp >= {cap}, {CHANNELS}) on {dev}, got "
                         f"{tuple(f.shape)} on {f.device}")
    _check("b2", b2, torch.float32, (cap,), dev)
    _check("valid", valid, torch.uint8, (height - WINDOW + 1, width - WINDOW + 1), dev)
    _check_box(box, height, width)
    return _bind("filters", img, img.data_ptr(), rem.data_ptr(), tyx.data_ptr(),
                 state.data_ptr(), f.data_ptr(), b2.data_ptr(), valid.data_ptr(), height, width,
                 cap, f.shape[1], int(initial), *validity_region(height, width, box))


def commit_launcher(img: torch.Tensor, rem: torch.Tensor, p: torch.Tensor, keys: torch.Tensor,
                    b2: torch.Tensor, tyx: torch.Tensor, weight: torch.Tensor,
                    state: torch.Tensor):
    """The commit bound to a pass's buffers (checked once).  Each launch
    decodes the search's keys and, unless a valid target got +inf (then the
    pass fails), copies each pick onto its target in ``img`` (H, W, 3) f32,
    clears it in ``rem`` (H, W) f32, rewrites the entries of ``p``
    (H, W - 12, 128) bf16 it feeds, and adds the iteration's Σ e·weight to
    the state's energy."""
    check_tensor("img", img, (torch.float32,), (3,))
    height, width, _ = img.shape
    dev = img.device
    _check("rem", rem, torch.float32, (height, width), dev)
    _check("weight", weight, torch.float32, (height, width), dev)
    _check("p", p, torch.bfloat16, (height, width - WINDOW + 1, CHANNELS), dev)
    cap = _check_targets(tyx, state, dev)
    _check("b2", b2, torch.float32, (cap,), dev)
    check_tensor("keys", keys, (torch.int64,), (1,))
    if keys.shape[0] < cap or keys.device != dev:
        raise ValueError(f"keys must hold at least cap = {cap} on {dev}")
    return _bind("commit", img, img.data_ptr(), rem.data_ptr(), p.data_ptr(), keys.data_ptr(),
                 b2.data_ptr(), tyx.data_ptr(), weight.data_ptr(), state.data_ptr(), width,
                 width - WINDOW + 1, cap)


def diffusion_shape(bh: int, bw: int) -> tuple[int, int]:
    """(CTAs a channel, shared memory bytes a CTA) of the diffusion start's
    launch on a (bh, bw) box: each channel's box is a cluster of row
    strips.  For reports."""
    return (plan("vip_wexler_diffusion_cluster", bh, bw),
            plan("vip_wexler_diffusion_smem_bytes", bh, bw))


@kernel_wrapper("wexler_diffusion", "diffusion_launches")
def diffusion(src: torch.Tensor, rem0: torch.Tensor, box: tuple, dither: bool,
              ninth: float) -> torch.Tensor:
    """The diffusion start: a copy of ``src`` (H, W, 3) u8 whose hole pixels
    (``rem0`` (H, W) f32 > 0) in the box (bh, bw, by0, bx0) hold bh + bw
    Jacobi sweeps of the 3x3 edge-padded mean from the known pixels' mean,
    the dither on top if asked, clamped to 0..255.  ninth: f32(1 / 9)."""
    check_tensor("src", src, (torch.uint8,), (3,))
    height, width, channels = src.shape
    if channels != 3:
        raise ValueError(f"src must be an (H, W, 3) image, got {tuple(src.shape)}")
    _check("rem0", rem0, torch.float32, (height, width), src.device)
    _check_box(box, height, width)
    bh, bw, by0, bx0 = box
    if bh * bw > MAX_DIFFUSION_PIXELS:
        raise ValueError(f"the diffusion start keeps its box in shared memory: at most "
                         f"{MAX_DIFFUSION_PIXELS} pixels, got {bh}x{bw}")
    out = src.clone()
    launch("vip_wexler_diffusion", "wexler_diffusion", src, src.data_ptr(), rem0.data_ptr(),
           out.data_ptr(), bh, bw, by0, bx0, width, int(dither), ninth)
    return out
