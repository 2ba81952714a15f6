"""Wrapper of the Hopper Wexler search kernel (csrc/wexler_search.cu).

Takes the kx-packed candidate planes p117 (H, n_cx, C ≤ 128) bf16, the
per-target filters f13 (k, C, T) bf16 and the candidate validity map
(n_cy, n_cx) bool or u8, all contiguous on one CUDA device.  ``prepare``
pads the channels to 128 and the targets to the kernel's tile with zeros and
stores the filters target-major, (k, Tp, 128), so that the kernel's TMA
loads both operands K-major; ``launch`` runs the kernel on PyTorch's current
stream into a (Tp,) buffer of packed (energy, index) keys that starts at all
ones; ``decode_keys`` turns the keys into energies and indices with a few
elementwise ops, and ``encode_keys`` packs them back.  The fill loop
(``models/inpainting.py``) keeps its planes and filters in the padded
layouts for a whole pass and binds the kernel to them once
(``launcher``), gated by its active flag.  Anything the kernel does not take raises, and so does a
launch the runtime refuses.  ``launches`` counts successful launches; a
launch is the span ``cuda_wrappers.wexler_search`` around
``enqueue.wexler_search``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.pad import round_up
from ._build import bind, check_tensor, kernel_wrapper, plan

K_PAD = 128
TARGET_TILE = 128  # targets a block (the kernel's kTileN): Tp is a multiple
_MAX_GRID_YZ = 65535

launches = 0


def decode_keys(keys: torch.Tensor, t: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(emin (t,) f32, idx (t,) int32) from the kernel's (Tp,) int64 keys:
    high word the energy's order-preserving bits, low word the flat index; an
    untouched key (every bit set: no valid candidate) gives (+inf, 0)."""
    keys = keys[:t]
    untouched = keys == -1
    hi = (keys >> 32) & 0xFFFFFFFF
    bits = torch.where(hi >= 0x80000000, hi - 0x80000000, 0xFFFFFFFF - hi)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    emin = torch.where(untouched, torch.inf, bits.view(torch.float32))
    idx = torch.where(untouched, 0, keys & 0xFFFFFFFF).to(torch.int32)
    return emin, idx


def encode_keys(emin: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's (T,) int64 keys of (emin (T,) f32, idx (T,) int32), the
    inverse of ``decode_keys``: +inf (no valid candidate) gives the untouched
    key, every bit set; −0.0 packs as +0.0, as in the kernel."""
    bits = (emin + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits, bits + 0x80000000)
    keys = (ordered << 32) | (idx.to(torch.int64) & 0xFFFFFFFF)
    return torch.where(torch.isinf(emin) & (emin > 0), -1, keys)


def prepare(p117: torch.Tensor, f13: torch.Tensor, valid: torch.Tensor):
    """Checked, padded buffers for ``launch``: (p (H, n_cx, 128), f (k, Tp,
    128) target-major, valid (n_cy, n_cx) u8, keys (Tp,) int64 all ones,
    n_cy)."""
    check_tensor("p117", p117, (torch.bfloat16,), (3,))
    check_tensor("f13", f13, (torch.bfloat16,), (3,))
    check_tensor("valid", valid, (torch.bool, torch.uint8), (2,))
    height, n_cx, channels = p117.shape
    window, f_channels, t = f13.shape
    n_cy = height - (window - 1)
    if f13.device != p117.device or valid.device != p117.device:
        raise ValueError("p117, f13 and valid must be on one device")
    if f_channels != channels or channels > K_PAD:
        raise ValueError(f"p117 and f13 must share a channel count ≤ {K_PAD}, got "
                         f"{channels} and {f_channels}")
    if n_cy < 1 or n_cx < 1 or t < 1:
        raise ValueError(f"no candidate or no target: p117 {tuple(p117.shape)}, "
                         f"f13 {tuple(f13.shape)}")
    if tuple(valid.shape) != (n_cy, n_cx):
        raise ValueError(f"valid must have shape {(n_cy, n_cx)}, got {tuple(valid.shape)}")
    if (-(-n_cx // 64) > _MAX_GRID_YZ
            or -(-n_cy // plan("vip_wexler_search_row_tile")) > _MAX_GRID_YZ):
        raise ValueError(f"candidate grid {(n_cy, n_cx)} exceeds the launch grid")
    tp = round_up(t, plan("vip_wexler_search_target_tile"))
    p = F.pad(p117, (0, K_PAD - channels)).contiguous()
    f = F.pad(f13.transpose(1, 2), (0, K_PAD - channels, 0, tp - t)).contiguous()
    keys = torch.full((tp,), -1, dtype=torch.int64, device=p117.device)
    return p, f, valid.view(torch.uint8), keys, n_cy


def search_min(p117: torch.Tensor, f13: torch.Tensor,
               valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per target: (min energy over the valid candidates, first raster flat
    index cy·n_cx + cx reaching it); (+inf, 0) where no candidate is valid."""
    p, f, valid_u8, keys, n_cy = prepare(p117, f13, valid)
    launch(p, f, valid_u8, keys, n_cy)
    return decode_keys(keys, f13.shape[2])


def launch(p: torch.Tensor, f: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
           n_cy: int) -> None:
    """The kernel alone on the buffers of ``prepare``: p (H, n_cx, 128) bf16,
    f (k, Tp, 128) bf16, valid (n_cy, n_cx) u8, keys (Tp,) int64."""
    launcher(p, f, valid, keys, n_cy)()


def launcher(p: torch.Tensor, f: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
             n_cy: int, active: torch.Tensor | None = None):
    """The kernel bound to ``launch``'s buffers, checked once: a function
    that launches it on the stream current now, with nothing to check or
    look up.  active: an int32 on p's device (the fill loop's active flag,
    ``ops/cuda/wexler_fill.py``); every block returns at once where it is 0."""
    check_tensor("p", p, (torch.bfloat16,), (3,))
    check_tensor("f", f, (torch.bfloat16,), (3,))
    check_tensor("valid", valid, (torch.uint8,), (2,))
    check_tensor("keys", keys, (torch.int64,), (1,))
    window, tp, channels = f.shape
    n_cx = p.shape[1]
    if p.shape[0] != n_cy + window - 1 or p.shape[2] != K_PAD or channels != K_PAD:
        raise ValueError(f"p {tuple(p.shape)} and f {tuple(f.shape)} do not match n_cy = {n_cy} "
                         f"and {K_PAD} channels")
    if tuple(valid.shape) != (n_cy, n_cx) or keys.shape[0] < tp:
        raise ValueError(f"valid must have shape {(n_cy, n_cx)} and keys hold {tp}, got "
                         f"{tuple(valid.shape)} and {keys.shape[0]}")
    if any(t.device != p.device for t in (f, valid, keys)) or (
            active is not None and (active.device != p.device or active.dtype != torch.int32)):
        raise ValueError("the search's buffers and active flag must be on one device "
                         "(the flag int32)")
    if tp % plan("vip_wexler_search_target_tile"):
        raise ValueError(f"f's {tp} target rows are not a multiple of the kernel's tile")
    if p.data_ptr() % 16 or f.data_ptr() % 16:
        raise ValueError("p and f must be 16-byte aligned (the kernel's TMA loads need it)")
    go = bind("vip_wexler_search", "wexler_search", p, p.data_ptr(), f.data_ptr(),
              valid.data_ptr(), keys.data_ptr(), None if active is None else active.data_ptr(),
              window, n_cy, n_cx, tp)
    return kernel_wrapper("wexler_search", "launches", globals())(go)
