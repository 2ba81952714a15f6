"""Bilateral texture filter (Cho et al. 2014 texture removal).

PyTorch counterpart of ``various_image_processings_tpu/ops/bilateral_texture.py``
(reference: include/cpp/bilateral_texture_filter.hpp:153-164 and the CUDA
pipeline, src/bilateral_texture_filter_impl.cu:199-214).  Per iteration:
gradient magnitude → box blur + mRTV → guide (window argmin of mRTV,
first minimum in (ky, kx) order, α-blend) → joint bilateral filter with
ksize 2k−1, σ_space k−1, σ_color √3.

On a CUDA tensor an iteration is four hand-written kernels (csrc/gradient.cu,
csrc/bilateral_texture.cu twice, csrc/bilateral.cu), so one call launches
4·nitr kernels, all enqueued by one C call (csrc/btf_pipeline.cu,
``ops.cuda.bilateral_texture.texture_filter``); the stage functions below
launch them one at a time, for callers that work between stages (row
sharding's halo exchanges).  The plain versions below run on a CPU tensor,
and on the card they are what the kernels are held to.  Both keep the
reference's rounding: true divisions (a divisor on the input's device,
never a Python literal: PyTorch's CUDA division by a host scalar multiplies
by its reciprocal, one ulp off, enough to flip the guide's argmin; PARITY.md
D1b), and every product and sum rounded on its own (PARITY.md D1c).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.luts import color_table, space_kernel
from ..core.pad import replicate_pad
from ..utils.profiling import SPANS
from . import _validate
from ._dispatch import resolve_impl
from .bilateral import _taps_math
from .cuda import bilateral as cuda_bilateral
from .cuda import bilateral_texture as cuda_btf
from .cuda import gradient as cuda_gradient
from .cuda.bilateral_texture import EPSILON, sigma_alpha
from .gradient import _gradient_math

# variant → the final JBF stage's (border, rounding): the reference's CUDA
# pipeline uses its in-repo JBF (replicate pad, u8(x + 0.5f)); its cpp
# pipeline defers to cv::ximgproc::jointBilateralFilter (reflect-101,
# cvRound).  The other stages are the same in both.
VARIANTS = {"cuda": ("replicate", "trunc"), "cpp": ("reflect101", "rint")}
# f32 √3, as ops/pallas/bilateral_texture.py:239 computes it
JBF_SIGMA_COLOR = float(np.sqrt(np.float32(3.0)))


def _device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on like's device: dividing by it is a true division
    on every device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _blur_and_rtv_math(image_f: torch.Tensor, magnitude: torch.Tensor, ksize: int):
    """(H, W, 3) f32 u8-valued image, (H, W) f32 magnitude →
    ((H, W, 3) f32 blurred, (H, W) f32 rtv)."""
    h, w, _ = image_f.shape
    r = ksize // 2
    channel_sum = image_f[:, :, 0] + image_f[:, :, 1] + image_f[:, :, 2]
    intensity = channel_sum / _device_scalar(3.0, image_f)
    img_p = replicate_pad(image_f, r, r, r, r)
    int_p = replicate_pad(intensity, r, r, r, r)
    mag_p = replicate_pad(magnitude, r, r, r, r)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=image_f.device)

    b_sum, i_max, m_max, m_sum = zeros(h, w, 3), zeros(h, w), zeros(h, w), zeros(h, w)
    i_min = torch.full((h, w), 256.0, dtype=torch.float32, device=image_f.device)
    for dy in range(ksize):
        for dx in range(ksize):
            b_sum = b_sum + img_p[dy:dy + h, dx:dx + w]
            iw = int_p[dy:dy + h, dx:dx + w]
            mw = mag_p[dy:dy + h, dx:dx + w]
            i_max = torch.maximum(i_max, iw)
            i_min = torch.minimum(i_min, iw)
            m_max = torch.maximum(m_max, mw)
            m_sum = m_sum + mw
    blurred = b_sum / _device_scalar(ksize * ksize, image_f)
    rtv = (i_max - i_min) * m_max / (m_sum + float(EPSILON))
    return blurred, rtv


def _guide_math(blurred: torch.Tensor, rtv: torch.Tensor, ksize: int) -> torch.Tensor:
    """((H, W, 3) f32, (H, W) f32) → (H, W, 3) f32 u8-valued guide: the JAX
    package's ``_guide_math(strict=True)``.  Eager PyTorch rounds every op
    on its own, which is what ``strict`` pins there."""
    h, w, _ = blurred.shape
    r = ksize // 2
    rtv_p = replicate_pad(rtv, r, r, r, r)
    blur_p = replicate_pad(blurred, r, r, r, r)
    best_rtv = torch.full((h, w), torch.finfo(torch.float32).max, dtype=torch.float32,
                          device=rtv.device)
    best_blur = torch.zeros((h, w, 3), dtype=torch.float32, device=rtv.device)
    for dy in range(ksize):
        for dx in range(ksize):
            rv = rtv_p[dy:dy + h, dx:dx + w]
            m = rv < best_rtv  # strict: the first minimum in (ky, kx) order wins
            best_rtv = torch.where(m, rv, best_rtv)
            best_blur = torch.where(m[:, :, None], blur_p[dy:dy + h, dx:dx + w], best_blur)
    e = torch.exp(float(sigma_alpha(ksize)) * (rtv - best_rtv))
    alpha = _device_scalar(2.0, rtv) / (1.0 + e) - 1.0
    p1 = alpha[:, :, None] * best_blur
    p2 = (1.0 - alpha)[:, :, None] * blurred
    return torch.clamp(torch.trunc((p1 + p2) + 0.5), 0.0, 255.0)


def jbf_tables(ksize: int, device: torch.device):
    """The closing joint bilateral filter's (taps, lut) for a BTF of window
    ``ksize``: ksize 2k−1, σ_space k−1, σ_color √3."""
    return cuda_bilateral.device_tables(2 * ksize - 1, float(ksize - 1), JBF_SIGMA_COLOR,
                                        device)


def jbf_numpy_tables(ksize: int):
    """jbf_tables on the host: the (2k−1, 2k−1) space kernel and the range
    table, as the JAX package's ``pre_compute_kernels`` gives them."""
    return space_kernel(2 * ksize - 1, float(ksize - 1)), color_table(JBF_SIGMA_COLOR)


def gradient_stage(img: torch.Tensor, impl: str) -> torch.Tensor:
    """(H, W, 3) u8 → (H, W) f32 gradient magnitude."""
    if impl == "cuda":
        return cuda_gradient.gradient(img)
    return _gradient_math(img.to(torch.float32))


def blur_rtv_stage(img: torch.Tensor, magnitude: torch.Tensor, ksize: int, impl: str):
    """(H, W, 3) u8 image, (H, W) f32 magnitude → ((H, W, 3) f32 blurred,
    (H, W) f32 rtv)."""
    if impl == "cuda":
        return cuda_btf.blur_and_rtv(img, magnitude, ksize)
    return _blur_and_rtv_math(img.to(torch.float32), magnitude, ksize)


def guide_stage(blurred: torch.Tensor, rtv: torch.Tensor, ksize: int, impl: str):
    """→ (H, W, 3) guide holding u8 values (u8 from the kernel, f32 from
    the plain version)."""
    if impl == "cuda":
        return cuda_btf.guide(blurred, rtv, ksize)
    return _guide_math(blurred, rtv, ksize)


def jbf_stage(img: torch.Tensor, guide: torch.Tensor, taps: torch.Tensor, lut: torch.Tensor,
              ksize: int, border: str, rounding: str, impl: str) -> torch.Tensor:
    """The closing joint filter, window 2k−1, with jbf_tables(ksize) on
    img's device → (H, W, 3) u8."""
    if impl == "cuda":
        return cuda_bilateral.joint_bilateral(img, guide, taps, lut, ksize - 1, border, rounding)
    return _taps_math(img, guide, taps, lut, ksize - 1, border, rounding)


def btf_iteration(img: torch.Tensor, ksize: int, taps: torch.Tensor, lut: torch.Tensor,
                  border: str, rounding: str, impl: str) -> torch.Tensor:
    """One iteration, (H, W, 3) u8 → (H, W, 3) u8, on img's device.
    ``impl`` is resolved already: "cuda" launches the four kernels."""
    magnitude = gradient_stage(img, impl)
    blurred, rtv = blur_rtv_stage(img, magnitude, ksize, impl)
    guide = guide_stage(blurred, rtv, ksize, impl)
    return jbf_stage(img, guide, taps, lut, ksize, border, rounding, impl)


def _btf(src: torch.Tensor, ksize: int, nitr: int, impl: str, variant: str,
         taps: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``impl`` is resolved already."""
    border, rounding = VARIANTS[variant]
    img = src.contiguous()
    if impl == "cuda" and nitr > 0:
        return cuda_btf.texture_filter(img, ksize, nitr, taps, lut, border, rounding)
    for _ in range(nitr):
        img = btf_iteration(img, ksize, taps, lut, border, rounding, impl)
    return img.clone() if img is src else img


def check_nitr(nitr: int) -> None:
    if nitr < 0:
        raise ValueError(f"nitr must be >= 0, got {nitr}")


def bilateral_texture_filter(src, ksize: int = 9, nitr: int = 3, impl: str = "auto",
                             variant: str = "cuda", device="cuda") -> torch.Tensor:
    """(H, W, 3) u8 → (H, W, 3) u8 texture-removed image.

    variant: "cuda" (default) matches the reference's CUDA pipeline
    (src/bilateral_texture_filter_impl.cu:199-214, in-repo JBF); "cpp" its
    cpp pipeline (include/cpp/bilateral_texture_filter.hpp:153-164,
    cv::ximgproc::jointBilateralFilter as the final stage).

    A tensor is filtered on its own device; any other array is first copied
    to ``device`` (the GPU unless the caller passes ``device="cpu"``).  The
    call is the span ``ops.bilateral_texture_filter``."""
    s = SPANS.open("ops.bilateral_texture_filter") if SPANS.on else -1
    try:
        v = SPANS.open("ops.validate") if SPANS.on else -1
        src = _validate.as_tensor(src, device)
        _validate.check_u8_color("src", src)
        _validate.check_ksize(ksize)
        check_nitr(nitr)
        if variant not in VARIANTS:
            raise ValueError(f'variant must be "cuda" or "cpp", got {variant!r}')
        impl = resolve_impl(impl, src)
        if v >= 0:
            SPANS.close(v)
        t = SPANS.open("ops.tables") if SPANS.on else -1
        taps, lut = jbf_tables(int(ksize), src.device)
        if t >= 0:
            SPANS.close(t)
        return _btf(src, int(ksize), int(nitr), impl, variant, taps, lut)
    finally:
        if s >= 0:
            SPANS.close(s)
