"""Plain PyTorch pieces of the bilateral-filter family, written out here so
that the yardstick does not move with the program.

The tables follow the reference's ``pre_compute_kernels``
(include/cpp/bilateral_filter.hpp:18-34): built on the host in float64 and
stored as float32.  The sums follow its filters: every product and sum
rounded on its own, in (ky, kx) tap order, true divisions (a divisor on the
tensor's device, never a Python number, which PyTorch's CUDA division turns
into a product by its reciprocal).  In float32 these are bit-equal to the
port's kernels; ``dtype`` computes them in a lower precision, the control
of the benchmark's check.
"""

import numpy as np
import torch


def space_kernel(ksize: int, sigma_space: float) -> np.ndarray:
    """(ksize, ksize) float32 spatial Gaussian, 0 outside the inscribed circle."""
    radius = ksize // 2
    denom = np.float32(np.float32(2.0 * np.float32(sigma_space)) * np.float32(sigma_space))
    ky, kx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    r2 = (kx * kx + ky * ky).astype(np.int64)
    table = np.exp(r2 * (-1.0 / float(denom))).astype(np.float32)
    table[r2 > radius * radius] = 0.0
    return table


def color_table(sigma_color: float, size: int = 256 * 3) -> np.ndarray:
    """(size,) float32 range Gaussian, ``exp(-i² / (2 σc²))``."""
    denom = np.float32(np.float32(2.0 * np.float32(sigma_color)) * np.float32(sigma_color))
    i = np.arange(size, dtype=np.int64)
    return np.exp((i * i) * (-1.0 / float(denom))).astype(np.float32)


def replicate_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-pad the two leading axes by r (the reference's clamped coordinates)."""
    if r == 0:
        return x
    for axis in (0, 1):
        idx = np.clip(np.arange(-r, x.shape[axis] + r), 0, x.shape[axis] - 1)
        x = torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))
    return x


def scalar(value: float, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A 0-d tensor on like's device: dividing by it is a true division."""
    return torch.tensor(value, dtype=dtype, device=like.device)


def joint_bilateral(src: torch.Tensor, guide: torch.Tensor, ksize: int, sigma_space: float,
                    sigma_color: float, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, 3) u8 src, (H, W, 3) u8-valued guide → (H, W, 3) u8: the joint
    bilateral filter with replicate padding and ``u8(floor(x + 0.5))``."""
    h, w, _ = src.shape
    r = ksize // 2
    space = space_kernel(ksize, sigma_space)
    lut = torch.from_numpy(color_table(sigma_color)).to(device=src.device, dtype=dtype)
    src_p = replicate_pad(src.to(dtype), r)
    guide_c = guide.to(torch.int64)
    guide_p = replicate_pad(guide_c, r)
    sums = torch.zeros((h, w, 3), dtype=dtype, device=src.device)
    sumk = torch.zeros((h, w), dtype=dtype, device=src.device)
    for dy, dx in zip(*np.nonzero(space)):  # (ky, kx) order; zero taps add exactly 0
        ws = float(space[dy, dx])
        dist = (guide_p[dy:dy + h, dx:dx + w] - guide_c).abs().sum(dim=2)
        wk = lut[dist] * ws
        sums = sums + src_p[dy:dy + h, dx:dx + w] * wk[:, :, None]
        sumk = sumk + wk
    out = sums / sumk[:, :, None]
    # a weighted mean of u8 values stays within 0..255 in float32, where the
    # clamp changes nothing; in a lower precision it can round past 255
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0).to(torch.uint8)


def gradient(img: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(H, W, C) u8 → (H, W) gradient magnitude: clamped central
    differences, squared, summed over the channels in order, square root."""
    p = replicate_pad(img.to(dtype), 1)
    vdiff = p[2:, 1:-1] - p[:-2, 1:-1]
    hdiff = p[1:-1, 2:] - p[1:-1, :-2]
    square = hdiff * hdiff + vdiff * vdiff
    total = square[:, :, 0]
    for c in range(1, img.shape[2]):
        total = total + square[:, :, c]
    if dtype == torch.float32:
        # the float64 root rounded to float32 is the correctly rounded sqrtf
        return torch.sqrt(total.double()).to(torch.float32)
    return torch.sqrt(total)


def blur_and_rtv(img: torch.Tensor, magnitude: torch.Tensor, ksize: int,
                 dtype: torch.dtype = torch.float32):
    """(H, W, 3) u8 image, (H, W) magnitude → ((H, W, 3) box blur, (H, W)
    mRTV): (max − min of the window's intensity) × max of the window's
    magnitude / (sum of it + 1e-9)."""
    image = img.to(dtype)
    h, w, _ = image.shape
    r = ksize // 2
    intensity = (image[:, :, 0] + image[:, :, 1] + image[:, :, 2]) / scalar(3.0, image, dtype)
    img_p = replicate_pad(image, r)
    int_p = replicate_pad(intensity, r)
    mag_p = replicate_pad(magnitude.to(dtype), r)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=image.device)

    b_sum, i_max, m_max, m_sum = zeros(h, w, 3), zeros(h, w), zeros(h, w), zeros(h, w)
    i_min = torch.full((h, w), 256.0, dtype=dtype, device=image.device)
    for dy in range(ksize):
        for dx in range(ksize):
            b_sum = b_sum + img_p[dy:dy + h, dx:dx + w]
            iw = int_p[dy:dy + h, dx:dx + w]
            mw = mag_p[dy:dy + h, dx:dx + w]
            i_max = torch.maximum(i_max, iw)
            i_min = torch.minimum(i_min, iw)
            m_max = torch.maximum(m_max, mw)
            m_sum = m_sum + mw
    blurred = b_sum / scalar(ksize * ksize, image, dtype)
    rtv = (i_max - i_min) * m_max / (m_sum + float(np.float32(1e-9)))
    return blurred, rtv


def guide(blurred: torch.Tensor, rtv: torch.Tensor, ksize: int,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The guide image: the blur at the window's first least mRTV in (ky, kx)
    order, blended with the pixel's own by α = 2 / (1 + exp((rtv − least) /
    (5k))) − 1, rounded half up and clamped to 0..255."""
    h, w, _ = blurred.shape
    r = ksize // 2
    rtv_p = replicate_pad(rtv, r)
    blur_p = replicate_pad(blurred, r)
    best_rtv = torch.full((h, w), torch.finfo(dtype).max, dtype=dtype, device=rtv.device)
    best_blur = torch.zeros((h, w, 3), dtype=dtype, device=rtv.device)
    for dy in range(ksize):
        for dx in range(ksize):
            rv = rtv_p[dy:dy + h, dx:dx + w]
            m = rv < best_rtv  # strict: the first minimum wins
            best_rtv = torch.where(m, rv, best_rtv)
            best_blur = torch.where(m[:, :, None], blur_p[dy:dy + h, dx:dx + w], best_blur)
    sigma_alpha = float(np.float32(1.0) / np.float32(5 * ksize))
    e = torch.exp(sigma_alpha * (rtv - best_rtv))
    alpha = scalar(2.0, rtv, dtype) / (1.0 + e) - 1.0
    blend = alpha[:, :, None] * best_blur + (1.0 - alpha)[:, :, None] * blurred
    return torch.clamp(torch.trunc(blend + 0.5), 0.0, 255.0)
