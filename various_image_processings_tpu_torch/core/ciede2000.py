"""CIEDE2000 squared color difference.

Twin of ``various_image_processings_tpu/core/ciede2000.py``: the reference's
``CIE_DeltaE2000_square`` (include/cpp/slic.hpp:15-112), implemented there
but never selectable (``distance_function_`` is fixed to euclidean at :138),
is an optional SLIC metric here, branch-free through ``torch.where``.

The reference's ``degree_to_radian`` multiplies by π, not π/180
(include/cpp/slic.hpp:16-18), which rescales every hue constant.
``ciede2000_square`` is the correct CIEDE2000; ``ciede2000_ref_square`` (SLIC
metric ``"ciede2000_ref"``) is the reference's π-scaled variant, all f32.
``ciede2000_ref_square_np`` is the NumPy twin of that variant that mirrors
each float/double promotion of the C++; the host-side merge of
``models/slic.py`` uses it for ``"ciede2000_ref"``.

``atan2``, ``sin``, ``cos``, ``exp``, ``sqrt`` and ``pow`` differ by ulps
between the CPU, the card and other libraries, so these metrics are held to
tolerances, not to bits (tests/test_torch_ciede2000.py).  On the card the
SLIC kernels' ΔE (csrc/slic_kmeans.cu) repeats ``_square`` operation by
operation with the CUDA math library PyTorch's CUDA ops call, and is held to
it bit for bit.  On the CPU PyTorch's ``pow`` and ``atan2`` round differently
in their vector and scalar loops, so there a value's bits may depend on
where it lies in its tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_POW25_7 = 6103515625.0  # 25^7, exact in f32
_PI = float(np.float32(math.pi))
_TWO_PI = float(np.float32(2 * math.pi))


def _deg(d: float) -> float:
    return float(np.float32(np.deg2rad(d)))


def _deg_ref(d: float) -> float:
    """The reference's degree_to_radian: degree * π in f32 (slic.hpp:16-18)."""
    return float(np.float32(np.float32(d) * np.float32(np.pi)))


def _f32(*args) -> list[torch.Tensor]:
    """Tensors stay where they are; numbers and arrays become CPU tensors."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in args]


def _square(l1, a1, b1, l2, a2, b2, full: float, half: float, deg) -> torch.Tensor:
    """The ΔE² expression with hue period ``full`` (2π, or 360π for the
    reference's variant), half period ``half`` and degree map ``deg``."""
    l1, a1, b1, l2, a2, b2 = _f32(l1, a1, b1, l2, a2, b2)
    c1 = torch.sqrt(a1 * a1 + b1 * b1)
    c2 = torch.sqrt(a2 * a2 + b2 * b2)
    bar_c = (c1 + c2) / 2.0
    bar_c7 = bar_c ** 7
    g = 0.5 * (1.0 - torch.sqrt(bar_c7 / (bar_c7 + _POW25_7)))
    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = torch.sqrt(a1p * a1p + b1 * b1)
    c2p = torch.sqrt(a2p * a2p + b2 * b2)

    zero = torch.zeros((), dtype=torch.float32, device=l1.device)
    h1p = torch.where((b1 == 0) & (a1p == 0), zero, torch.atan2(b1, a1p))
    h1p = torch.where(h1p < 0, h1p + full, h1p)
    h2p = torch.where((b2 == 0) & (a2p == 0), zero, torch.atan2(b2, a2p))
    h2p = torch.where(h2p < 0, h2p + full, h2p)

    dl = l2 - l1
    dc = c2p - c1p
    prod = c1p * c2p
    dh = h2p - h1p
    dh = torch.where(dh > half, dh - full, dh)
    dh = torch.where(dh < -half, dh + full, dh)
    dh = torch.where(prod == 0, zero, dh)
    d_h = 2.0 * torch.sqrt(prod) * torch.sin(dh / 2.0)

    bar_l = (l1 + l2) / 2.0
    bar_cp = (c1p + c2p) / 2.0
    hsum = h1p + h2p
    habs = torch.abs(h1p - h2p)
    bar_h = torch.where(habs <= half, hsum / 2.0,
                        torch.where(hsum < full, (hsum + full) / 2.0, (hsum - full) / 2.0))
    bar_h = torch.where(prod == 0, hsum, bar_h)

    t = (1.0 - 0.17 * torch.cos(bar_h - deg(30.0))
         + 0.24 * torch.cos(2.0 * bar_h)
         + 0.32 * torch.cos(3.0 * bar_h + deg(6.0))
         - 0.20 * torch.cos(4.0 * bar_h - deg(63.0)))
    # a true division on every device: PyTorch's CUDA division by a Python
    # float multiplies by its reciprocal
    ratio = (bar_h - deg(275.0)) / torch.tensor(deg(25.0), device=l1.device)
    dtheta = deg(30.0) * torch.exp(-(ratio * ratio))
    bar_cp7 = bar_cp ** 7
    r_c = 2.0 * torch.sqrt(bar_cp7 / (bar_cp7 + _POW25_7))
    dl50 = bar_l - 50.0
    s_l = 1.0 + 0.015 * (dl50 * dl50) / torch.sqrt(20.0 + dl50 * dl50)
    s_c = 1.0 + 0.045 * bar_cp
    s_h = 1.0 + 0.015 * bar_cp * t
    r_t = -torch.sin(2.0 * dtheta) * r_c

    fl = dl / s_l
    fc = dc / s_c
    fh = d_h / s_h
    return fl * fl + fc * fc + fh * fh + r_t * fc * fh


def ciede2000_square(l1, a1, b1, l2, a2, b2) -> torch.Tensor:
    """Squared ΔE₀₀ between Lab pairs (broadcast elementwise), f32."""
    # the first wrap test is dh > π (the reference variant tests < −half first;
    # at most one of the two holds, so the order does not matter)
    return _square(l1, a1, b1, l2, a2, b2, _TWO_PI, _PI, _deg)


def ciede2000_ref_square(l1, a1, b1, l2, a2, b2) -> torch.Tensor:
    """Squared ΔE of the reference's π-scaled ``CIE_DeltaE2000_square``, all
    f32.  Not a perceptual metric: the 180× hue-constant rescale puts the
    cos/exp terms on arbitrary phases; provided so a reference user flipping
    ``distance_function_`` finds the same behavior here."""
    return _square(l1, a1, b1, l2, a2, b2, _deg_ref(360.0), _deg_ref(180.0), _deg_ref)


_PI_F = np.float32(np.pi)


def _deg_np(d: float) -> np.float32:
    """degree_to_radian twin: degree * pi (f32), NOT pi/180 (slic.hpp:16-18)."""
    return np.float32(np.float32(d) * _PI_F)


def ciede2000_ref_square_np(l1, a1, b1, l2, a2, b2) -> np.ndarray:
    """NumPy twin of the reference's ``CIE_DeltaE2000_square`` that mirrors
    its dtypes: ``std::sqrt(int)``, ``std::pow(double, int)`` and
    ``std::atan2(int, double)`` promote to double, while ``hPrime1/2``,
    ``deltahPrime``, ``barhPrime`` and ``hPrimeSum`` are declared float (each
    assignment rounds) and ``std::sin/cos(float)`` stay in float.  f32 result."""
    l1, a1, b1, l2, a2, b2 = (np.asarray(v, np.int64) for v in (l1, a1, b1, l2, a2, b2))
    f32, f64 = np.float32, np.float64
    deg360 = _deg_np(360.0)
    deg180 = _deg_np(180.0)
    pow25_7 = f64(_POW25_7)

    c1 = np.sqrt((a1 * a1 + b1 * b1).astype(f64))
    c2 = np.sqrt((a2 * a2 + b2 * b2).astype(f64))
    bar_c = (c1 + c2) / f64(2.0)
    bar_c7 = np.power(bar_c, f64(7.0))
    g = f64(0.5) * (1.0 - np.sqrt(bar_c7 / (bar_c7 + pow25_7)))
    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = np.sqrt(a1p * a1p + b1 * b1)
    c2p = np.sqrt(a2p * a2p + b2 * b2)

    # float hPrime = atan2(int, double): the double atan2 narrowed to f32,
    # then the < 0 test and the += deg360 in f32
    h1p = np.where((b1 == 0) & (a1p == 0), f32(0.0),
                   np.arctan2(b1.astype(f64), a1p).astype(f32))
    h1p = np.where(h1p < 0, (h1p + deg360).astype(f32), h1p).astype(f32)
    h2p = np.where((b2 == 0) & (a2p == 0), f32(0.0),
                   np.arctan2(b2.astype(f64), a2p).astype(f32))
    h2p = np.where(h2p < 0, (h2p + deg360).astype(f32), h2p).astype(f32)

    dl = (l2 - l1).astype(f64)
    dc = c2p - c1p
    prod = c1p * c2p

    dh = (h2p - h1p).astype(f32)
    dh = np.where(dh < -deg180, (dh + deg360).astype(f32), dh)
    dh = np.where(dh > deg180, (dh - deg360).astype(f32), dh)
    dh = np.where(prod == 0, f32(0.0), dh).astype(f32)
    # 2.f * sqrt(double) * sin(float): sinf stays f32, the product is double
    d_h = 2.0 * np.sqrt(prod) * np.sin((dh / f32(2.0)).astype(f32)).astype(f64)

    bar_l = ((l1 + l2).astype(f32) / f32(2.0)).astype(f32)
    bar_cp = (c1p + c2p) / f64(2.0)
    hsum = (h1p + h2p).astype(f32)
    habs = np.abs((h1p - h2p).astype(f32))
    # float barhPrime: the |..| <= 180pi branch divides by 2.0 (double) and
    # narrows, the other branches divide by 2.f
    bar_h = np.where(
        habs <= deg180, (hsum.astype(f64) / 2.0).astype(f32),
        np.where(hsum < deg360, ((hsum + deg360).astype(f32) / f32(2.0)),
                 ((hsum - deg360).astype(f32) / f32(2.0)))).astype(f32)
    bar_h = np.where(prod == 0, hsum, bar_h).astype(f32)

    def cosf(x):
        return np.cos(np.asarray(x, f32)).astype(f32)

    t = (1.0
         - (f32(0.17) * cosf(bar_h - _deg_np(30.0))).astype(f64)
         + (f32(0.24) * cosf(f32(2.0) * bar_h)).astype(f64)
         + (f32(0.32) * cosf(f32(3.0) * bar_h + _deg_np(6.0))).astype(f64)
         - (f32(0.20) * cosf(f32(4.0) * bar_h - _deg_np(63.0))).astype(f64))
    ratio = ((bar_h - _deg_np(275.0)).astype(f32) / _deg_np(25.0)).astype(f32)
    dtheta = _deg_np(30.0) * np.exp(-np.power(ratio.astype(f64), 2.0))
    bar_cp7 = np.power(bar_cp, f64(7.0))
    r_c = 2.0 * np.sqrt(bar_cp7 / (bar_cp7 + pow25_7))
    sq = ((bar_l - f32(50.0)) * (bar_l - f32(50.0))).astype(f32)
    s_l = (f32(1.0) + ((f32(0.015) * sq).astype(f32)
                       / np.sqrt((f32(20.0) + sq).astype(f32)).astype(f32))
           ).astype(f32)
    s_c = 1.0 + f64(0.045) * bar_cp
    s_h = 1.0 + f64(0.015) * bar_cp * t
    r_t = -np.sin(2.0 * dtheta) * r_c

    fl = (dl.astype(f32) / s_l).astype(f32)
    fl2 = (fl * fl).astype(f32).astype(f64)
    fc = dc / s_c
    fh = d_h / s_h
    de = fl2 + fc * fc + fh * fh + r_t * fc * fh
    return de.astype(f32)
