"""Replays of the two bilateral-texture-filter fuzz cases that caught the
division and FMA flips on the JAX side (PARITY.md D1b/D1c), through the
PyTorch port's plain version on the CPU.

- case 100 (64×31, k=9, cpp variant): the port is bit-equal to the JAX xla
  path at nitr 1 and 3.
- case 209 (64×31, k=7): the JAX xla path's jitted composition wobbles on
  this image (PARITY.md D1c).  The port's stages are bit-equal to golden/
  (blur + mRTV) or within 1 u8 (guide), its cuda variant is bit-equal to
  golden/ end to end, and its cpp variant stays inside the D1c envelope
  against JAX xla (max ≤ 64, PSNR ≥ 28 dB; measured max 40, 39.8 dB).
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu import golden  # noqa: E402
from various_image_processings_tpu.ops.bilateral_texture import (  # noqa: E402
    bilateral_texture_filter as jax_btf)
import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch.ops import bilateral_texture as tbt  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"


def case(name):
    return np.load(DATA / f"btf_fuzz_{name}.npz")["src"]


def diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("nitr", [1, 3])
def test_case100_bit_equal_to_jax_xla(nitr):
    img = case("case100")
    got = vt.bilateral_texture_filter(img, 9, nitr, variant="cpp", device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_btf(img, 9, nitr, impl="xla",
                                                          variant="cpp")))


def test_case209_stages_and_envelope():
    img = case("case209")
    mag = golden.gradient(img)
    blurred_g, rtv_g = golden.compute_blur_and_rtv(img, mag, 7)
    blurred, rtv = tbt._blur_and_rtv_math(torch.from_numpy(img).float(),
                                          torch.from_numpy(mag), 7)
    np.testing.assert_array_equal(blurred.numpy(), blurred_g)
    np.testing.assert_array_equal(rtv.numpy(), rtv_g)
    guide = tbt._guide_math(blurred, rtv, 7).numpy()
    assert diff(guide, golden.compute_guide(blurred_g, rtv_g, 7)).max() <= 1

    got = vt.bilateral_texture_filter(img, 7, 3, device="cpu").numpy()
    np.testing.assert_array_equal(got, golden.bilateral_texture_filter(img, 7, 3))

    got = vt.bilateral_texture_filter(img, 7, 3, variant="cpp", device="cpu").numpy()
    d = diff(got, jax_btf(img, 7, 3, impl="xla", variant="cpp"))
    psnr = 10 * np.log10(255.0 ** 2 / max(float((d.astype(np.float64) ** 2).mean()), 1e-12))
    assert d.max() <= 64 and psnr >= 28.0, (int(d.max()), psnr)
