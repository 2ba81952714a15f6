"""The PyTorch port's adaptive bilateral filter against the JAX package's xla
and pallas paths (pallas in interpret mode on the CPU), inside the envelopes
the JAX tests hold those paths to against golden/ (tests/test_bilateral.py):
the port's plain version is bit-exact to golden/
(tests/test_torch_adaptive_bilateral.py), the JAX paths are not."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu.ops.adaptive_bilateral import (  # noqa: E402
    adaptive_bilateral_filter as jax_abf)
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402

from test_torch_adaptive_bilateral import (  # noqa: E402
    BAND_POINTS, UNDERFLOW_POINTS, diff, port, underflow_image)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_within_one_of_jax_at_k9(impl):
    src = random_image(50, 50)
    assert diff(port(src, 9, 10.0, 30.0), jax_abf(src, 9, 10.0, 30.0, impl=impl)).max() <= 1


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_flips_beyond_one_rare_against_jax_at_k3(impl):
    src = random_image(50, 50)
    assert (diff(port(src, 3, 10.0, 30.0), jax_abf(src, 3, 10.0, 30.0, impl=impl)) > 1).mean() < 1e-3


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("point", range(len(BAND_POINTS)))
def test_band_points_inside_the_jax_envelope(point, impl):
    k, ss, sc, h, w = BAND_POINTS[point]
    img = random_image(h, w)
    d = diff(port(img, k, ss, sc), jax_abf(img, k, ss, sc, impl=impl))
    assert d.max() <= 8 and (d > 2).sum() <= 8


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("point", range(len(UNDERFLOW_POINTS)))
def test_underflow_points_inside_the_jax_envelope(point, impl):
    k, ss, sc, _, _ = UNDERFLOW_POINTS[point]
    img = underflow_image(point)
    d = diff(port(img, k, ss, sc), jax_abf(img, k, ss, sc, impl=impl))
    assert d.max() <= 4 and (d > 1).sum() <= 4
