"""The port's CIEDE2000 metrics (``core/ciede2000.py``) against the JAX
package's and golden/.

- the Sharma et al. (2005) pairs, to 1e-3 in ΔE;
- both torch metrics against the JAX package's on seeded Lab triples, with
  the JAX package's own tolerance (tests/test_ciede2000.py: rtol 5e-4,
  atol 5e-2): the transcendentals differ by ulps between libraries;
- the NumPy π-scaled copy bit-equal to golden/ciede2000_ref.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from various_image_processings_tpu.core import ciede2000 as jde  # noqa: E402
from various_image_processings_tpu.golden.ciede2000_ref import (  # noqa: E402
    ciede2000_ref_square as golden_ref)
from various_image_processings_tpu_torch.core import ciede2000 as de  # noqa: E402

# (L1, a1, b1, L2, a2, b2, expected ΔE00) — Sharma, Wu, Dalal (2005) Table 1
SHARMA_CASES = [
    (50.0000, 2.6772, -79.7751, 50.0000, 0.0000, -82.7485, 2.0425),
    (50.0000, 3.1571, -77.2803, 50.0000, 0.0000, -82.7485, 2.8615),
    (50.0000, 2.8361, -74.0200, 50.0000, 0.0000, -82.7485, 3.4412),
    (50.0000, -1.3802, -84.2814, 50.0000, 0.0000, -82.7485, 1.0000),
    (50.0000, 2.5000, 0.0000, 50.0000, 0.0000, -2.5000, 4.3065),
    (50.0000, 2.5000, 0.0000, 73.0000, 25.0000, -18.0000, 27.1492),
    (50.0000, 2.5000, 0.0000, 50.0000, 3.2592, 0.3350, 1.0000),
    (63.0109, -31.0961, -5.8663, 62.8187, -29.7946, -4.0864, 1.2630),
    (90.8027, -2.0831, 1.4410, 91.1528, -1.6435, 0.0447, 1.4441),
    (2.0776, 0.0795, -1.1350, 0.9033, -0.0636, -0.5514, 0.9082),
]


def lab_triples(seed: int, n: int = 4096) -> np.ndarray:
    """(n, 6) int32 Lab pairs over the 8-bit Lab range and beyond (negative
    a, b), with equal pairs and zero chroma included."""
    v = np.random.default_rng(seed).integers(-255, 256, (n, 6)).astype(np.int32)
    v[: n // 16, 3:] = v[: n // 16, :3]
    v[n // 16: n // 8, 1:3] = 0
    return v


@pytest.mark.parametrize("case", SHARMA_CASES)
def test_sharma_values(case):
    *lab, expected = case
    got = float(torch.sqrt(de.ciede2000_square(*lab)))
    assert abs(got - expected) < 1e-3


@pytest.mark.parametrize("name", ["ciede2000_square", "ciede2000_ref_square"])
@pytest.mark.parametrize("seed", [7, 8])
def test_metrics_match_jax(name, seed):
    v = lab_triples(seed)
    ours = getattr(de, name)(*torch.from_numpy(v.T.copy())).numpy()
    theirs = np.asarray(getattr(jde, name)(*v.T))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, rtol=5e-4, atol=5e-2)
    # equal pairs are exactly 0 in both
    assert (ours[: len(v) // 16] == 0).all()


def test_metric_broadcasts_a_center_against_planes():
    """The SLIC association calls the metric with a (C, 1) center against
    (C, P) pixels."""
    v = lab_triples(3, 64)
    center = torch.from_numpy(v[:8, :3].T.copy()).to(torch.float32)[:, :, None]
    pix = torch.from_numpy(v[:, 3:].T.copy()).to(torch.float32)[:, None, :]
    got = de.ciede2000_square(*center, *pix)
    assert tuple(got.shape) == (8, 64)
    want = de.ciede2000_square(*(c.expand(8, 64) for c in center), *(p.expand(8, 64) for p in pix))
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [7, 11])
def test_ref_numpy_copy_bit_equal_to_golden(seed):
    v = lab_triples(seed)
    ours = de.ciede2000_ref_square_np(*v.T)
    np.testing.assert_array_equal(ours.view(np.uint32), golden_ref(*v.T).view(np.uint32))
