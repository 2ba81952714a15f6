"""The port's plain guide on inputs full of ties, on the CPU, against the
JAX package: its Pallas kernel (interpret mode), whose argmin is the TPU
kernel's separable one (a strict-< row pass, then a strict-< column pass),
and its xla ``_guide_math``, which scans the taps in (ky, kx) order.  Random
images hold almost no ties; here windows hold equal minima in different
rows and columns and whole flat windows, and the blurred image differs by
tap, so a pick that breaks a tie the other way moves the output by tens.
The envelope is 1 u8, as in tests/test_torch_bilateral_texture.py: exp is
another implementation on each side.  The CUDA kernel is held to the plain
version at 0 on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from guide_ties import tie_inputs  # noqa: E402
from various_image_processings_tpu.ops import bilateral_texture as jbt  # noqa: E402
from various_image_processings_tpu.ops.pallas.bilateral_texture import guide_pallas  # noqa: E402
from various_image_processings_tpu_torch.ops import bilateral_texture as tbt  # noqa: E402


def diff(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("ksize", [1, 3, 9, 15])
@pytest.mark.parametrize("shape", [(21, 34), (16, 9)])
def test_plain_guide_on_ties_within_1_of_jax(shape, ksize):
    blurred, rtv = tie_inputs(*shape, seed=shape[0] * shape[1])
    got = tbt._guide_math(torch.from_numpy(blurred), torch.from_numpy(rtv), ksize).numpy()
    pallas = guide_pallas(jnp.asarray(blurred), jnp.asarray(rtv), ksize)
    assert diff(got, pallas).max() <= 1
    xla = jax.jit(lambda b, r: jbt._guide_math(b, r, ksize, strict=True))(
        jnp.asarray(blurred), jnp.asarray(rtv))
    assert diff(got, xla).max() <= 1


def test_tie_inputs_separate_the_scan_orders():
    """The inputs are fit for the purpose: picking the first minimum in
    (kx, ky) order instead of (ky, kx) moves many pixels by tens."""
    blurred, rtv = tie_inputs(21, 34, seed=21 * 34)
    want = tbt._guide_math(torch.from_numpy(blurred), torch.from_numpy(rtv), 9).numpy()
    transposed = tbt._guide_math(torch.from_numpy(blurred.transpose(1, 0, 2).copy()),
                                 torch.from_numpy(rtv.T.copy()), 9).numpy().transpose(1, 0, 2)
    moved = diff(want, transposed).max(axis=2)
    assert (moved >= 10).sum() > 0.1 * moved.size
