"""The PyTorch port's core/ twins pinned to the JAX package's, and the
port's import isolation (it must run where jax is not installed)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from various_image_processings_tpu.core import luts as jluts  # noqa: E402
from various_image_processings_tpu.core import pad as jpad  # noqa: E402
from various_image_processings_tpu.core import rng as jrng  # noqa: E402
from various_image_processings_tpu.ops.bilateral import nonzero_taps as jnonzero_taps  # noqa: E402
from various_image_processings_tpu_torch.core import luts, pad, rng  # noqa: E402
from various_image_processings_tpu_torch.ops.bilateral import nonzero_taps  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "various_image_processings_tpu_torch"


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("ksize,sigma", [(1, 10.0), (3, 0.5), (9, 10.0), (17, 8.0),
                                         (27, 10.0), (31, 3.3)])
def test_space_kernel_matches_jax(ksize, sigma):
    np.testing.assert_array_equal(bits(luts.space_kernel(ksize, sigma)),
                                  bits(jluts.space_kernel(ksize, sigma)))


@pytest.mark.parametrize("sigma", [30.0, 3.0 ** 0.5, 0.7, 10.0, 100.0])
def test_color_table_and_coeff_match_jax(sigma):
    assert luts.COLOR_TABLE_SIZE_BILATERAL == jluts.COLOR_TABLE_SIZE_BILATERAL
    np.testing.assert_array_equal(bits(luts.color_table(sigma)), bits(jluts.color_table(sigma)))
    assert bits(luts.gauss_coeff_f32(sigma)) == bits(jluts.gauss_coeff_f32(sigma))


@pytest.mark.parametrize("ksize,sigma", [(1, 10.0), (9, 10.0), (17, 8.0), (27, 10.0),
                                         (9, 0.2)])
def test_tap_table_is_jax_nonzero_taps(ksize, sigma):
    """The kernel's tap table holds exactly the JAX path's taps, in order."""
    expected = jnonzero_taps(ksize, sigma)
    table = luts.tap_table(luts.space_kernel(ksize, sigma))
    assert table.dtype == np.int32 and table.shape == (len(expected), 4)
    got = [(int(dy), int(dx), np.int32(wb).view(np.float32)) for dy, dx, wb, _ in table]
    assert [(dy, dx) for dy, dx, _ in got] == [(dy, dx) for dy, dx, _ in expected]
    np.testing.assert_array_equal(bits([w for _, _, w in got]), bits([w for _, _, w in expected]))
    assert [(dy, dx, bits(w)) for dy, dx, w in nonzero_taps(ksize, sigma)] == \
        [(dy, dx, bits(w)) for dy, dx, w in expected]


@pytest.mark.parametrize("seed", [42, 5489, 0])
@pytest.mark.parametrize("count", [1, 623, 624, 625, 3 * 624 + 5])
def test_mt19937_stream_matches_jax(seed, count):
    np.testing.assert_array_equal(rng.MT19937(seed).raw(count), jrng.MT19937(seed).raw(count))


@pytest.mark.parametrize("shape", [(50, 50), (37, 61), (8, 5), (1, 1), (64, 64, 1)])
def test_random_image_matches_jax(shape):
    np.testing.assert_array_equal(rng.random_image(*shape), jrng.random_image(*shape))


def test_random_array_float_and_modulus_match_jax():
    np.testing.assert_array_equal(bits(rng.random_array(1000, 1.0, np.float32)),
                                  bits(jrng.random_array(1000, 1.0, np.float32)))
    np.testing.assert_array_equal(rng.random_array(999, 7, np.int32),
                                  jrng.random_array(999, 7, np.int32))


@pytest.mark.parametrize("n,lo,hi", [(1, 3, 3), (2, 5, 4), (5, 2, 2), (5, 12, 9), (8, 8, 8)])
def test_reflect101_indices_match_jax(n, lo, hi):
    np.testing.assert_array_equal(pad.reflect101_indices(n, lo, hi),
                                  jpad.reflect101_indices(n, lo, hi))


def test_round_up_and_cdiv_match_jax():
    for a in range(0, 40):
        for b in (1, 3, 8, 128):
            assert pad.round_up(a, b) == jpad.round_up(a, b)
            assert pad.cdiv(a, b) == jpad.cdiv(a, b)


@pytest.mark.parametrize("shape,r", [((8, 5, 3), 4), ((8, 5, 3), 13), ((1, 6, 3), 2),
                                     ((7, 1, 3), 3), ((3, 4), 0)])
def test_reflect101_pad_matches_jax(shape, r):
    x = np.random.default_rng(0).integers(0, 255, shape).astype(np.float32)
    expected = np.asarray(jpad.reflect101_pad(jnp.asarray(x), r, 0, 1))
    np.testing.assert_array_equal(pad.reflect101_pad(torch.from_numpy(x), r, 0, 1).numpy(),
                                  expected)


@pytest.mark.parametrize("pads,axis", [((2, 3, 1, 4), 0), ((0, 0, 5, 0), 0),
                                       ((9, 9, 9, 9), 0), ((1, 2, 3, 4), 1)])
def test_replicate_pad_matches_jax(pads, axis):
    x = np.random.default_rng(1).integers(0, 255, (3, 6, 5)).astype(np.float32)
    expected = np.asarray(jpad.replicate_pad(jnp.asarray(x), *pads, axis=axis))
    np.testing.assert_array_equal(pad.replicate_pad(torch.from_numpy(x), *pads, axis=axis).numpy(),
                                  expected)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    imports = re.compile(r"^\s*(import|from)\s+(jax\b|various_image_processings_tpu\b(?!_torch))",
                         re.MULTILINE)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if imports.search(p.read_text())]
    assert offenders == []


def test_port_imports_without_jax():
    """Every module of the port imports with jax and the JAX package blocked."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['various_image_processings_tpu'] = None\n"
        "import various_image_processings_tpu_torch as vt\n"
        "names = [m.name for m in pkgutil.walk_packages(vt.__path__, vt.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15
