"""The port's namespaces against the JAX package's, and its import isolation.

- Every public name that a JAX namespace binds in its ``__init__.py`` (the
  top level, ``core``, ``utils``, ``ops``, ``models``, ``parallel``,
  ``cli``), and every public submodule it has, resolves in the port's
  counterpart.  Two names stay out on purpose: ``golden`` (the tests'
  oracle) and ``ops.pallas`` (the TPU kernels, whose port is ``ops.cuda``).
- ``core.replicate_pad_np`` equals the JAX package's on u8 and f32 HW and
  HWC arrays.
- No module of the port, nor ``chip_smoke.py``, imports ``jax`` or the JAX
  package, at top level or inside a function; importing every module of the
  port loads neither and builds nothing."""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from various_image_processings_tpu.core import pad as jpad
from various_image_processings_tpu_torch.core import replicate_pad_np

REPO = Path(__file__).resolve().parents[1]
JAX_DIR = REPO / "various_image_processings_tpu"
PORT_DIR = REPO / "various_image_processings_tpu_torch"
NAMESPACES = ("", "core", "utils", "ops", "models", "parallel", "cli")
LEFT_OUT = {("", "golden"), ("ops", "pallas")}


def bound_names(init: Path) -> set[str]:
    """Names an ``__init__.py`` binds at its top level."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return names


def public_names() -> list[tuple[str, str, bool]]:
    """(namespace, name, is a submodule) of every public JAX name."""
    out = []
    for ns in NAMESPACES:
        folder = JAX_DIR / ns
        subs = {m.name for m in pkgutil.iter_modules([str(folder)])}
        for name in sorted(bound_names(folder / "__init__.py") | subs):
            if not name.startswith("_") and (ns, name) not in LEFT_OUT:
                out.append((ns, name, name in subs))
    return out


@pytest.mark.parametrize("ns,name,submodule", public_names(),
                         ids=lambda v: v if isinstance(v, str) and v else None)
def test_jax_public_name_resolves_in_the_port(ns, name, submodule):
    module = importlib.import_module(".".join(filter(None, ["various_image_processings_tpu_torch",
                                                            ns])))
    if submodule:
        importlib.import_module(f"{module.__name__}.{name}")
    assert hasattr(module, name), f"{module.__name__} lacks {name}"


def test_the_named_imports_work():
    from various_image_processings_tpu_torch.utils import imread, measure, native

    import various_image_processings_tpu_torch as vt
    assert callable(imread) and callable(measure) and callable(native.load_library)
    assert vt.utils.trace is vt.utils.profiling.trace
    assert vt.core.pre_compute_kernels is vt.core.luts.pre_compute_kernels


@pytest.mark.parametrize("radius", [0, 1, 6])
@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3), (1, 1), (3, 2, 1)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_replicate_pad_np_equals_jax(dtype, shape, radius):
    rng = np.random.default_rng(sum(shape) + radius)
    img = (rng.integers(0, 256, shape) if dtype == np.uint8
           else rng.standard_normal(shape)).astype(dtype)
    got, want = replicate_pad_np(img, radius), jpad.replicate_pad_np(img, radius)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def port_sources() -> list[str]:
    files = sorted(str(p.relative_to(REPO)) for p in PORT_DIR.rglob("*.py"))
    return files + ["chip_smoke.py"]


@pytest.mark.parametrize("path", port_sources())
def test_port_source_imports_no_jax(path):
    """Every import statement, also one inside a function."""
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        for root in roots:
            assert root not in ("jax", "jaxlib", "various_image_processings_tpu"), \
                f"{path}:{node.lineno} imports {root}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import importlib, pkgutil, sys\n"
        "import various_image_processings_tpu_torch as vt\n"
        "for m in pkgutil.walk_packages(vt.__path__, vt.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from various_image_processings_tpu_torch.ops.cuda import _build\n"
        "from various_image_processings_tpu_torch.utils import native\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'various_image_processings_tpu'))\n"
        "print(bad, _build.load_library.cache_info().currsize,\n"
        "      native.load_library.cache_info().currsize)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]", "0", "0"]
