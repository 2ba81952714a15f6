"""ctypes loader for the native host runtime, ``native/src/vip_native.cpp``.

The port's own loader (the JAX package's is ``utils/native.py`` there): it
compiles the C++ source with ``g++`` and ``native/Makefile``'s flags less
``-fopenmp`` at first use into the port's ``_build/`` directory, under a
name that carries a hash of the source and the flags, so an edited source
is never served by a stale build.  The build writes a per-process
temporary file and renames it into place, so processes that build at once
never load a partial file.  Nothing falls back: a missing compiler or a
failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops.cuda._build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "native" / "src" / "vip_native.cpp"
# No -fopenmp: some toolchains ship g++ without libgomp, and could not build
# the source with it.  The source guards its OpenMP pragmas with _OPENMP,
# and its results do not depend on them.
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-Wall", "-Wextra", "-shared")

_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "vip_ccl_4conn": (ctypes.c_int, [_I32, ctypes.c_int, ctypes.c_int, _I32]),
    "vip_component_sums": (None, [_I32, _U8, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64]),
    "vip_bgr2lab_u8": (None, [_U8, ctypes.c_int64, _I32, _I32, _I32, _U8]),
    "vip_slic_merge": (None, [_I32, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I64, _I64,
                              ctypes.c_int64, _I32]),
    "vip_slic_connectivity": (ctypes.c_int, [_I32, _U8, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int64, _I32]),
}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: set CXX or put g++ on PATH")
    return found


def library_path() -> Path:
    if not SOURCE.is_file():
        raise RuntimeError(f"native source not found: {SOURCE}")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvip_native_{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.so.tmp"
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed with exit code "
                               f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    finally:
        tmp.unlink(missing_ok=True)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if this source hash has no library yet) and load the runtime."""
    lib = library_path()
    if not lib.exists():
        _build(lib)
    cdll = ctypes.CDLL(str(lib))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return cdll


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def ccl_4conn(labels: np.ndarray) -> tuple[np.ndarray, int]:
    """(H, W) int32 labels → ((H, W) int32 4-connected components numbered in
    raster first-encounter order, their count)."""
    labels = np.ascontiguousarray(labels, np.int32)
    h, w = labels.shape
    comp = np.empty_like(labels)
    ncomp = load_library().vip_ccl_4conn(_ptr(labels, _I32), h, w, _ptr(comp, _I32))
    return comp, int(ncomp)


def component_sums(comp: np.ndarray, img: np.ndarray, ncomp: int) -> np.ndarray:
    """(ncomp, 6) int64 per-component sums of (x, y, c0, c1, c2, 1)."""
    comp = np.ascontiguousarray(comp, np.int32)
    img = np.ascontiguousarray(img, np.uint8)
    h, w = comp.shape
    if img.shape != (h, w, 3):
        raise ValueError(f"image shape {img.shape} does not match components {comp.shape}")
    if comp.size and (comp.min() < 0 or comp.max() >= ncomp):
        raise ValueError(f"component ids must lie in [0, {ncomp})")
    sums = np.empty((ncomp, 6), np.int64)
    load_library().vip_component_sums(_ptr(comp, _I32), _ptr(img, _U8), h, w, ncomp,
                                      _ptr(sums, _I64))
    return sums


def bgr2lab_u8(img: np.ndarray, gamma_tab: np.ndarray, cbrt_tab: np.ndarray,
               coeffs: np.ndarray) -> np.ndarray:
    """(..., 3) u8 BGR → (..., 3) u8 Lab through the native exact loop, with
    the tables of ``core/colors.py:_lab_tables``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) BGR, got shape {img.shape}")
    tables = [np.ascontiguousarray(t, np.int32) for t in (gamma_tab, cbrt_tab, coeffs)]
    out = np.empty_like(img)
    load_library().vip_bgr2lab_u8(_ptr(img, _U8), img.size // 3,
                                  *(_ptr(t, _I32) for t in tables), _ptr(out, _U8))
    return out


def slic_merge(comp: np.ndarray, means: np.ndarray, sizes: np.ndarray,
               min_area: int) -> np.ndarray:
    """(H, W) int32 components + (N, 3) int64 truncated Lab means + (N,) int64
    sizes → (N,) int32 merged root of every component (euclidean metric)."""
    comp = np.ascontiguousarray(comp, np.int32)
    means = np.ascontiguousarray(means, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    h, w = comp.shape
    n = means.shape[0]
    if means.shape != (n, 3) or sizes.shape != (n,):
        raise ValueError(f"means {means.shape} and sizes {sizes.shape} must be (N, 3) and (N,)")
    if comp.size and (comp.min() < 0 or comp.max() >= n):
        raise ValueError(f"component ids must lie in [0, {n})")
    mapping = np.empty(n, np.int32)
    load_library().vip_slic_merge(_ptr(comp, _I32), h, w, n, _ptr(means, _I64),
                                  _ptr(sizes, _I64), int(min_area), _ptr(mapping, _I32))
    return mapping


def slic_connectivity(labels: np.ndarray, lab: np.ndarray, min_area: int) -> np.ndarray:
    """SLIC's connectivity pass for the euclidean metric in one call: (H, W)
    int32 k-means labels + (H, W, 3) u8 Lab image → (H, W) int32 region
    labels in raster first-encounter order (components, their Lab means,
    merging of those below ``min_area`` into the closest neighbour, and
    compaction)."""
    labels = np.ascontiguousarray(labels, np.int32)
    lab = np.ascontiguousarray(lab, np.uint8)
    h, w = labels.shape
    if lab.shape != (h, w, 3):
        raise ValueError(f"Lab image shape {lab.shape} does not match labels {labels.shape}")
    out = np.empty_like(labels)
    n = load_library().vip_slic_connectivity(_ptr(labels, _I32), _ptr(lab, _U8), h, w,
                                             int(min_area), _ptr(out, _I32))
    if n < 0:
        raise ValueError(f"vip_slic_connectivity refused a {h}x{w} label map")
    return out
