"""Build the package's CUDA sources and load them with ctypes.

Every ``csrc/*.cu`` is compiled by ``nvcc`` into one shared library with a
plain C interface, at first use, into ``_build/`` beside ``csrc/``.  The
library's name carries a hash of the sources and flags, so an edited source
is never served by a stale build.  Nothing here falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a: Hopper with its architecture-specific features.  No
# -use_fast_math: it would turn on FTZ and approximate division, and the
# kernels are held bit-exact to the golden layer.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvip_kernels_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if this source hash has no library yet) and load the kernels."""
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    return ctypes.CDLL(str(lib))
