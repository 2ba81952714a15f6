"""Build the package's CUDA sources, load them with ctypes, and the checks
and the launch protocol every kernel wrapper shares.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, at first use, into ``_build/`` beside ``csrc/``.  The library's
name carries a hash of the sources, their headers (``csrc/*.cuh``) and the
flags, so an edited source is never served by a stale build.  ``ptxas``'s report (registers, spills, shared
memory of each kernel) is kept beside the library.  Nothing here falls back:
a missing ``nvcc`` or a failed build raises.

``SIGNATURES`` is the library's C ABI, every entry point of ``csrc/*.cu``,
set once by ``load_library``; ``plan`` asks the host-side planners once for
each set of arguments.  A kernel wrapper is decorated with ``kernel_wrapper``
(the span ``cuda_wrappers.<kernel>`` and its module's launch counter) and
enqueues with ``launch``, or ``bind`` where a loop launches the same
arguments again and again (the span ``enqueue.<kernel>``, the device guard,
the current stream, the error).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

import torch

from ...utils.profiling import SPANS

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a: Hopper with its architecture-specific features.  No
# -use_fast_math: it would turn on FTZ and approximate division, and the
# kernels are held bit-exact to the golden layer.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# shared memory one block can use on sm_90 (227 KB)
MAX_SMEM_BYTES = 232448


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
    """The library's path, named by a hash of the flags and of every source
    and header (``*.cuh``) in csrc/."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted((*sources(), *CSRC_DIR.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvip_kernels_{digest.hexdigest()[:16]}.so"


def ptxas_report() -> str:
    """What ``nvcc -Xptxas -v`` said when the current library was built."""
    return library_path().with_suffix(".log").read_text()


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise if any fails.  Every process is
    waited for (or killed) before this returns."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outputs = [proc.communicate()[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outputs)


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(exist_ok=True)
    stem = f"{lib.stem}.{os.getpid()}"  # per process: concurrent builds never share a file
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources()]
    tmp = BUILD_DIR / f"{stem}.so.tmp"
    try:
        log = _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources(), objs)])
        _run_all([[nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent process never loads a partial file
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# name -> (restype, argtypes) of every extern "C" function of csrc/*.cu, by
# source, in the order of its C parameters: the definitions name them.  A
# launcher returns a cudaError_t and takes its stream last (vip_btf_u8 next
# to last, before the int it writes how many kernels it enqueued to).
SIGNATURES = {
    # adaptive_bilateral.cu
    "vip_adaptive_bilateral_smem_bytes": (_LL, [_I]),
    "vip_adaptive_bilateral_band": (_I, [_I, _I]),
    "vip_adaptive_bilateral_u8": (_I, [_P, _P, _I, _I, _P, _I, _P, _I, _P]),
    # bilateral.cu
    "vip_bilateral_smem_bytes": (_LL, [_I, _I, _I]),
    "vip_bilateral_columns_per_thread": (_I, [_I, _I]),
    "vip_bilateral_pixels_per_thread": (_I, [_I, _I]),
    "vip_bilateral_band": (_I, [_I, _I, _I]),
    "vip_bilateral_path": (_I, [_I, _I, _I]),
    "vip_bilateral_u8": (_I, [_P, _P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _P]),
    "vip_cuda_error_string": (ctypes.c_char_p, [_I]),
    # bilateral_texture.cu
    "vip_blur_rtv_smem_bytes": (_LL, [_I]),
    "vip_guide_smem_bytes": (_LL, [_I]),
    "vip_blur_rtv_band": (_I, [_I, _I]),
    "vip_guide_band": (_I, [_I, _I]),
    "vip_blur_rtv": (_I, [_P, _P, _P, _P, _I, _I, _I, _F, _P]),
    "vip_guide": (_I, [_P, _P, _P, _I, _I, _I, _F, _P]),
    # btf_pipeline.cu
    "vip_btf_u8": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I, _F, _F,
                        _P, ctypes.POINTER(_I)]),
    # gradient.cu
    "vip_gradient": (_I, [_P, _P, _I, _I, _I, _I, _P]),
    # slic_kmeans.cu
    "vip_slic_association": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                  _F, _I, _P]),
    "vip_slic_snap_keys": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "vip_slic_update": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "vip_slic_association_blocks": (_I, [_I, _I]),
    "vip_slic_association_occupancy": (_I, [_I]),
    "vip_slic_delta_e": (_I, [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _P]),
    # wexler_fill.cu
    "vip_wexler_fill_max_cap": (_I, []),
    "vip_wexler_diffusion_cluster": (_I, [_I, _I]),
    "vip_wexler_diffusion_smem_bytes": (_I, [_I, _I]),
    "vip_wexler_ring_pick": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "vip_wexler_filters": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                _P]),
    "vip_wexler_commit": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "vip_wexler_diffusion": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]),
    # wexler_search.cu
    "vip_wexler_search_target_tile": (_I, []),
    "vip_wexler_search_row_tile": (_I, []),
    "vip_wexler_search_smem_bytes": (_I, []),
    "vip_wexler_search": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if this source hash has no library yet) and load the kernels,
    every entry point typed by ``SIGNATURES``."""
    lib = library_path()
    if not lib.exists():
        _build(lib)
    cdll = ctypes.CDLL(str(lib))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return cdll


@functools.lru_cache(maxsize=1024)
def plan(entry: str, *args: int) -> int:
    """What the library's host-side planner ``entry`` (``*_smem_bytes``,
    ``*_band``, the bilateral kernel's path and columns, the Wexler tiles
    and cluster) answers for ``args``: a function of its arguments alone, so
    asked once for each."""
    return getattr(load_library(), entry)(*args)


def kernel_wrapper(kernel: str, counter: str | None = "launches",
                   namespace: dict | None = None) -> Callable:
    """Decorate a kernel wrapper: its call is the span
    ``cuda_wrappers.<kernel>``, closed also when it raises, and the int
    ``counter`` of ``namespace`` (the wrapper's module) rises by one when it
    returns.  ``counter=None``: the wrapper counts its launches itself."""
    span = "cuda_wrappers." + kernel

    def decorate(fn: Callable) -> Callable:
        module = fn.__globals__ if namespace is None else namespace

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            w = SPANS.open(span) if SPANS.on else -1
            try:
                out = fn(*args, **kwargs)
                if counter is not None:
                    module[counter] += 1
                return out
            finally:
                if w >= 0:
                    SPANS.close(w)

        return wrapped

    return decorate


def enqueue(fn, args: tuple, kernel: str) -> None:
    """``fn(*args)``: one ctypes call into the library, which enqueues a
    kernel on the stream among its arguments, recorded as the span
    ``enqueue.<kernel>``.  Raises if the launch returned a cudaError_t other
    than cudaSuccess."""
    s = SPANS.open("enqueue." + kernel) if SPANS.on else -1
    try:
        err = fn(*args)
        if err != 0:
            raise launch_error(kernel, err)
    finally:
        if s >= 0:
            SPANS.close(s)


def launch(entry: str, kernel: str, like: torch.Tensor, *args) -> None:
    """Enqueue the library's ``entry`` with ``args`` and PyTorch's current
    stream on ``like``'s device, under that device's guard (``enqueue``)."""
    args = (*args, torch.cuda.current_stream(like.device).cuda_stream)
    with torch.cuda.device(like.device):
        enqueue(getattr(load_library(), entry), args, kernel)


def bind(entry: str, kernel: str, like: torch.Tensor, *args) -> Callable[[], None]:
    """``launch`` with everything looked up now: a function that enqueues
    ``entry`` with ``args`` on the stream current now on ``like``'s device."""
    fn, args = getattr(load_library(), entry), (*args, stream_of(like))
    device = torch.cuda.device(like.device)

    def go() -> None:
        with device:
            enqueue(fn, args, kernel)

    return go


def launch_error(kernel: str, err: int) -> RuntimeError:
    """The error a launch of ``kernel`` that returned the cudaError_t ``err`` raises."""
    msg = load_library().vip_cuda_error_string(err).decode()
    return RuntimeError(f"{kernel} kernel launch failed: {msg} (cudaError_t {err})")


def check_tensor(name: str, t: torch.Tensor, dtypes: tuple, ndims: tuple) -> None:
    """A kernel argument: a contiguous CUDA tensor of one of ``dtypes`` with
    one of ``ndims`` dimensions."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.ndim not in ndims:
        raise ValueError(f"{name} must have {' or '.join(map(str, ndims))} dimensions, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_color_image(name: str, t: torch.Tensor) -> None:
    """An (H, W, 3) u8 image, contiguous, on the card."""
    check_tensor(name, t, (torch.uint8,), (3,))
    if t.shape[2] != 3:
        raise ValueError(f"{name} must be an (H, W, 3) color image, got shape {tuple(t.shape)}")


def check_table(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    """A host-built table a kernel reads: contiguous, of one dtype and shape,
    on the image's device."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def check_taps(taps: torch.Tensor, device) -> None:
    """An (n, 4) int32 tap table (core.luts.tap_table), read as one int4 a tap."""
    if taps.ndim != 2 or taps.shape[0] < 1:
        raise ValueError(f"taps must be an (n, 4) tap table, got shape {tuple(taps.shape)}")
    check_table("taps", taps, torch.int32, (taps.shape[0], 4), device)
    if taps.data_ptr() % 16 != 0:
        raise ValueError("taps must be 16-byte aligned (the kernel reads one int4 per tap)")


def check_smem(kernel: str, ksize: int, smem: int) -> None:
    """A guard: every kernel plans its shared memory (the whole halo tile, or
    one band of it) to fit, for every ksize."""
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{kernel} ksize {ksize}: the kernel planned {smem} bytes of shared "
                         f"memory a block, above the {MAX_SMEM_BYTES} a block can use")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the pointer kernels take."""
    return torch.cuda.current_stream(t.device).cuda_stream
