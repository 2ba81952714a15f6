"""The bilateral texture filter's single native call (csrc/btf_pipeline.cu,
``ops.cuda.bilateral_texture.texture_filter``).

On the CPU: the workspace layout, the launch accounting and the error of a
call that stops part way (a fake library), the C declarations against the
kernels' definitions, the routing of ``_btf``, and the C entry point's schedule, compiled with g++
against stub launchers that record what they were given.  On the card
(marker ``cuda``): the single call byte-equal to the per-stage loop and to
the plain path, its counters, and the callers that take it.  Imports
neither jax nor the JAX package."""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import various_image_processings_tpu_torch as vt  # noqa: E402
from various_image_processings_tpu_torch import parallel as tpar  # noqa: E402
from various_image_processings_tpu_torch.core.rng import random_image  # noqa: E402
from various_image_processings_tpu_torch.ops import bilateral_texture as obt  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import _build  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral as kbf  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as kbt  # noqa: E402
from various_image_processings_tpu_torch.ops.cuda import gradient as kgr  # noqa: E402
from test_torch_cuda_build import c_parameters  # noqa: E402

CSRC = _build.CSRC_DIR
PIPELINE = CSRC / "btf_pipeline.cu"

# ---------------------------------------------------------------------------
# the workspace layout
# ---------------------------------------------------------------------------

# (magnitude, blurred, rtv, guide, image): bytes a pixel
REGION_BYTES = (4, 12, 4, 3, 3)


@pytest.mark.parametrize("shape", [(1, 1), (17, 901), (600, 900), (2160, 3840), (3, 5),
                                   (45, 38), (20, 32), (1, 901)])
def test_workspace_regions_are_aligned_disjoint_and_exact(shape):
    offsets, size = kbt.workspace_layout(*shape)
    sizes = [b * shape[0] * shape[1] for b in REGION_BYTES]
    assert len(offsets) == 5 and offsets[0] == 0
    assert all(o % 256 == 0 for o in offsets)
    for i in range(4):
        end = offsets[i] + sizes[i]
        assert end <= offsets[i + 1] < end + 256  # disjoint, in order, no more padding than needed
    assert size == offsets[4] + sizes[4]


# ---------------------------------------------------------------------------
# the launch accounting and the error of a call that stops part way
# ---------------------------------------------------------------------------

class FakeLibrary:
    """``vip_btf_u8`` enqueues ``went_in`` kernels of its 4·nitr and fails
    there with cudaErrorInvalidConfiguration (9), or returns 0 if all went in."""

    def __init__(self, went_in: int):
        self.went_in = went_in
        self.calls = 0

    def vip_btf_u8(self, *args):
        self.calls += 1
        total = 4 * args[10]
        args[-1].value = min(self.went_in, total)
        return 9 if self.went_in < total else 0

    @staticmethod
    def vip_cuda_error_string(err):
        return b"invalid configuration argument"


def counters() -> list[int]:
    return [kgr.launches, kbt.blur_rtv_launches, kbt.guide_launches, kbf.launches,
            kbf.blocked_calls, kbt.single_calls, kbf.unrolled_calls]


def enqueue_rise(monkeypatch, went_in: int, path: int) -> list[int]:
    """The counters' rise over one ``_enqueue_texture_filter`` call of nitr
    3 whose joint filter takes ``path``, on a library that enqueues
    ``went_in`` kernels; a call that stops part way raises, naming the
    kernel that failed."""
    fake = FakeLibrary(went_in)
    monkeypatch.setattr(_build, "load_library", lambda: fake)
    args = (0,) * 10 + (3,) + (0,) * 8 + (ctypes.c_int(),)  # nitr 3
    before = counters()
    if went_in < 12:
        kernel = kbt.KERNELS[went_in % 4]
        with pytest.raises(RuntimeError, match=rf"^{kernel} kernel launch failed: invalid "
                                               r"configuration argument \(cudaError_t 9\)$"):
            kbt._enqueue_texture_filter(args, path)
    else:
        kbt._enqueue_texture_filter(args, path)
    assert fake.calls == 1
    return [b - a for a, b in zip(before, counters())]


def kernels_in(went_in: int) -> list[int]:
    """Each kernel's launches among the first ``went_in`` of a call: an
    iteration launches its 4 kernels in order."""
    want = [0] * 4
    for i in range(went_in):
        want[i % 4] += 1
    return want


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("went_in", range(13))
def test_counters_rise_by_the_kernels_that_went_in(monkeypatch, went_in, blocked):
    want = kernels_in(went_in)
    want += [want[3] if blocked else 0, 1, 0]
    path = kbf.BLOCKED if blocked else kbf.FOUR_PIXELS
    assert enqueue_rise(monkeypatch, went_in, path) == want


@pytest.mark.parametrize("went_in", range(13))
def test_unrolled_counter_rises_by_the_joint_filters_that_went_in(monkeypatch, went_in):
    """A BTF of window 2 to 5 (joint filter k′ 3 to 9) on the unrolled path:
    ``unrolled_calls`` rises by its joint filters, the launch counters as on
    any other path, ``blocked_calls`` not at all."""
    want = kernels_in(went_in)
    assert enqueue_rise(monkeypatch, went_in, kbf.UNROLLED) == want + [0, 1, want[3]]


# ---------------------------------------------------------------------------
# the C declarations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,source", [("vip_gradient", "gradient.cu"),
                                         ("vip_blur_rtv", "bilateral_texture.cu"),
                                         ("vip_guide", "bilateral_texture.cu"),
                                         ("vip_bilateral_u8", "bilateral.cu")])
def test_declarations_match_the_launchers_definitions(name, source):
    """The linker does not compare a C declaration with its definition:
    the pipeline's must match the launcher's parameter by parameter."""
    declared = c_parameters(PIPELINE.read_text(), name)
    assert declared == c_parameters((CSRC / source).read_text(), name)


# ---------------------------------------------------------------------------
# the routing of _btf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nitr", range(4))
@pytest.mark.parametrize("variant", ["cuda", "cpp"])
def test_btf_takes_the_single_call_for_every_cuda_call_with_iterations(monkeypatch, variant,
                                                                       nitr):
    src = torch.from_numpy(random_image(6, 7))
    taps, lut = obt.jbf_tables(3, src.device)
    calls = []

    def single(*args):
        calls.append(args)
        return "out"

    def stage(*args):
        raise AssertionError("a per-stage wrapper ran")

    monkeypatch.setattr(kbt, "texture_filter", single)
    for name in ("gradient_stage", "blur_rtv_stage", "guide_stage", "jbf_stage"):
        monkeypatch.setattr(obt, name, stage)
    out = obt._btf(src, 3, nitr, "cuda", variant, taps, lut)
    if nitr == 0:
        assert calls == [] and torch.equal(out, src) and out is not src
    else:
        assert out == "out" and len(calls) == 1
        assert calls[0][0] is src and calls[0][1:] == (3, nitr, taps, lut, *obt.VARIANTS[variant])


# ---------------------------------------------------------------------------
# the C entry point's schedule, against stub launchers
# ---------------------------------------------------------------------------

STUBS = r"""
// Stub launchers: each records its call (a kind and 12 values) and returns
// the error set for that call's position, or 0.
#include <cstring>
static long long records[64][13];
static int n_calls = 0;
static int fail_at = -1;

static int record(long long kind, long long a, long long b, long long c, long long d,
                  long long e, long long f = 0, long long g = 0, long long h = 0,
                  long long i = 0, long long j = 0, long long k = 0, long long l = 0) {
  const long long row[13] = {kind, a, b, c, d, e, f, g, h, i, j, k, l};
  std::memcpy(records[n_calls], row, sizeof row);
  return n_calls++ == fail_at ? 700 + static_cast<int>(kind) : 0;
}

static long long p(const void* ptr) { return reinterpret_cast<long long>(ptr); }
static long long bits(float v) { int b; std::memcpy(&b, &v, 4); return b; }

extern "C" {
void stub_reset(int fail) { n_calls = 0; fail_at = fail; }
int stub_calls() { return n_calls; }
const long long* stub_records() { return &records[0][0]; }

int vip_gradient(const void* src, void* out, int height, int width, int channels,
                 int is_float, void* stream) {
  return record(0, p(src), p(out), height, width, channels, is_float, p(stream));
}
int vip_blur_rtv(const void* img, const void* magnitude, void* blurred, void* rtv, int height,
                 int width, int ksize, float epsilon, void* stream) {
  return record(1, p(img), p(magnitude), p(blurred), p(rtv), height, width, ksize,
                bits(epsilon), p(stream));
}
int vip_guide(const void* blurred, const void* rtv, void* guide, int height, int width,
              int ksize, float sigma_alpha, void* stream) {
  return record(2, p(blurred), p(rtv), p(guide), height, width, ksize, bits(sigma_alpha),
                p(stream));
}
int vip_bilateral_u8(const void* src, const void* guide, void* out, int height, int width,
                     const void* taps, int n_taps, const void* lut, int radius, int border,
                     int rounding, void* stream) {
  return record(3, p(src), p(guide), p(out), height, width, p(taps), n_taps, p(lut), radius,
                border, rounding, p(stream));
}
}
"""

# distinct addresses the stubs never dereference
SRC, OUT, MAG, BLUR, RTV, GUIDE, IMAGE, TAPS, LUT, STREAM = (
    0x10000 * (i + 1) for i in range(10))
H, W, K, N_TAPS, BORDER, ROUNDING = 17, 901, 9, 197, 1, 1
EPS, ALPHA = 1e-9, 0.0125


def f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.int32))


@pytest.fixture(scope="module")
def pipeline_on_stubs(tmp_path_factory):
    """btf_pipeline.cu, compiled as C++ with the stub launchers."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the pipeline's host code against stubs")
    tmp = tmp_path_factory.mktemp("btf_pipeline")
    (tmp / "stubs.cpp").write_text(STUBS)
    lib_path = tmp / "libpipeline.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-o", str(lib_path),
                    "-x", "c++", str(PIPELINE), str(tmp / "stubs.cpp")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(lib_path))
    lib.vip_btf_u8.restype, lib.vip_btf_u8.argtypes = _build.SIGNATURES["vip_btf_u8"]
    lib.stub_records.restype = ctypes.POINTER(ctypes.c_longlong)
    lib.stub_reset.argtypes = [ctypes.c_int]
    return lib


def run_pipeline(lib, nitr: int, fail_at: int = -1):
    """(return code, *launched, the stubs' records) of one vip_btf_u8 call."""
    lib.stub_reset(fail_at)
    launched = ctypes.c_int(-1)
    err = lib.vip_btf_u8(SRC, OUT, MAG, BLUR, RTV, GUIDE, IMAGE, H, W, K, nitr, TAPS, N_TAPS,
                         LUT, BORDER, ROUNDING, EPS, ALPHA, STREAM, launched)
    flat = lib.stub_records()
    records = [tuple(flat[13 * i + j] for j in range(13)) for i in range(lib.stub_calls())]
    return err, launched.value, records


def expected_schedule(nitr: int) -> list[tuple]:
    """What btf_iteration launches, nitr times: the image of iteration i
    is the last one's output, and the last iteration writes to OUT."""
    want, img = [], SRC
    for i in range(nitr):
        dst = OUT if (nitr - 1 - i) % 2 == 0 else IMAGE
        want += [(0, img, MAG, H, W, 3, 0, STREAM, 0, 0, 0, 0, 0),
                 (1, img, MAG, BLUR, RTV, H, W, K, f32_bits(EPS), STREAM, 0, 0, 0),
                 (2, BLUR, RTV, GUIDE, H, W, K, f32_bits(ALPHA), STREAM, 0, 0, 0, 0),
                 (3, img, GUIDE, dst, H, W, TAPS, N_TAPS, LUT, K - 1, BORDER, ROUNDING, STREAM)]
        img = dst
    return want


@pytest.mark.parametrize("nitr", range(6))
def test_pipeline_launches_every_iteration_in_order(pipeline_on_stubs, nitr):
    err, launched, records = run_pipeline(pipeline_on_stubs, nitr)
    assert err == 0 and launched == 4 * nitr
    assert records == expected_schedule(nitr)
    written = [r[3] for r in records if r[0] == 3]
    assert SRC not in written and written[-1:] == ([OUT] if nitr else [])
    for r in records:  # a joint filter never writes the image it reads
        assert r[0] != 3 or r[1] != r[3]


@pytest.mark.parametrize("fail_at", range(12))
def test_pipeline_stops_at_the_first_failed_launch(pipeline_on_stubs, fail_at):
    err, launched, records = run_pipeline(pipeline_on_stubs, 3, fail_at)
    assert launched == fail_at and err == 700 + fail_at % 4
    assert records == expected_schedule(3)[:fail_at + 1]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


SOURCES = {
    "45x38": (45, 38, 0),
    "17x901": (17, 901, 0),   # an odd width: no word or vector path
    "20x32+1": (20, 32, 1),   # whole words a row, at a 1-byte storage offset
}


@functools.cache
def _host_image(name: str) -> np.ndarray:
    h, w, _ = SOURCES[name]
    return random_image(h, w)


def source(name: str, device) -> torch.Tensor:
    h, w, offset = SOURCES[name]
    flat = torch.zeros(h * w * 3 + offset, dtype=torch.uint8, device=device)
    src = flat[offset:].view(h, w, 3)
    src.copy_(torch.from_numpy(_host_image(name)).to(device))
    assert src.is_contiguous() and src.storage_offset() == offset
    return src


@functools.cache
def _iterates(name: str, ksize: int, variant: str, impl: str) -> list:
    """The per-stage loop's image after 0 to 3 iterations (on the host)."""
    device = torch.device("cuda")
    img = source(name, device)
    taps, lut = obt.jbf_tables(ksize, device)
    out = [img.cpu()]
    for _ in range(3):
        img = obt.btf_iteration(img, ksize, taps, lut, *obt.VARIANTS[variant], impl)
        out.append(img.cpu())
    return out


def expect_path(ksize: int, height: int) -> int:
    """The joint filter (k′ = 2k − 1) takes the bilateral kernel's unrolled
    path from k′ = 3 to 9, its path 1 from k′ = 11 to 63 on frames over 16
    rows, else 4 pixels a thread up to k′ = 111 and 1 past it."""
    k = 2 * ksize - 1
    if 3 <= k <= 9:
        return kbf.UNROLLED
    if 11 <= k <= 63 and height > 16:
        return kbf.BLOCKED
    return kbf.FOUR_PIXELS if k <= 111 else kbf.ONE_PIXEL


@pytest.mark.cuda
@pytest.mark.parametrize("nitr", range(4))
@pytest.mark.parametrize("ksize", [3, 5, 9, 77])
@pytest.mark.parametrize("name", sorted(SOURCES))
@pytest.mark.parametrize("variant", ["cuda", "cpp"])
def test_single_call_equals_the_stage_loop_and_plain(cuda, variant, name, ksize, nitr):
    src = source(name, cuda)
    before = counters()
    out = vt.bilateral_texture_filter(src, ksize, nitr, variant=variant)
    rise = [b - a for a, b in zip(before, counters())]
    path = expect_path(ksize, src.shape[0])
    assert kbf._launch_plan(ksize - 1, True, src.shape[0])[1] == path
    assert rise == [nitr] * 4 + [nitr if path == kbf.BLOCKED else 0, int(nitr > 0),
                                 nitr if path == kbf.UNROLLED else 0]
    assert out.is_cuda and out.data_ptr() != src.data_ptr()
    assert torch.equal(out.cpu(), _iterates(name, ksize, variant, "cuda")[nitr])
    assert torch.equal(out.cpu(), _iterates(name, ksize, variant, "torch")[nitr])
    assert torch.equal(src.cpu(), torch.from_numpy(_host_image(name)))  # src only read


@pytest.mark.cuda
def test_module_batch_and_cli_take_the_single_call(cuda, tmp_path):
    from various_image_processings_tpu_torch.cli import bilateral_texture_filter as cli_btf
    from various_image_processings_tpu_torch.utils.io import imread, imwrite

    src = source("45x38", cuda)
    want = vt.bilateral_texture_filter(src, 9, 3)
    calls = kbt.single_calls
    assert torch.equal(vt.BilateralTextureFilter(45, 38, 9, 3)(src), want)
    assert kbt.single_calls == calls + 1
    batch = torch.stack([src, src.flip(0).contiguous()])
    out = tpar.bilateral_texture_filter_batched(batch, 9, 3, mesh=tpar.make_mesh(1, 1))
    assert kbt.single_calls == calls + 3
    assert torch.equal(out[0], want)
    assert torch.equal(out[1], vt.bilateral_texture_filter(batch[1], 9, 3))
    imwrite(str(tmp_path / "in.png"), _host_image("45x38"))
    calls = kbt.single_calls
    cli_btf.main([str(tmp_path / "in.png"), "9", "3", "-o", str(tmp_path / "out.png"),
                  "--device", "cuda"])
    assert kbt.single_calls == calls + 2  # the CLI's first call and its timed call
    assert torch.equal(torch.from_numpy(imread(str(tmp_path / "out.png"))), want.cpu())


@pytest.mark.cuda
def test_row_sharding_keeps_the_per_stage_wrappers(cuda):
    src = source("45x38", cuda)[:44].contiguous()
    want = vt.bilateral_texture_filter(src, 5, 2)
    before = counters()
    mesh = tpar.make_mesh(1, 2, devices=[cuda, cuda])
    out = tpar.bilateral_texture_filter_sharded(src, 5, 2, mesh=mesh)
    rise = [b - a for a, b in zip(before, counters())]
    assert rise[5] == 0 and rise[:4] == [4, 4, 4, 4]  # 2 shards × 2 iterations
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_texture_filter_rejects_what_the_kernels_do_not_take(cuda):
    src = source("45x38", cuda)
    taps, lut = obt.jbf_tables(9, cuda)
    with pytest.raises(ValueError, match="nitr"):
        kbt.texture_filter(src, 9, 0, taps, lut)
    with pytest.raises(ValueError, match="ksize"):
        kbt.texture_filter(src, 8, 1, taps, lut)
    with pytest.raises(ValueError, match="contiguous"):
        kbt.texture_filter(src[:, ::2], 9, 1, taps, lut)
    with pytest.raises(ValueError, match="lut"):
        kbt.texture_filter(src, 9, 1, taps, lut.double())
    with pytest.raises(ValueError, match="border"):
        kbt.texture_filter(src, 9, 1, taps, lut, border="wrap")
    with pytest.raises(ValueError, match="CUDA"):
        kbt.texture_filter(src.cpu(), 9, 1, taps, lut)
