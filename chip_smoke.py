"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent-csrc DIR]

Builds the port's CUDA kernels from ``various_image_processings_tpu_torch/csrc``
with nvcc (one process per source, in parallel) and prints what ptxas says of
each kernel; the SLIC association (each metric's instantiation), the
diffusion start and the fill's ring pick and filters must spill nothing.  Then, for each path the port has:

- the bilateral filter (4K k=9): holds the kernel against its plain PyTorch
  version over a parity grid, drives the path through the op, the
  ``BilateralFilter`` module and the CLI with the launch counter reset just
  before, and times kernel and plain version;
- the bilateral texture filter (600x900 k=9 nitr=3, both variants): holds the
  gradient, blur + mRTV and guide kernels against their plain versions over
  their grids (the gradient's over 1-4 channels and rows that are not whole
  words, the guide's over a grid of ties as well), drives the path through
  the op, the ``BilateralTextureFilter`` module and the CLI with every
  counter reset just before and read just after, and times each kernel,
  the plain versions and the whole filter at 600x900 and 4K;
- the adaptive bilateral filter (4K k=9, sigma_s=10, sigma_c=30): holds the
  kernel against its plain version over a parity grid that includes the
  subnormal-weight and underflow points, drives the path through the op, the
  ``AdaptiveBilateralFilter`` module and the CLI with every counter reset just
  before and read just after, and times kernel, op and plain version at 4K
  and 512x512;
- Wexler inpainting (402x700, BASELINE.md configs 5a and 5c): holds the
  search kernel against its plain version over a grid of shapes, target
  counts and masks (bit-equal with image values 0..127, within a stated
  tolerance on full-range images), and the fill loop's kernels
  (csrc/wexler_fill.cu: ring pick, target filters, commit, diffusion start;
  the JAX package's loop is XLA while_loops, no Pallas kernel) against their
  plain pieces, every buffer bit-equal after every piece over a grid of
  boxes, caps and masks (phase 14b; the diffusion start, a thread-block
  cluster of min(bh, 16) row strips a channel, on boxes from 1x1 to
  128x128); drives the path through the op, the
  ``WexlerInpainting`` module and the CLI with every counter reset just
  before and read just after, requires 4 launches an iteration, no plain
  piece, at most WEXLER_MAX_SYNCS host syncs a call and the output equal to
  the plain path on the card; times the search and fill kernels, their
  plain versions and bounds (phase 16b; the diffusion start alone and with
  the wrapper's clone of the image, beside the parent's time, with its
  cluster), and the whole inpaint's wall time
  and device-busy share, and shows from two profiled energy passes that an
  iteration launches no torch op (phase 17; a ``{"wexler": ...}`` line
  holds these numbers).

Then it holds every kernel against its plain version past the radii whose
halo tile fits one block (the tiles go through shared memory in bands),
runs a k=77 bilateral texture filter on the card against the plain path,
and fills a full-range (0..255) textured 402x700 image through the search
kernel and through the plain path, holding the kernel path's hole PSNR to
the plain path's less 2 dB.

Then SLIC superpixels, whose k-means runs on three kernels of the port's
own for each colour metric (csrc/slic_kmeans.cu: association with in-scan
sums, means and snap keys, center update, the first two an instantiation
for each of euclidean, ciede2000 and ciede2000_ref; the JAX package's
k-means is one XLA while_loop, no Pallas kernel), with the connectivity
pass on the host: the card's exact Lab against cv2 and the CPU path on all
2^24 colors; SLIC at 512x512 (BASELINE.md config 4: S=26, 10 iterations,
m=20) on a random and a smooth image through the op, the
``SuperpixelSLIC`` module and the CLI with the k-means kernels' counters
reset just before and read just after, the labels bit-equal to the CPU
path; the same at 2160x3840 (invariants only).  Phase 23 drives both
CIEDE2000 metrics through the op and the module (counters reset and read
the same way), holds the kernels' ΔE function (the pair kernel) to
core/ciede2000.py on the card bit for bit (23a), the ΔE kernel route to
``impl="torch"`` over a grid (23b), the card's labels to the CPU's at
130x130 (23c), and times 512x512 calls of both metrics and one 4K call
(23d).  Each timed call prints its wall time, its split (Lab, k-means, the
copies, the host connectivity) and counters (iterations, host syncs,
launches an iteration and the k-means kernels' among them, device-busy
share, peak memory, superpixels), and a ``{"slic": ...}`` line holds them.

Then the parallel layer and the timing twins (phases 24-26): the batch
fan-out on ``make_mesh()`` at BASELINE.md config 5b (64 4K frames, k=9) and
config 3b (8 600x900 BTFs), the ABF and gradient on 8 4K frames, and
Wexler on 2 402x700 images; batched SLIC (24s), whose batch rows each run
their images as one device program (the JAX package's vmapped k-means), on
8 smooth 512x512 images, a batch whose images stop at different
iterations, 2 smooth ones with each CIEDE2000 metric, 4 smooth 4K frames and
a 2x1 logical mesh, each byte-equal to per-image ``superpixel_slic``, with
``num_iteration`` launches of each k-means kernel and one host read a batch
row, its wall, split, launches and busy share against B x the single call;
row sharding on 2, 4 and 8
logical shards of the card (BF, JBF, ABF, gradient, BTF with a halo
exchange before every stage, and both batch-spatial functions on a 2x2
mesh), every output byte-equal to the single-device op and each path's
launches counted; then ``measure``, ``trace`` and ``vip-torch-benchmark``
at its default size and at 4K.  A ``{"parallel": ...}`` line holds the
times.

Last, the SLIC kernels (phases 27-28): the euclidean kernel route against
the plain route on the card over a grid of shapes (512x512, 4K, 97x131,
3x5), S (2, 7, 26, 64, larger than the image), iterations (1, 10), m (1,
20, 40) and images (noise, smooth, constant, two-color ties), labels,
distances, centers, drift and iterations all equal; each kernel (each
metric's instantiation) against its plain piece on the same state; each
kernel's device time an iteration, its bound and its plain piece's time at
512x512 (every metric) and 4K (euclidean), the association's beside the
parent's with its launch shape (32x8-pixel blocks, blocks an SM), and the
whole k-means both ways; then (28b) 8 smooth 512x512 images, the batched
k-means bit-equal to each image's single one and each kernel's time an
iteration per image at a batch of 1, 4 and 8 against the batch's bound.

With ``--parent-csrc DIR`` (another tree's ``csrc/``, e.g. the parent
commit's, unpacked with ``git archive``) it also builds those sources and
times their bilateral (phase 5b: BF 4K k=9, JBF k'=17 at 600x900 and 4K, on
a noise and a photo-like frame), guide and gradient kernels in turns with
this tree's (parent, change, change, parent), a BTF call whose gradient and
guide are the parent's, and the parent's Wexler ring pick and filters on
each state phase 16b times (bit-equal to this tree's), in the same process
on the same card.

Every phase prints a line; any failure exits non-zero.  On success the line
before the last is ``{"kernels": [...]}`` (the kernels' own runs; the
parallel phases count their launches on their own line) and the last is
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits 1.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np

MAIN_SHAPE = (2160, 3840)                 # 4K, u8 BGR
MAIN_PARAMS = (9, 10.0, 30.0)             # ksize, sigma_space, sigma_color
BTF_SHAPE = (600, 900)
BTF_PARAMS = (17, 8.0, math.sqrt(3.0))    # the JBF stage of a k=9 BTF iteration
GRID_KSIZES = (1, 3, 5, 9, 13, 17, 25, 27, 31)
GRID_SHAPES = ((50, 50), (37, 61), (8, 5), (1, 1))
GRID_MODES = (("replicate", "trunc"), ("reflect101", "rint"))

BTF_KSIZE, BTF_NITR = 9, 3                # the reference's own configuration
# rows that are whole words or not (3 * 61, 183), one row, one column, a
# ragged last warp (260 = 2 * 128 + 4), the BTF's 600x900
GRADIENT_SHAPES = ((1, 1), (8, 5), (37, 61), (5, 183), (1, 64), (64, 1), (13, 260), (600, 900))
GRADIENT_CHANNELS = (1, 2, 3, 4)
STAGE_KSIZES = (1, 3, 5, 9, 15)
STAGE_SHAPES = ((1, 1), (8, 5), (37, 61), (64, 31))
TIE_KSIZES = (1, 3, 9, 15, 223)
TIE_SHAPES = ((37, 61), (20, 132), (64, 200))  # scalar and vector paths, a ragged last block
ABF_KSIZES = (1, 3, 5, 9, 15, 31)
ABF_SHAPES = ((1, 1), (8, 5), (37, 61), (50, 50))
# (k, sigma_s, sigma_c, h, w): every weight in the LUT's f32 subnormal band
# (random_image inputs), then whole windows whose ws*lut products underflow
# to 0 (np.random.default_rng(777 + i) noise); tests/test_bilateral.py:81-82, :172-175
ABF_BAND_POINTS = ((3, 9.3, 16.3, 26, 41), (15, 22.8, 11.5, 45, 13),
                   (11, 8.0, 21.8, 35, 56), (11, 19.6, 35.6, 33, 49))
ABF_UNDERFLOW_POINTS = ((13, 1.13, 1.6, 50, 50), (7, 1.13, 5.14, 32, 32),
                        (15, 0.47, 3.49, 31, 64), (13, 1.75, 5.14, 48, 48))
ABF_SMALL_SHAPE = (512, 512)              # BASELINE.md config 2's image size
WEXLER_SHAPE = (402, 700)                 # mosaic_dog, BASELINE.md config 5
SEARCH_SHAPES = ((20, 20), (33, 41), (34, 45), (64, 200), WEXLER_SHAPE)
SEARCH_TARGETS = (1, 7, 16, 256, 1000, 1024)
SEARCH_TIMED_TARGETS = (16, 64, 256, 1024)  # the fill's target counts at 402x700
WEXLER_MAX_SYNCS = 8                      # host syncs a 402x700 inpaint may make
# the first k past each kernel's one-tile limit (BF self 219, JBF 149, ABF
# 177, blur + mRTV 119, guide 109), and 301
LARGE_BF_RADII = ((False, 110), (False, 150), (True, 75), (True, 150))
LARGE_ABF_RADII = (89, 150)
LARGE_STAGE_KSIZES = (111, 121, 223, 301)
LARGE_SHAPE = (23, 37)
BTF_LARGE_KSIZE = 77                      # its JBF runs at k' = 153, past 149
SLIC_SHAPE = (512, 512)                   # BASELINE.md config 4
SLIC_PARAMS = (26, 10, 20.0)              # superpixel size S, iterations, color scale m
SLIC_CALLS = 3                            # warm calls timed a configuration
SLIC_BATCH = 8                            # phase 24s's batch of 512x512 images
SLIC_BATCH_CALLS = 3                      # warm calls timed a batch case
SLIC_KERNELS = ("association", "snap_keys", "update")  # csrc/slic_kmeans.cu, in launch order
# phase 27's grid: every (shape, S) with every image kind, each kind with
# another (iterations, m); S = 5000 is larger than every image
SLIC_GRID_SHAPES = ((512, 512), (2160, 3840), (97, 131), (3, 5))
SLIC_GRID_SIZES = (2, 7, 26, 64, 5000)
SLIC_GRID_KINDS = ("random", "smooth", "constant", "two")
SLIC_GRID_RUNS = ((10, 20.0), (1, 1.0), (10, 40.0), (10, 1.0))
DELTA_E_TOL = (5e-4, 5e-2)                # rtol, atol: tests/test_ciede2000.py's
DELTA_E_METRICS = ("ciede2000", "ciede2000_ref")
DELTA_E_GRID_SHAPES = ((512, 512), (97, 131), (3, 5))  # phase 23b, with SLIC_GRID_SIZES and _KINDS
DELTA_E_4K_ITERATIONS = 3                 # phase 23b's 4K smooth case (the plain route is slow)
# operations of one squared ΔE of a (center, pixel) pair, counted from
# csrc/slic_kmeans.cu::delta_e_square: each IEEE add, sub, mul, div and sqrt and
# each call of powf, atan2f, sinf, cosf and expf counts one; compares, selects,
# negations and fabsf count none.  Each side's chroma, sqrt(a*a + b*b), apart.
DELTA_E_OPS = 101
CHROMA_OPS = 4
PARALLEL_BATCH = 64                       # BASELINE.md config 5b: 64 4K frames
BTF_BATCH = 8                             # config 3b: 8 600x900 frames
SHARD_COUNTS = (2, 4, 8)                  # logical shards of the 4K BF
# the parent's times, for the lines that print beside them (PERF.md sections
# 5-6: chip_smoke.py runs of the parent, NVIDIA H100 80GB HBM3, 700.00 W)
PARENT_MS = {
    "bilateral 4K k=9": "0.2975-0.3002",
    "JBF 600x900 k=17": "0.1036-0.1044",
    ("600x900", "gradient"): "0.0057",
    ("600x900", "blur_rtv"): "0.0176-0.0178",
    ("600x900", "guide"): "0.0241-0.0243",
    ("600x900", "bilateral"): "0.0933-0.0940",
    ("4K", "gradient"): "0.0579-0.0582",
    ("4K", "blur_rtv"): "0.1903-0.1912",
    ("4K", "guide"): "0.3093-0.3115",
    ("4K", "bilateral"): "1.0873-1.0955",
    ("BTF", "600x900"): "0.4268-0.5512 ms per call",
    ("BTF", "4K"): "1668.7-1681.2 MP/s",
    ("ABF", "4K"): "0.5239-0.5279",
    ("ABF", "512x512"): "0.0225",
    # the SLIC association before its own 32x8 tiles (ms an iteration, an
    # image) and the diffusion start before its clusters (128x128, dither,
    # the image's clone included)
    ("association", "512x512"): "0.0839",
    ("association", "4K"): "0.5222",
    ("association", "512x512 ciede2000"): "0.2511",
    ("association", "512x512 ciede2000_ref"): "0.2584",
    ("association", "B=1"): "0.0839",
    ("association", "B=4"): "0.0277",
    ("association", "B=8"): "0.0225",
    ("wexler_diffusion", "128x128"): "1.5137",
    # the fill's ring pick and filters before their word masks and staged
    # windows (PR 15's run B at the 5a energy pass)
    ("wexler_ring_pick", "5a energy pass, cap 1024"): "0.0053",
    ("wexler_filters", "5a energy pass, cap 1024"): "0.0147",
}

# phase 26: one 4K bilateral filter under utils.profiling.trace, in its own process
TRACE_SCRIPT = """
import sys
import torch
import various_image_processings_tpu_torch as vt
from various_image_processings_tpu_torch.utils.profiling import trace
img = torch.randint(0, 256, (2160, 3840, 3), dtype=torch.uint8, device="cuda")
vt.bilateral_filter(img)
torch.cuda.synchronize()
with trace(sys.argv[1]):
    vt.bilateral_filter(img)
    torch.cuda.synchronize()
"""

# the card's peaks as the benchmark takes them (port_bench/peaks.json: HBM
# bytes/s, f32 FLOP/s), and the H100 SXM's dense bf16 tensor-core FLOP/s,
# which the Wexler search is bound by
PEAKS = json.loads((Path(__file__).resolve().parent / "port_bench" / "peaks.json").read_text())
HBM_BYTES_PER_S, F32_OPS_PER_S = PEAKS["hbm_bytes_per_s"], PEAKS["f32_ops_per_s"]
BF16_TENSOR_OPS_PER_S = 989e12


def max_diff(a, b) -> int:
    return int((a.int() - b.to(a.device).int()).abs().max().item())


def max_abs(a, b) -> float:
    """max |a - b| of two float tensors, taken in f64."""
    return float((a.double() - b.to(a.device).double()).abs().max().item())


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least ms the card could take, and what bounds it: the benchmark's
    roofline (port_bench/metrics/_roofline.py), the larger of the bytes at
    the HBM rate and the ops at ``ops_per_s``, read as its share of a call
    of one second."""
    from port_bench.metrics import _roofline

    one_second = SimpleNamespace(profile=SimpleNamespace(device=[("", 0, 10**9)], calls=1),
                                 ops_per_call=n_ops, bytes_per_call=n_bytes,
                                 peaks={**PEAKS, "f32_ops_per_s": ops_per_s})
    by_bytes = n_bytes / HBM_BYTES_PER_S >= n_ops / ops_per_s
    return _roofline.read(one_second) * 10.0, "bytes" if by_bytes else "operations"


def wexler_masks(h: int, w: int) -> dict:
    """BASELINE.md config 5's masks (benchmarks/baseline_configs.py:234-255):
    5a a central 64x64 hole; 5c an L, a disk of radius 18 and a 4x120 bar."""
    cy, cx = h // 2, w // 2
    square = np.zeros((h, w), np.uint8)
    square[cy - 32 : cy + 32, cx - 32 : cx + 32] = 255
    irregular = np.zeros((h, w), np.uint8)
    irregular[cy - 40 : cy + 8, cx - 50 : cx - 30] = 255
    irregular[cy - 8 : cy + 8, cx - 50 : cx + 10] = 255
    yy, xx = np.mgrid[:h, :w]
    irregular[(yy - (cy + 60)) ** 2 + (xx - (cx + 80)) ** 2 <= 18 ** 2] = 255
    irregular[cy + 100 : cy + 104, cx - 60 : cx + 60] = 255
    return {"5a": square, "5c": irregular}


def tie_inputs(h: int, w: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(blurred (h, w, 3), rtv (h, w)) f32 full of ties for the guide: rtv
    takes 4 levels far apart (so |alpha| is near 1), with the minimum (as
    +0 and -0) sprinkled so that windows hold equal minima in different rows
    and in different columns, and a flat block of whole flat windows;
    blurred differs by tap (13 a column, 23 a row, within 96..160, so the
    blend does not clamp), so a wrong pick moves the output."""
    rng = np.random.default_rng(seed)
    rtv = np.array([500.0, 1000.0, 3000.0], np.float32)[rng.integers(0, 3, (h, w))]
    rtv[rng.random((h, w)) < 0.04] = 0.0
    rtv[rng.random((h, w)) < 0.02] = -0.0
    rtv[h // 4 : h // 4 + h // 2, w // 4 : w // 4 + w // 3] = 1000.0
    yy, xx = np.mgrid[:h, :w]
    blurred = np.stack([96 + (23 * yy + 13 * xx + 7 * c) % 64 + (xx * yy % 8) / 8
                        for c in range(3)], axis=2).astype(np.float32)
    return blurred, rtv


def ptxas_summary(report: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from nvcc -Xptxas -v."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return out


def sass_functions(lib: str) -> dict[str, list[tuple[int, str]]]:
    """{kernel: [(address, instruction)]} from ``cuobjdump -sass``; {}
    without cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {func.split("\n", 1)[0].strip():
            [(int(a, 16), t.strip())
             for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
            for func in re.split(r"\n\s*Function : ", sass)[1:]}


def opcodes(body: list[str]) -> Counter:
    return Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in body)


def sass_loops(funcs: dict, name_part: str) -> list[tuple[str, int, Counter]]:
    """(kernel, instructions, opcode counts) of every loop (a backward
    branch) of at least 16 instructions in the kernels whose mangled name
    holds ``name_part``."""
    loops = []
    for name, code in funcs.items():
        if name_part not in name:
            continue
        for addr, text in code:
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [t for a, t in code if int(m.group(1), 16) <= a <= addr]
            if len(body) >= 16:
                loops.append((name, len(body), opcodes(body)))
    return loops


def build_parent(csrc: str):
    """The bilateral, guide, gradient, ring-pick and filters kernels of
    another tree's csrc/ (the parent's; with its bilateral_circle_r*.cu
    where it has them), built with this tree's nvcc flags, as a ctypes
    library."""
    import ctypes

    from various_image_processings_tpu_torch.ops.cuda import _build
    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    srcs = [os.path.join(csrc, f) for f in ("bilateral.cu", "bilateral_texture.cu",
                                              "gradient.cu", "wexler_fill.cu")]
    srcs += sorted(str(p) for p in Path(csrc).glob("bilateral_circle_r*.cu"))
    objs = [str(out / (os.path.basename(f) + ".o")) for f in srcs]
    nvcc = _build.nvcc()
    _build._run_all([[nvcc, *_build.NVCC_FLAGS, "-c", "-o", o, f] for f, o in zip(srcs, objs)])
    lib = str(out / "libparent.so")
    _build._run_all([[nvcc, "-shared", "-o", lib, *objs]])
    cdll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    cdll.vip_bilateral_u8.argtypes = [p, p, p, i, i, p, i, p, i, i, i, p]
    cdll.vip_guide.argtypes = [p, p, p, i, i, i, ctypes.c_float, p]
    cdll.vip_gradient.argtypes = [p, p, i, i, i, i, p]
    cdll.vip_wexler_ring_pick.argtypes = [p] * 6 + [i] * 8 + [p]
    cdll.vip_wexler_filters.argtypes = [p] * 7 + [i] * 9 + [p]
    return cdll


def parent_fill_launch(parent, piece: str, k):
    """A launch of the parent's ring pick or filters kernel on the buffers
    of the ``_FillPass`` k, as k's own launcher binds them."""
    import torch

    from various_image_processings_tpu_torch.ops.cuda import wexler_fill as kfill

    bh, bw, by0, bx0 = k.box
    stream = torch.cuda.current_stream().cuda_stream
    if piece == "ring_pick":
        mode = (kfill.ENERGY_MODE if not k.initial else kfill.RING_MODE if k.island is None
                else kfill.ISLAND_MODE)
        args = (k.rem.data_ptr(), k.rem0.data_ptr(),
                None if k.island is None else k.island.data_ptr(), k.tyx.data_ptr(),
                k.keys.data_ptr(), k.state.data_ptr(), bh, bw, by0, bx0, k.width, k.cap,
                k.keys.shape[0], mode, stream)
        fn = parent.vip_wexler_ring_pick
    else:
        args = (k.img.data_ptr(), k.rem.data_ptr(), k.tyx.data_ptr(), k.state.data_ptr(),
                k.f.data_ptr(), k.b2.data_ptr(), k.valid.data_ptr(), k.height, k.width, k.cap,
                k.f.shape[1], int(k.initial),
                *kfill.validity_region(k.height, k.width, k.box), stream)
        fn = parent.vip_wexler_filters

    def go() -> None:
        err = fn(*args)
        if err:
            raise SystemExit(f"the parent's Wexler {piece} did not launch: cudaError_t {err}")

    return go


# the bilateral kernel's cells: (label, shape, (ksize, sigma_space, sigma_color), joint)
BILATERAL_CELLS = (("BF 4K k=9", MAIN_SHAPE, MAIN_PARAMS, False),
                   ("BF 512x512 k=9", (512, 512), MAIN_PARAMS, False),
                   ("JBF 600x900 k'=17", BTF_SHAPE, BTF_PARAMS, True),
                   ("JBF 4K k'=17", MAIN_SHAPE, BTF_PARAMS, True))


def unrolled_body(code: list[str]) -> tuple[int, int]:
    """(instructions from the last barrier to the first division, to the
    first EXIT) of an unrolled-path kernel: its straight-line tap body, and
    the body with the stores."""
    last_bar = max(i for i, t in enumerate(code) if "BAR.SYNC" in t)
    rest = list(enumerate(code))[last_bar:]
    first_div = next((i for i, t in rest if "MUFU.RCP" in t or "FCHK" in t), len(code))
    first_exit = next((i for i, t in rest if t.startswith("EXIT")), len(code))
    return first_div - last_bar, first_exit - last_bar


def photo_like(h: int, w: int, dev, seed: int = 1):
    """A (h, w, 3) u8 frame of the benchmark's photo-like traffic
    (port_bench/inputs/u8_photo_like.py, its 4K mix's parameters)."""
    import torch

    from port_bench.inputs import u8_photo_like

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "port_bench", "traffic",
                           "u8_photo_like_2160x3840.json")) as f:
        traffic = {**json.load(f), "height": h, "width": w, "pool_frames": 1}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return u8_photo_like.make_pool(traffic, gen, dev)[0]


def bilateral_kernel_phases(dev, parent=None) -> dict:
    """The bilateral kernel at its cells (BILATERAL_CELLS): what ptxas says
    of each instantiation (the blocked path's and the unrolled path's must
    not spill), the SASS loops of the blocked path, the SASS instructions of
    the unrolled path's body a (tap, pixel) pair, each cell's launch plan,
    and on a noise frame and a
    photo-like frame the kernel's device ms, bit-equal to the plain version,
    with the bound beside it; with ``parent`` (build_parent's library) the
    parent's kernel in turns (parent, change, change, parent), bit-equal to
    this tree's.  Prints a ``{"bilateral": ...}`` line and returns it."""
    import torch

    from various_image_processings_tpu_torch.core.rng import random_image
    from various_image_processings_tpu_torch.ops.bilateral import _bilateral_math
    from various_image_processings_tpu_torch.ops.cuda import _build
    from various_image_processings_tpu_torch.ops.cuda import bilateral as kbf
    from various_image_processings_tpu_torch.utils.profiling import cuda_time_ms

    lb = _build.load_library()
    ptxas = {name: v for name, v in ptxas_summary(_build.ptxas_report()).items()
             if "bilateral" in name and "adaptive" not in name}
    for name, (regs, st, ld) in ptxas.items():
        phase(f"ptxas {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    blocked = {name: v for name, v in ptxas.items() if "bilateral_cols_kernel" in name}
    if len(blocked) != 2 or any(st or ld for _, st, ld in blocked.values()):
        raise SystemExit(f"the blocked path's instantiations are not 2 or spill: {blocked}")
    unrolled = {name: v for name, v in ptxas.items() if "bilateral_circle_kernel" in name}
    if len(unrolled) != 16 or any(st or ld for _, st, ld in unrolled.values()):
        raise SystemExit(f"the unrolled path's instantiations are not 16 or spill: {unrolled}")
    funcs = sass_functions(str(_build.library_path()))
    for part in ("bilateral_cols_kernelILb0E", "bilateral_cols_kernelILb1E"):
        for name, n, ops in sass_loops(funcs, part):
            top = ", ".join(f"{op} {c}" for op, c in ops.most_common(14))
            phase(f"SASS loop of the blocked path ({name}): {n} instructions: {top}")
    # the unrolled path: rows x V outputs a thread (rows 1 on small frames,
    # else H), each adding the circle's taps
    source = (_build.CSRC_DIR / "bilateral_circle.cuh").read_text()
    cols, rows_h = (int(re.search(rf"constexpr int {c} = (\d+);", source).group(1))
                    for c in ("kCircleCols", "kCircleRows"))
    sass_per_pair = {}
    for r, joint, rows in itertools.product(range(1, 5), (0, 1), (1, rows_h)):
        taps = sum((ky - r) ** 2 + (kx - r) ** 2 <= r * r
                   for ky in range(2 * r + 1) for kx in range(2 * r + 1))
        part = f"bilateral_circle_kernelILi{r}ELb{joint}ELi{rows}E"
        code = [t for _, t in funcs[next(n_ for n_ in funcs if part in n_)]]
        body, with_stores = unrolled_body(code)
        pairs = taps * cols * rows
        label = f"r={r} {'joint' if joint else 'self'} {rows}x{cols}"
        sass_per_pair[label] = body / pairs
        phase(f"SASS of the unrolled path {label}: {len(code)} instructions, body {body} for "
              f"{pairs} (tap, pixel) pairs = {body / pairs:.2f} a pair "
              f"({with_stores / pairs:.2f} with the stores, both store branches)")
    result = {"card": torch.cuda.get_device_name(0), "ptxas": ptxas,
              "unrolled_sass_per_pair": sass_per_pair, "cells": {}}
    for label, (h, w), (k, ss, sc), joint in BILATERAL_CELLS:
        r = k // 2
        path = lb.vip_bilateral_path(r, int(joint), h)
        taps, lut = kbf.device_tables(k, ss, sc, dev)
        n_taps = int(taps.shape[0])
        # bytes: the source (and guide) in, the output out; operations: per
        # tap ws * lut, 3 products and 4 sums, per pixel 3 divisions and roundings
        b_ms, b_by = bound((3 if joint else 2) * h * w * 3, h * w * (8 * n_taps + 6))
        cell = {"path": path, "smem": lb.vip_bilateral_smem_bytes(r, int(joint), h),
                "bound_ms": b_ms, "bound_by": b_by}
        for frame in ("noise", "photo-like"):
            src = (torch.from_numpy(random_image(h, w)).to(dev) if frame == "noise"
                   else photo_like(h, w, dev))
            guide = torch.flip(src, dims=(0,)).contiguous() if joint else None
            g = guide if joint else src
            fns = {"change": lambda: kbf.joint_bilateral(src, guide, taps, lut, r)}
            if parent is not None:
                def parent_call(src=src, guide=guide):
                    out = torch.empty_like(src)
                    err = parent.vip_bilateral_u8(
                        src.data_ptr(), None if guide is None else guide.data_ptr(),
                        out.data_ptr(), h, w, taps.data_ptr(), n_taps, lut.data_ptr(), r, 0, 0,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"the parent's bilateral kernel did not launch: "
                                         f"cudaError_t {err}")
                    return out
                fns["parent"] = parent_call
            outs = {who: fn() for who, fn in fns.items()}
            plain = _bilateral_math(src, g, k, ss, sc)
            diffs = {who: max_diff(out, plain) for who, out in outs.items()}
            if any(diffs.values()):
                raise SystemExit(f"{label} {frame}: kernel vs plain max |diff| {diffs}")
            ms = {who: [] for who in fns}
            for who in (("parent", "change", "change", "parent") if parent is not None
                        else ("change",)):
                ms[who].append(queued_ms(fns[who], 50))
            plain_ms = cuda_time_ms(lambda: _bilateral_math(src, g, k, ss, sc), iters=3, warmup=1)
            cell[frame] = {"ms": ms, "plain_ms": plain_ms}
            phase(f"{label} {frame}: path {path}, kernel {' / '.join(f'{t:.4f}' for t in ms['change'])}"
                  f" ms" + (f", parent {' / '.join(f'{t:.4f}' for t in ms['parent'])} ms in turns"
                            if parent is not None else "")
                  + f", bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, max |diff| 0")
        result["cells"][label] = cell
    print(json.dumps({"bilateral": result}), flush=True)
    return result


def smooth_image(h: int, w: int, seed: int) -> np.ndarray:
    """u8 BGR smooth color fields: a bicubic upsampling (on the CPU) of a
    small MT19937 image."""
    import torch

    from various_image_processings_tpu_torch.core.rng import random_image

    coarse = torch.from_numpy(random_image(6, 6 + seed)).permute(2, 0, 1)[None].float()
    up = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic",
                                         align_corners=False)
    return up.round().clamp(0, 255)[0].permute(1, 2, 0).to(torch.uint8).contiguous().numpy()


def kernel_counts(prof) -> tuple[int, int, float]:
    """Kernel launches in a torch.profiler run, of which the SLIC k-means
    kernels', and their device microseconds (copies excluded)."""
    import torch

    n = n_kmeans = busy = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or "Memcpy" in evt.key \
                or "Memset" in evt.key:
            continue
        us = getattr(evt, "self_device_time_total", None)
        busy += evt.self_cuda_time_total if us is None else us
        n += evt.count
        if any(f"slic_{name}_kernel" in evt.key for name in SLIC_KERNELS):
            n_kmeans += evt.count
    return n, n_kmeans, busy


def cell_ramp(h: int, w: int, s: int, step: int) -> np.ndarray:
    """u8 BGR: blue rising along x and red along y by ``step`` a pixel in
    each S x S cell, from 100 at the cell's center (green 120).  Its cell
    means sit near the centers' colours, so the k-means stops early (after
    5 to 9 of 10 iterations at 512x512, S=26, m=20)."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.empty((h, w, 3), np.uint8)
    img[..., 0] = 100 + (xx % s - s // 2 + 1) * step
    img[..., 1] = 120
    img[..., 2] = 100 + (yy % s - s // 2 + 1) * step
    return img


def boundary_recall(ref, got, tol: int = 2) -> float:
    """Share of ``ref``'s label boundary pixels with a boundary pixel of
    ``got`` within ``tol`` pixels (Chebyshev), two (H, W) label tensors."""
    import torch

    def edges(lab):
        e = torch.zeros(lab.shape, dtype=torch.bool)
        e[:, :-1] |= lab[:, :-1] != lab[:, 1:]
        e[:-1, :] |= lab[:-1, :] != lab[1:, :]
        return e

    ref_e = edges(ref.cpu())
    near = torch.nn.functional.max_pool2d(edges(got.cpu()).float()[None, None], 2 * tol + 1,
                                          stride=1, padding=tol)[0, 0] > 0
    return float((ref_e & near).sum()) / max(float(ref_e.sum()), 1.0)


def slic_phases(dev, random_4k: np.ndarray) -> dict:
    """Phases 20-23: SLIC superpixels and their exact Lab.  The k-means runs
    on the port's kernels for every metric (csrc/slic_kmeans.cu; the JAX
    package's is a pure-XLA program, no Pallas kernel), the connectivity
    pass on the host.  ``random_4k`` is the main path's 2160x3840 image.
    Prints the timing split of a call and its counters, and a
    ``{"slic": ...}`` line with them.  Returns the k-means kernels' launches
    on the main paths of phases 21-23 (euclidean: op, module, CLI at
    512x512, module at 4K; each ΔE metric: op and module at 512x512),
    counted from 0, by kernel and by (kernel, metric)."""
    import cv2
    import torch

    import various_image_processings_tpu_torch as vt
    from various_image_processings_tpu_torch.cli import slic as cli_slic
    from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact
    from various_image_processings_tpu_torch.core.rng import random_image
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic
    from various_image_processings_tpu_torch.utils import native
    from various_image_processings_tpu_torch.utils.io import imread, imwrite

    t_start = time.perf_counter()
    main_launches = Counter()

    def reset_kernels() -> None:
        torch.cuda.synchronize()
        for name in SLIC_KERNELS:
            setattr(kslic, f"{name}_launches", 0)
        kslic.metric_launches.clear()

    def read_kernels() -> dict:
        """The counts since the reset, added to the main path's (by kernel,
        and by (kernel, metric) for the association and snap keys)."""
        torch.cuda.synchronize()
        got = {name: getattr(kslic, f"{name}_launches") for name in SLIC_KERNELS}
        main_launches.update(got)
        main_launches.update(kslic.metric_launches)
        return got
    # 20. Lab on all 2^24 colors: the card's integer path against cv2 and
    #     against the CPU path (in bands of rows, to bound host memory)
    c = torch.arange(1 << 24, dtype=torch.int64)
    colors = torch.stack([c & 255, (c >> 8) & 255, (c >> 16) & 255], -1).to(torch.uint8)
    colors = colors.reshape(4096, 4096, 3)
    colors_dev = colors.to(dev)
    card = bgr2lab_u8_exact(colors_dev)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    bgr2lab_u8_exact(colors_dev)
    end.record()
    torch.cuda.synchronize()
    lab_all_ms = start.elapsed_time(end)
    card = card.cpu()
    ref = torch.from_numpy(cv2.cvtColor(colors.numpy(), cv2.COLOR_BGR2Lab))
    d_cv2 = int((card != ref).sum())
    d_cpu = sum(int((card[r[0]:r[-1] + 1] != bgr2lab_u8_exact(colors[r[0]:r[-1] + 1])).sum())
                for r in torch.arange(4096).chunk(4))
    phase(f"Lab on all 2^24 colors (4096x4096): codes that differ from cv2.cvtColor {d_cv2}, "
          f"from the CPU path {d_cpu} (tolerance 0); the card's conversion {lab_all_ms:.4f} ms "
          f"({time.perf_counter() - t_start:.1f} s into phases 20-23)")
    if d_cv2 or d_cpu:
        raise SystemExit("the card's Lab differs")
    del colors, colors_dev, card, ref

    s_size, iters, m = SLIC_PARAMS

    def connected(labels) -> bool:
        """Every label is one 4-connected component, and the labels are 0..n-1."""
        lab_np = labels.cpu().numpy()
        _, ncomp = native.ccl_4conn(lab_np)
        return int(lab_np.min()) == 0 and ncomp == int(lab_np.max()) + 1

    def measure(model, img, calls: int = SLIC_CALLS, profile: bool = True) -> dict:
        """Warm wall per call of ``model.apply`` (already called once), the
        split of one call into its stages (a synchronize after the k-means
        keeps its tail out of the copy's time), and the counters of one
        call, profiled (device activity only: host events cost seconds to
        collect) unless ``profile`` is false."""
        h, w = img.shape[:2]
        walls = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.apply(img)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        lab = bgr2lab_u8_exact(img)
        ev[1].record()
        raw, _, _, drift = slic.slic_device(lab, h, w, s_size, iters, m, model.metric)
        ev[2].record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        raw_h, lab_h, _ = slic._download(raw, lab, drift)
        t2 = time.perf_counter()
        final = slic.enforce_connectivity(raw_h, lab_h, s_size, model.metric)
        t3 = time.perf_counter()
        torch.from_numpy(final).to(img.device)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        split = {"lab_ms": ev[0].elapsed_time(ev[1]), "kmeans_ms": ev[1].elapsed_time(ev[2]),
                 "d2h_ms": (t2 - t1) * 1e3, "connectivity_ms": (t3 - t2) * 1e3,
                 "h2d_ms": (t4 - t3) * 1e3, "split_wall_ms": (t4 - t0) * 1e3}
        slic.host_syncs = slic.iterations = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        launches = kmeans_launches = busy_us = None
        if profile:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.apply(img)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
            launches, kmeans_launches, busy_us = kernel_counts(prof)
        else:
            model.apply(img)
        peak = torch.cuda.max_memory_allocated() - base
        its = slic.iterations
        return {
            "wall_ms": statistics.median(walls) if walls else None, "walls_ms": walls, **split,
            "iterations": its, "host_syncs": slic.host_syncs,
            "launches": launches, "kmeans_launches": kmeans_launches,
            "launches_per_iteration": launches / max(its, 1) if launches else None,
            "kmeans_launches_per_iteration": (kmeans_launches / max(its, 1)
                                              if launches else None),
            "device_busy": (busy_us / 1e6 / prof_wall) if busy_us else None,
            "peak_mib": peak / 2**20, "superpixels": int(model.get_label().max()) + 1,
            "drift": model.last_max_drift_cells,
        }

    def show(label: str, t: dict) -> None:
        """The phase line of one timed configuration."""
        busy = ("not measured" if t["device_busy"] is None else f"{t['device_busy']:.3f}")
        launches = ("not measured" if t["launches"] is None
                    else f"{t['launches_per_iteration']:.1f} ({t['launches']} a call, of which "
                         f"the k-means kernels' {t['kmeans_launches']}: "
                         f"{t['kmeans_launches_per_iteration']:.1f} an iteration)")
        phase(f"SLIC {label}: warm wall {t['wall_ms']:.3f} ms a call (runs "
              f"{', '.join(f'{x:.3f}' for x in t['walls_ms'])}); split: Lab "
              f"{t['lab_ms']:.4f} ms, k-means {t['kmeans_ms']:.3f} ms (CUDA events), "
              f"device->host {t['d2h_ms']:.3f} ms, host connectivity "
              f"{t['connectivity_ms']:.3f} ms, host->device {t['h2d_ms']:.3f} ms "
              f"(sum {t['split_wall_ms']:.3f}); {t['iterations']} iterations, "
              f"{t['host_syncs']} host syncs a call, kernel launches an iteration {launches}, "
              f"device busy {busy} of the profiled call (torch.profiler), peak memory "
              f"{t['peak_mib']:.1f} MiB over the resident, {t['superpixels']} superpixels, "
              f"drift {t['drift']} cells "
              f"({time.perf_counter() - t_start:.1f} s into phases 20-23)")

    results = {}
    def check_kmeans(label: str, t: dict) -> None:
        """The profiled call ran its k-means on the kernels alone: 3
        launches an enqueued iteration, none read back but the download."""
        want = 3 * iters
        if t["host_syncs"] != 1 or (t["kmeans_launches"] is not None
                                    and (t["kmeans_launches"] != want
                                         or t["kmeans_launches_per_iteration"] > 6)):
            raise SystemExit(f"SLIC {label}: {t['host_syncs']} host syncs, k-means kernel "
                             f"launches {t['kmeans_launches']} (expected 1 and {want})")

    # 21. config 4 (512x512, S=26, 10 iterations, m=20) on two seeded images,
    #     through the op, the module and the CLI (the k-means kernels' counts
    #     reset just before and read just after); the card's labels are held
    #     bit-equal to the CPU path, then the call is timed and counted
    h, w = SLIC_SHAPE
    images = {"random": random_image(h, w), "smooth": smooth_image(h, w, 4)}
    for name, img_np in images.items():
        img = torch.from_numpy(img_np).to(dev)
        cpu_model = vt.SuperpixelSLIC(h, w, s_size, iters, m, device="cpu")
        want = cpu_model.apply(img_np)
        reset_kernels()
        slic.host_syncs = slic.iterations = 0
        got_op = vt.superpixel_slic(img, s_size, iters, m)  # a tensor stays on its device
        op_syncs, op_iters = slic.host_syncs, slic.iterations
        model = vt.SuperpixelSLIC(h, w, s_size, iters, m, device=dev)
        got_module = model.apply(img_np)
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            in_path = os.path.join(tmp, "in.png")
            imwrite(in_path, img_np)
            os.chdir(tmp)
            try:
                cli_slic.main([in_path, str(s_size), str(iters), str(m), "--device", str(dev)])
            finally:
                os.chdir(cwd)
            mean_png = imread(os.path.join(tmp, "in_slic_mean.png"))
        counts = read_kernels()
        want_png = cli_slic.draw_superpixel(img_np, want.numpy())
        equal = (got_op.device == got_module.device == img.device
                 and torch.equal(got_op.cpu(), want)
                 and torch.equal(got_module.cpu(), want))
        phase(f"SLIC {h}x{w} S={s_size} {iters} it m={m:g} {name}: card labels (op, module) "
              f"bit-equal to the CPU path {equal}; CLI mean PNG equal "
              f"{np.array_equal(mean_png, want_png)}; drift {model.last_max_drift_cells} "
              f"(CPU {cpu_model.last_max_drift_cells}); connected "
              f"{connected(got_op)}; op: {op_iters} iterations, {op_syncs} host syncs; k-means "
              f"kernel launches (op, module, CLI) {counts}")
        if (not equal or not np.array_equal(mean_png, want_png) or not connected(got_op)
                or op_syncs != 1 or set(counts.values()) != {3 * iters}
                or model.last_max_drift_cells != cpu_model.last_max_drift_cells):
            raise SystemExit(f"SLIC {name} at {h}x{w} wrong")
        results[f"512_{name}"] = t = measure(model, img)
        show(f"{h}x{w} {name}", t)
        check_kmeans(f"{h}x{w} {name}", t)

    # 22. the same at 4K (2160x3840): invariants and timing, no CPU run
    h, w = MAIN_SHAPE
    for name, img_np in {"random": random_4k, "smooth": smooth_image(h, w, 4)}.items():
        img = torch.from_numpy(img_np).to(dev)
        model = vt.SuperpixelSLIC(h, w, s_size, iters, m, device=dev)
        reset_kernels()
        t0 = time.perf_counter()
        got = model.apply(img)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = read_kernels()
        n = int(got.max()) + 1
        ok = connected(got) and 1 <= n <= h * w and set(counts.values()) == {iters}
        phase(f"SLIC {h}x{w} {name}: {n} superpixels, connected {connected(got)}, drift "
              f"{model.last_max_drift_cells}; k-means kernel launches "
              f"(module) {counts}")
        if not ok:
            raise SystemExit(f"SLIC {name} at 4K failed its invariants")
        # the random image fragments into many small components, whose
        # merge makes its host pass seconds long: its wall is the first call's
        t = measure(model, img, 0 if name == "random" else SLIC_CALLS)
        if name == "random":
            t["wall_ms"], t["walls_ms"] = first_ms, [first_ms]
        results[f"4k_{name}"] = t
        show(f"{h}x{w} {name}", t)
        check_kmeans(f"{h}x{w} {name}", t)

    # 23. the CIEDE2000 metrics, whose k-means runs on the kernels'
    #     instantiations for each metric (csrc/slic_kmeans.cu)
    results.update(delta_e_phases(dev, images["smooth"], reset_kernels, read_kernels, measure,
                                  show, check_kmeans))
    print(json.dumps({"slic": results}), flush=True)
    phase(f"SLIC phases 20-23 took {time.perf_counter() - t_start:.1f} s")
    return main_launches


def delta_e_pairs():
    """(6, n) f32 Lab pairs on the CPU: 65536 seeded integers in -255..255
    (the pairs phase 23 used before the ΔE kernels), 65536 seeded floats in
    -200..200, and every pair of a lattice of colours (a, b in -130..130 step
    10, seeded L: a = b = 0, a = 0 with b != 0, equal colours, hue
    differences on both sides of ±half, wrapped either way);
    tests/test_torch_cuda.py draws the same."""
    import torch

    rng = np.random.default_rng(7)
    ints = rng.integers(-255, 256, (6, 1 << 16)).astype(np.float32)
    floats = rng.uniform(-200.0, 200.0, (6, 1 << 16)).astype(np.float32)
    ab = np.arange(-130, 131, 10, dtype=np.float32)
    aa, bb = np.meshgrid(ab, ab)
    lattice = np.stack([rng.integers(0, 256, aa.size).astype(np.float32), aa.ravel(),
                        bb.ravel()])
    i, j = np.meshgrid(np.arange(aa.size), np.arange(aa.size))
    pairs = np.concatenate([lattice[:, i.ravel()], lattice[:, j.ravel()]])
    return torch.from_numpy(np.concatenate([ints, floats, pairs], 1))


def delta_e_phases(dev, smooth_np: np.ndarray, reset_kernels, read_kernels, measure, show,
                   check_kmeans) -> dict:
    """Phase 23: SLIC with the CIEDE2000 metrics, whose k-means runs on the
    kernels' instantiation for each metric.  The main path (op and module at
    512x512 smooth, counts reset just before and read just after); 23a the
    pair kernel against core/ciede2000.py on the card (bit-equal) and the
    card's ΔE against the CPU's (within DELTA_E_TOL); 23b the kernel route
    against ``impl="torch"`` on the card over the grid; 23c the card against
    the CPU path at 130x130; 23d each metric's call at 512x512 and one 4K
    ciede2000 call, timed, split and counted.  Returns 23d's results."""
    import torch

    import various_image_processings_tpu_torch as vt
    from various_image_processings_tpu_torch.core import ciede2000
    from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic
    from various_image_processings_tpu_torch.utils.profiling import cuda_time_ms

    t_start = time.perf_counter()
    s_size, iters, m = SLIC_PARAMS
    h, w = SLIC_SHAPE
    img = torch.from_numpy(smooth_np).to(dev)
    for metric in DELTA_E_METRICS:
        reset_kernels()
        slic.host_syncs = slic.iterations = 0
        got_op = vt.superpixel_slic(img, s_size, iters, m, metric)
        op_syncs, op_iters = slic.host_syncs, slic.iterations
        model = vt.SuperpixelSLIC(h, w, s_size, iters, m, metric, device=dev)
        got_module = model.apply(img)
        counts = read_kernels()
        by_metric = {(name, mt): n for (name, mt), n in kslic.metric_launches.items()}
        want_counts = {("association", metric): 2 * iters, ("snap_keys", metric): 2 * iters}
        phase(f"SLIC {h}x{w} smooth metric={metric} through op and module: labels equal "
              f"{torch.equal(got_op, got_module)}, on {got_op.device}; op: {op_iters} "
              f"iterations, {op_syncs} host syncs; k-means kernel launches {counts}, by "
              f"instantiation {by_metric}")
        if (not torch.equal(got_op, got_module) or got_op.device != img.device or op_syncs != 1
                or set(counts.values()) != {2 * iters} or by_metric != want_counts):
            raise SystemExit(f"SLIC {metric} main path wrong")

    # 23a. the pair kernel against core/ciede2000.py on the card, bit for bit,
    #      on seeded and edge pairs and every (pixel, center) pair of a
    #      512x512 run; the card's ΔE against the CPU's within DELTA_E_TOL
    rtol, atol = DELTA_E_TOL
    lab = bgr2lab_u8_exact(img)
    edge = delta_e_pairs()
    pair_worst, pair_times = {}, {}
    for metric in DELTA_E_METRICS:
        fn = getattr(ciede2000, f"{metric}_square")
        raw, centers, _, _ = slic.slic_device(lab, h, w, s_size, iters, m, metric)
        run = torch.cat([centers[raw.reshape(-1).long(), 2:].T, lab.reshape(-1, 3).float().T])
        diffs = []
        for v in (edge.to(dev), run.contiguous()):
            want, got = fn(*v), kslic.delta_e(*v, metric)
            diffs.append((max_abs(got, want), int((got != want).sum())))
        pair_worst[metric] = max(d for d, _ in diffs)
        # the pair kernel's time on the run's pairs (a check's kernel: these
        # launches are not the main path's), its plain version's and its bound
        k_ms = queued_ms(lambda: kslic.delta_e(*run, metric), 20)
        p_ms = cuda_time_ms(lambda: fn(*run), iters=3, warmup=1)
        n_pairs = run.shape[1]
        b_ms, b_by = bound(7 * 4 * n_pairs, DELTA_E_OPS * n_pairs)
        pair_times[metric] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "pairs": n_pairs}
        seeded = edge[:, :1 << 16]
        de_card = torch.cat([fn(*run), fn(*seeded.to(dev))]).cpu()
        de_cpu = torch.cat([fn(*run.cpu()), fn(*seeded)])
        de_ok = bool(torch.allclose(de_card, de_cpu, rtol=rtol, atol=atol))
        phase(f"23a. {metric}: pair kernel vs core/ciede2000.py on the card, max |diff| "
              f"(values that differ) over {edge.shape[1]} seeded and edge pairs {diffs[0][0]} "
              f"({diffs[0][1]}), over the {h}x{w} run's {h * w} (center, pixel) pairs "
              f"{diffs[1][0]} ({diffs[1][1]}) (tolerance 0); card vs CPU on the run's pairs and "
              f"65536 seeded pairs max |diff| {max_abs(de_card, de_cpu):.3g} (rtol {rtol}, "
              f"atol {atol}: {de_ok}); kernel {k_ms:.4f} ms on the run's {n_pairs} pairs, "
              f"plain {p_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by}")
        if pair_worst[metric] or not de_ok:
            raise SystemExit(f"{metric}: the pair kernel or the card's ΔE is off")

    # 23b. the kernel route against impl="torch" on the card
    cases = 0
    for metric in DELTA_E_METRICS:
        grid = [(shape, sz, kind) for shape in DELTA_E_GRID_SHAPES for sz in SLIC_GRID_SIZES
                for kind in SLIC_GRID_KINDS]
        for shape, sz, kind in grid + [(MAIN_SHAPE, s_size, "smooth")]:
            i = (SLIC_GRID_SIZES.index(sz) + SLIC_GRID_KINDS.index(kind)) % len(SLIC_GRID_RUNS)
            n_it, mm = SLIC_GRID_RUNS[i] if shape != MAIN_SHAPE else (DELTA_E_4K_ITERATIONS, m)
            lab_g = slic_lab(kind, *shape, dev)
            got = slic.slic_device(lab_g, *shape, sz, n_it, mm, metric, impl="cuda")
            ran = int(slic.device_iterations)
            slic.iterations = 0
            want = slic.slic_device(lab_g, *shape, sz, n_it, mm, metric, impl="torch")
            equal = [a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)]
            if not all(equal) or ran != slic.iterations:
                raise SystemExit(f"SLIC {metric} kernels differ from the plain route at {shape} "
                                 f"S={sz} {kind} {n_it} it m={mm:g}: (labels, centers, dists, "
                                 f"drift) equal {equal}, iterations {ran} against "
                                 f"{slic.iterations}")
            cases += 1
    slic.device_iterations = None
    phase(f"23b. SLIC ΔE kernels vs the plain route on the card: {cases} cases (metrics "
          f"{DELTA_E_METRICS}, shapes {DELTA_E_GRID_SHAPES}, S {SLIC_GRID_SIZES}, images "
          f"{SLIC_GRID_KINDS}, (iterations, m) {SLIC_GRID_RUNS}; and 4K smooth S={s_size} "
          f"{DELTA_E_4K_ITERATIONS} it): labels, distances, centers, drift and iterations run "
          f"all equal (tolerance 0) ({time.perf_counter() - t_start:.1f} s into phase 23)")

    # 23c. the card against the CPU path at 130x130 (the CPU's ΔE k-means at
    #      512x512 takes tens of seconds): equal labels, or else a boundary
    #      recall >= 0.95 at 2 px and a segment count within 5%
    small = smooth_np[:130, :130].copy()
    for metric in DELTA_E_METRICS:
        want = vt.superpixel_slic(small, s_size, iters, m, metric, device="cpu")
        got = vt.superpixel_slic(torch.from_numpy(small).to(dev), s_size, iters, m, metric)
        equal = torch.equal(got.cpu(), want)
        recall = boundary_recall(want, got)
        n_want, n_got = int(want.max()) + 1, int(got.max()) + 1
        phase(f"23c. SLIC {small.shape[0]}x{small.shape[1]} smooth metric={metric}: card labels "
              f"equal to the CPU path {equal}, boundary recall at 2 px {recall:.4f}, {n_got} "
              f"superpixels (CPU {n_want})")
        if not (equal or (recall >= 0.95 and abs(n_got - n_want) <= 0.05 * n_want)):
            raise SystemExit(f"{metric}: the card's labels are outside the recall criterion")

    # 23d. timed, split and counted: 512x512 smooth for each metric, one 4K call
    results = {}
    for metric in DELTA_E_METRICS:
        model = vt.SuperpixelSLIC(h, w, s_size, iters, m, metric, device=dev)
        model.apply(img)
        results[f"512_smooth_{metric}"] = t = measure(model, img)
        show(f"{h}x{w} smooth {metric}", t)
        check_kmeans(f"{h}x{w} smooth {metric}", t)
    h4, w4 = MAIN_SHAPE
    img4 = torch.from_numpy(smooth_image(h4, w4, 4)).to(dev)
    model = vt.SuperpixelSLIC(h4, w4, s_size, iters, m, "ciede2000", device=dev)
    model.apply(img4)
    results["4k_smooth_ciede2000"] = t = measure(model, img4, 1)
    show(f"{h4}x{w4} smooth ciede2000", t)
    check_kmeans(f"{h4}x{w4} smooth ciede2000", t)
    results["pair_max_abs_err"] = pair_worst
    results["pair_kernel"] = pair_times
    phase(f"phase 23 took {time.perf_counter() - t_start:.1f} s")
    return results


def slic_lab(kind: str, h: int, w: int, dev, seed: int = 0):
    """The Lab image, on the card, of a BGR image of ``kind``: seeded noise,
    a smooth field, one color, or two colors in vertical stripes (whose
    equidistant pixels tie)."""
    import torch

    from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact
    if kind == "random":
        bgr = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                                    dtype=np.uint8))
    elif kind == "smooth":
        bgr = torch.from_numpy(smooth_image(h, w, 4 + seed))
    elif kind == "constant":
        bgr = torch.full((h, w, 3), 97, dtype=torch.uint8)
    else:
        bgr = torch.empty((h, w, 3), dtype=torch.uint8)
        bgr[:] = torch.tensor([20, 200, 60], dtype=torch.uint8)
        bgr[:, (torch.arange(w) // 4) % 2 == 1] = torch.tensor([220, 30, 140],
                                                                 dtype=torch.uint8)
    return bgr2lab_u8_exact(bgr.to(dev))


def slic_kernel_phases(dev) -> dict:
    """Phases 27-28: the SLIC k-means kernels.  27: the kernel route against
    ``impl="torch"`` on the card over SLIC_GRID_* (labels, distances,
    centers, drift, iterations run: all equal).  28: each kernel against its
    plain piece on the same state (512x512 and 4K smooth, config 4, and a
    97x131 state with a center moved off the image), then each kernel's
    device time an iteration (queued behind a sleep kernel, CUDA events
    between the launches), its plain piece's and its bound from this run's
    work, and the whole k-means both ways.  28b: the batch axis, as above
    at a batch of 1, 4 and 8 smooth 512x512 images in one launch.  Returns,
    per kernel, its max |diff| and times at 512x512 and 4K, and at each
    batch."""
    import torch

    from various_image_processings_tpu_torch.core.pad import cdiv
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    t_start = time.perf_counter()
    # 27. the grid
    cases = 0
    for shape in SLIC_GRID_SHAPES:
        for s in SLIC_GRID_SIZES:
            for kind in SLIC_GRID_KINDS:
                i = (SLIC_GRID_SIZES.index(s) + SLIC_GRID_KINDS.index(kind)) % len(SLIC_GRID_RUNS)
                iters, m = SLIC_GRID_RUNS[i]
                lab = slic_lab(kind, *shape, dev)
                got = slic.slic_device(lab, *shape, s, iters, m, impl="cuda")
                ran = int(slic.device_iterations)
                slic.iterations = 0
                want = slic.slic_device(lab, *shape, s, iters, m, impl="torch")
                equal = [a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want)]
                if not all(equal) or ran != slic.iterations:
                    raise SystemExit(f"SLIC kernels differ from the plain route at {shape} "
                                     f"S={s} {kind} {iters} it m={m:g}: (labels, centers, "
                                     f"dists, drift) equal {equal}, iterations {ran} against "
                                     f"{slic.iterations}")
                cases += 1
    slic.device_iterations = None
    phase(f"SLIC kernels vs the plain route on the card: {cases} cases (shapes "
          f"{SLIC_GRID_SHAPES}, S {SLIC_GRID_SIZES}, images {SLIC_GRID_KINDS}, (iterations, m) "
          f"{SLIC_GRID_RUNS}): labels, distances, centers, drift and iterations run all equal "
          f"(tolerance 0) ({time.perf_counter() - t_start:.1f} s)")

    # 28. each kernel (each metric's instantiation) against its plain piece,
    #     then times and bounds
    s_size, iters, m = SLIC_PARAMS
    worst = Counter()  # (kernel, metric) -> max |diff|

    def diff(name: str, metric: str, a, b) -> None:
        worst[name, metric] = max(worst[name, metric], max_abs(a, b))

    def pieces(lab, h, w, s, n_it, displaced=None, metric="euclidean") -> list[dict]:
        """``n_it`` iterations through each kernel and the plain pieces side
        by side from the same state (every iteration forced active); the
        work each iteration did, for the bounds."""
        space_norm, color_norm = slic._norms(s, m)
        grid = slic._Grid(lab, h, w, s, m, metric)
        centers_t = grid.init_centers()
        labels_t = torch.full(grid.pix.shape[1:], -1, dtype=torch.int32, device=dev)
        dists_t = torch.full(grid.pix.shape[1:], slic._BIG, dtype=torch.float32, device=dev)
        # the kernels take a batch: one image here, its views below
        batch = slic.kmeans_state(lab[None], h, w, s, n_it)
        centers, labels, dists, sums, keys, state = (t[0] for t in batch)
        drift = torch.zeros((), device=dev)
        work = []
        for it in range(n_it):
            state[1 + it, 0] = 1
            if it == displaced:  # off the image: no pixel is in its window
                centers[0, :2] = -3.0 * s
                centers_t[:2, 0, 0] = -3.0 * s
            scanned, on_grid = scan_pairs(centers, h, w, s)
            before = dists.clone()
            labels_t, dists_t, changed_t, sums_t = grid.association(
                centers_t, labels_t, dists_t, max(2, 1 + int(drift)))  # the kernel's reach
            kslic.associate(lab[None], *batch[:4], batch[5], it, s, space_norm, color_norm,
                            metric)
            for a, b in ((labels, grid.from_blocks(labels_t)), (dists, grid.from_blocks(dists_t)),
                         (sums, sums_t.reshape(6, -1).T), (state[1 + it, 1], changed_t.int())):
                diff("association", metric, a, b)
            means_t = grid.center_means(centers_t, sums_t)
            keys_t = grid.snap_keys(means_t, labels_t)
            kslic.snap_keys(lab[None], batch[0], batch[1], batch[3], batch[4], batch[5], it, s,
                            metric)
            diff("snap_keys", metric, keys, keys_t)
            centers_t = grid.move_centers(centers_t, keys_t)
            drift = torch.maximum(drift, grid.cell_drift(centers_t))
            moved = int((keys < slic._BIG_KEY).sum())
            work.append({"pixels": h * w, "centers": grid.n, "scanned": scanned,
                         "on_grid": on_grid, "changed": int((dists < before).sum()),
                         "members": int((sums[:, 5] > 0).sum()),
                         "labelled": int((labels >= 0).sum()), "moved": moved})
            kslic.update(lab[None], batch[0], batch[4], batch[3], batch[5], it, s)
            for a, b in ((centers, centers_t.reshape(5, -1).T), (state[0, 0], drift),
                         (state[0, 1], torch.tensor(it + 1)), (state[2 + it, 0], changed_t.int()),
                         (sums, torch.zeros_like(sums)), (keys, torch.full_like(keys,
                                                                                slic._BIG_KEY))):
                diff("update", metric, a, b)
        return work

    def scan_pairs(centers, h, w, s) -> tuple[int, int]:
        """(pixel-candidate pairs scanned, pairs on the cell grid) of one
        association on ``centers``."""
        pc, pr = cdiv(h, s), cdiv(w, s)
        ys = torch.arange(h, device=dev)[:, None]
        xs = torch.arange(w, device=dev)[None, :]
        scanned = on_grid = 0
        for dy in (-2, -1, 0, 1, 2):
            for dx in (-2, -1, 0, 1, 2):
                ny, nx = ys // s + dy, xs // s + dx
                ok = (ny >= 0) & (ny < pc) & (nx >= 0) & (nx < pr)
                c = centers[ny.clamp(0, pc - 1) * pr + nx.clamp(0, pr - 1)]
                hit = ok & ((xs - c[..., 0]).abs() <= s) & ((ys - c[..., 1]).abs() <= s)
                scanned += int(hit.sum())
                on_grid += int(ok.sum())
        return scanned, on_grid

    def bounds(work: list[dict], metric: str = "euclidean") -> dict:
        """Each kernel's least time an iteration, averaged over the
        iterations: bytes (each input read once, each output written once)
        over HBM against f32 operations over their peak.  A colour distance
        is 8 operations (euclidean) or DELTA_E_OPS, and the ΔE metrics add
        each pixel's and each center's (or mean's) chroma."""
        color, chroma = (8, 0) if metric == "euclidean" else (DELTA_E_OPS, CHROMA_OPS)
        out = {name: [] for name in SLIC_KERNELS}
        for it in work:
            p, n = it["pixels"], it["centers"]
            out["association"].append(bound(
                p * 11 + it["changed"] * 8 + n * 20 + it["members"] * 48,
                it["on_grid"] * 4 + it["scanned"] * (8 + color) + (p + n) * chroma))
            out["snap_keys"].append(bound(p * 7 + n * 68 + it["moved"] * 8,
                                          it["labelled"] * (2 + color + chroma)
                                          + n * (12 + chroma)))
            out["update"].append(bound(n * 28 + it["moved"] * 23 + n * 56 + 8, n * 6))
        return {name: (statistics.mean(b for b, _ in v),
                       Counter(by for _, by in v).most_common(1)[0][0])
                for name, v in out.items()}

    def kernel_times(labs, h, w, s, runs: int = 5, metric: str = "euclidean") -> dict:
        """Device ms of each kernel an iteration of a (B, H, W, 3) batch, in
        which an image is active (median of ``runs`` k-means of ``iters``
        iterations from the init state, queued behind a sleep kernel so the
        host's launches are hidden), and the iterations the longest image
        ran; with the iterations each image ran."""
        space_norm, color_norm = slic._norms(s, m)
        per = {name: [] for name in SLIC_KERNELS}
        for _ in range(runs):
            centers, labels, dists, sums, keys, state = slic.kmeans_state(labs, h, w, s, iters)
            ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(iters)]
            torch.cuda.synchronize()
            torch.cuda._sleep(200_000_000)
            for it in range(iters):
                ev[it][0].record()
                kslic.associate(labs, centers, labels, dists, sums, state, it, s, space_norm,
                                color_norm, metric)
                ev[it][1].record()
                kslic.snap_keys(labs, centers, labels, sums, keys, state, it, s, metric)
                ev[it][2].record()
                kslic.update(labs, centers, keys, sums, state, it, s)
                ev[it][3].record()
            torch.cuda.synchronize()
            each = state[:, 0, 1].tolist()
            ran = max(each)
            for k, name in enumerate(SLIC_KERNELS):
                per[name].append(sum(ev[it][k].elapsed_time(ev[it][k + 1])
                                     for it in range(ran)) / ran)
        return {name: statistics.median(v) for name, v in per.items()}, ran, each

    def plain_times(lab, h, w, s, n: int = 3, metric: str = "euclidean") -> dict:
        """Device ms of each plain piece on the first iteration's state,
        ``n`` calls queued behind a sleep kernel."""
        grid = slic._Grid(lab, h, w, s, m, metric)
        centers = grid.init_centers()
        labels = torch.full(grid.pix.shape[1:], -1, dtype=torch.int32, device=dev)
        dists = torch.full(grid.pix.shape[1:], slic._BIG, dtype=torch.float32, device=dev)
        labels1, _, _, sums1 = grid.association(centers, labels, dists)
        keys1 = grid.snap_keys(grid.center_means(centers, sums1), labels1)
        drift = torch.zeros((), device=dev)
        fns = {"association": lambda: grid.association(centers, labels, dists),
               "snap_keys": lambda: grid.snap_keys(grid.center_means(centers, sums1), labels1),
               "update": lambda: torch.maximum(drift, grid.cell_drift(
                   grid.move_centers(centers, keys1)))}
        out = {}
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(500_000_000)  # ~0.3 s: outlasts enqueueing the plain ops
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            out[name] = start.elapsed_time(end) / n
        return out

    def whole_ms(lab, h, w, s, impl: str, calls: int = 3, metric: str = "euclidean") -> float:
        """CUDA-event ms of one slic_device call (host launches included),
        median of ``calls``."""
        slic.slic_device(lab, h, w, s, iters, m, metric, impl=impl)
        times = []
        for _ in range(calls):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            slic.slic_device(lab, h, w, s, iters, m, metric, impl=impl)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        slic.device_iterations = None
        return statistics.median(times)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def association_grid(label, h, w, b, metric) -> None:
        """The association's launch shape: blocks, blocks an SM can hold, waves."""
        blocks, per_sm = kslic.association_shape(h, w, metric)
        phase(f"SLIC {label} association grid ({metric}): {blocks} x {b} blocks of 32x8 "
              f"pixels for {sms} SMs ({blocks * b / sms:.2f} an SM; {per_sm} resident an SM, "
              f"{blocks * b / (sms * per_sm):.2f} waves)")

    pieces(slic_lab("random", 97, 131, dev), 97, 131, 13, 3, displaced=0)
    pieces(slic_lab("random", 97, 131, dev, 1), 97, 131, 13, 3, displaced=1)
    results = {}
    for label, (h, w) in (("512x512", SLIC_SHAPE), ("4K", MAIN_SHAPE)):
        lab = slic_lab("smooth", h, w, dev)
        work = pieces(lab, h, w, s_size, iters)
        k_ms, ran, _ = kernel_times(lab[None], h, w, s_size)
        bnd = bounds(work[:ran])
        p_ms = plain_times(lab, h, w, s_size)
        route_ms = {impl: whole_ms(lab, h, w, s_size, impl) for impl in ("cuda", "torch")}
        association_grid(label, h, w, 1, "euclidean")
        for name in SLIC_KERNELS:
            b_ms, b_by = bnd[name]
            parent = (f" (parent {PARENT_MS['association', label]} ms)"
                      if name == "association" else "")
            phase(f"SLIC {label} smooth S={s_size} m={m:g}: {name} kernel {k_ms[name]:.4f} ms an "
                  f"iteration{parent} ({ran} run), bound {b_ms:.4f} ms by {b_by} "
                  f"({k_ms[name] / b_ms:.1f}x), plain piece {p_ms[name]:.4f} ms; max |diff| "
                  f"against the plain piece over every step {worst[name, 'euclidean']}")
        phase(f"SLIC {label} smooth k-means, {iters} iterations: kernel route "
              f"{route_ms['cuda']:.3f} ms a call, plain route {route_ms['torch']:.3f} ms (CUDA "
              f"events, host launches included); scanned pairs a pixel "
              f"{statistics.mean(x['scanned'] for x in work) / (h * w):.2f}, pixels changed "
              f"an iteration {[x['changed'] for x in work]}")
        results[label] = {"kernel_ms": k_ms, "plain_ms": p_ms, "bound": bnd,
                          "route_ms": route_ms, "iterations": ran}
    # 28b. the batch axis (grid.y): SLIC_BATCH smooth 512x512 images, each
    #      held against its plain pieces; the batched k-means bit-equal to
    #      each image's single one; each kernel's device ms an iteration at
    #      B = 1, 4 and 8 in one launch, per image, against the batch's
    #      bound (the work of each image's iterations, summed)
    h, w = SLIC_SHAPE
    labs = torch.stack([slic_lab("smooth", h, w, dev, seed) for seed in range(SLIC_BATCH)])
    works = [pieces(labs[i], h, w, s_size, iters) for i in range(SLIC_BATCH)]
    got = slic.slic_device_batched(labs, h, w, s_size, iters, m)
    ran_each = slic.device_iterations.tolist()
    for i in range(SLIC_BATCH):
        one = slic.slic_device(labs[i], h, w, s_size, iters, m)
        if (int(slic.device_iterations) != ran_each[i]
                or not all(torch.equal(a[i], b) for a, b in zip(got, one))):
            raise SystemExit(f"SLIC batched k-means image {i} differs from its single call")
    slic.device_iterations = None
    phase(f"28b. SLIC {SLIC_BATCH}x{h}x{w} smooth batched k-means: labels, centers, distances, "
          f"drift and iterations ({ran_each}) bit-equal to each image's single call")
    results["batch"] = {}
    for b in (1, 4, SLIC_BATCH):
        k_ms, ran, each = kernel_times(labs[:b], h, w, s_size)
        summed = [{key: sum(works[i][it][key] for i in range(b) if it < each[i])
                   for key in works[0][it]} for it in range(ran)]
        bnd = bounds(summed)
        per_image = {name: k_ms[name] / b for name in SLIC_KERNELS}
        association_grid(f"28b. B={b} x {h}x{w}", h, w, b, "euclidean")
        for name in SLIC_KERNELS:
            b_ms, b_by = bnd[name]
            parent = (f" (parent {PARENT_MS['association', f'B={b}']} ms an image)"
                      if name == "association" else "")
            phase(f"28b. SLIC B={b} x {h}x{w} smooth S={s_size} m={m:g}: {name} kernel "
                  f"{k_ms[name]:.4f} ms an iteration for the batch, {per_image[name]:.4f} ms an "
                  f"image{parent}; bound {b_ms:.4f} ms by {b_by} ({k_ms[name] / b_ms:.1f}x); "
                  f"iterations run {each}")
        results["batch"][b] = {"kernel_ms": k_ms, "per_image_ms": per_image, "bound": bnd,
                               "iterations": each}
    # the ΔE instantiations at 512x512 smooth, and their pieces on the
    # displaced 97x131 states
    h, w = SLIC_SHAPE
    lab = slic_lab("smooth", h, w, dev)
    for metric in DELTA_E_METRICS:
        pieces(slic_lab("random", 97, 131, dev), 97, 131, 13, 3, displaced=0, metric=metric)
        pieces(slic_lab("random", 97, 131, dev, 1), 97, 131, 13, 3, displaced=1, metric=metric)
        work = pieces(lab, h, w, s_size, iters, metric=metric)
        k_ms, ran, _ = kernel_times(lab[None], h, w, s_size, metric=metric)
        bnd = bounds(work[:ran], metric)
        p_ms = plain_times(lab, h, w, s_size, metric=metric)
        route_ms = {impl: whole_ms(lab, h, w, s_size, impl, metric=metric)
                    for impl in ("cuda", "torch")}
        association_grid("512x512", h, w, 1, metric)
        for name in SLIC_KERNELS:
            b_ms, b_by = bnd[name]
            parent = (f" (parent {PARENT_MS['association', f'512x512 {metric}']} ms)"
                      if name == "association" else "")
            phase(f"SLIC 512x512 smooth S={s_size} m={m:g} {metric}: {name} kernel "
                  f"{k_ms[name]:.4f} ms an iteration{parent} ({ran} run), bound {b_ms:.4f} ms "
                  f"by {b_by} "
                  f"({k_ms[name] / b_ms:.1f}x), plain piece {p_ms[name]:.4f} ms; max |diff| "
                  f"against the plain piece over every step {worst[name, metric]}")
        phase(f"SLIC 512x512 smooth k-means {metric}, {iters} iterations: kernel route "
              f"{route_ms['cuda']:.3f} ms a call, plain route {route_ms['torch']:.3f} ms (CUDA "
              f"events, host launches included); scanned pairs a pixel "
              f"{statistics.mean(x['scanned'] for x in work) / (h * w):.2f}")
        results[f"512x512 {metric}"] = {"kernel_ms": k_ms, "plain_ms": p_ms, "bound": bnd,
                                        "route_ms": route_ms, "iterations": ran}
    if any(worst.values()):
        raise SystemExit(f"SLIC kernels differ from their plain pieces: {dict(worst)}")
    phase(f"SLIC kernel phases 27-28 took {time.perf_counter() - t_start:.1f} s")
    return {"worst": worst, **results}


def slic_batch_phase(dev, mesh, reset, read, expect, same, since) -> tuple[dict, Counter]:
    """Phase 24s: ``superpixel_slic_batched``, whose batch rows each run
    their images as one device program (the JAX package's vmapped k-means):
    8 smooth 512x512 images (config 4), a mixed batch whose images stop at
    different iterations, 2 smooth ones with each CIEDE2000 metric, 4 smooth
    4K frames, and the 8 smooth ones on a 2x1 logical mesh of the card.
    Each case is driven once with the counters reset just before and read
    just after (``num_iteration`` launches of each k-means kernel a batch
    row, one host read a row before the connectivity pass), held byte-equal
    to per-image ``superpixel_slic``, then timed: the batch's warm wall, its
    split (Lab and set-up, k-means by CUDA events, the download, the host
    connectivity pass, the upload), its launches and device-busy share
    (torch.profiler) and B x the single call, in the same run.  Returns the
    times and the k-means kernels' launches on these runs, by kernel and by
    (kernel, metric)."""
    import warnings

    import torch

    import various_image_processings_tpu_torch as vt
    from various_image_processings_tpu_torch import parallel as par
    from various_image_processings_tpu_torch.core.colors import bgr2lab_u8_exact
    from various_image_processings_tpu_torch.core.rng import random_image
    from various_image_processings_tpu_torch.models import slic
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic

    s_size, iters, m = SLIC_PARAMS
    sh, sw = SLIC_SHAPE
    h4, w4 = MAIN_SHAPE
    smooth = [smooth_image(sh, sw, seed) for seed in range(1, SLIC_BATCH + 1)]
    stripes = np.empty((sh, sw, 3), np.uint8)
    stripes[:] = (20, 200, 60)
    stripes[:, (np.arange(sw) // 4) % 2 == 1] = (220, 30, 140)
    mixed = [cell_ramp(sh, sw, s_size, 2), smooth[0], cell_ramp(sh, sw, s_size, 1),
             random_image(sh, sw), cell_ramp(sh, sw, s_size, 3), smooth[1],
             np.full((sh, sw, 3), 97, np.uint8), stripes]
    logical = par.make_mesh(batch=2, spatial=1, devices=[dev] * 2)
    cases = [("8x512 smooth", np.stack(smooth), "euclidean", mesh),
             ("8x512 mixed", np.stack(mixed), "euclidean", mesh),
             ("2x512 smooth ciede2000", np.stack(smooth[:2]), "ciede2000", mesh),
             ("2x512 smooth ciede2000_ref", np.stack(smooth[:2]), "ciede2000_ref", mesh),
             ("4x4K smooth", np.stack([smooth_image(h4, w4, seed) for seed in range(1, 5)]),
              "euclidean", mesh),
             ("8x512 smooth, 2x1 logical mesh", np.stack(smooth), "euclidean", logical)]
    launches = Counter()
    results = {}
    for label, images_np, metric, on in cases:
        imgs = torch.from_numpy(images_np).to(dev)
        b, h, w = imgs.shape[:3]
        rows = on.shape["batch"]
        singles = [vt.superpixel_slic(imgs[i], s_size, iters, m, metric) for i in range(b)]
        par.superpixel_slic_batched(imgs, s_size, iters, m, metric, mesh=on)  # warm
        # the main path, counted
        reset()
        kslic.metric_launches.clear()
        slic.host_syncs = slic.iterations = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = par.superpixel_slic_batched(imgs, s_size, iters, m, metric, mesh=on)
        syncs, ran = slic.host_syncs, slic.iterations
        got = read()
        by_metric = dict(kslic.metric_launches)
        expect(f"SLIC batched {label}", got,
               {f"slic_{name}": rows * iters for name in SLIC_KERNELS})
        if syncs != rows or by_metric != {("association", metric): rows * iters,
                                          ("snap_keys", metric): rows * iters}:
            raise SystemExit(f"SLIC batched {label}: {syncs} host syncs (expected {rows}), "
                             f"launches by metric {by_metric}")
        launches.update({name: got[f"slic_{name}"] for name in SLIC_KERNELS})
        launches.update(by_metric)
        for i in range(b):
            same(f"SLIC batched {label} image {i}", out[i], singles[i])
        slic.iterations = 0
        for i in range(b):
            vt.superpixel_slic(imgs[i], s_size, iters, m, metric)
        each = slic.iterations
        if each != ran:
            raise SystemExit(f"SLIC batched {label}: {ran} iterations, single calls {each}")

        def wall(fn) -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        # the batch and B single calls in turns
        batch_ms, single_ms = [], []
        for _ in range(SLIC_BATCH_CALLS):
            batch_ms.append(wall(lambda: par.superpixel_slic_batched(imgs, s_size, iters, m,
                                                                     metric, mesh=on)))
            single_ms.append(wall(lambda: [vt.superpixel_slic(imgs[i], s_size, iters, m, metric)
                                           for i in range(b)]))
        # the split of one batch call on one sub-batch a row, as the function runs it
        split = Counter()
        per = b // rows
        space_norm, color_norm = slic._norms(s_size, m)
        for row in range(rows):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            lab = bgr2lab_u8_exact(imgs[row * per:(row + 1) * per].contiguous())
            centers, labels, dists, sums, keys, state = slic.kmeans_state(lab, h, w, s_size,
                                                                          iters)
            ev[1].record()
            for it in range(iters):
                kslic.associate(lab, centers, labels, dists, sums, state, it, s_size,
                                space_norm, color_norm, metric)
                kslic.snap_keys(lab, centers, labels, sums, keys, state, it, s_size, metric)
                kslic.update(lab, centers, keys, sums, state, it, s_size)
            ev[2].record()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            slic.device_iterations = state[:, 0, 1]
            raw, lab_h, _ = slic._download(labels, lab, state[:, 0, 0].to(torch.float32))
            t2 = time.perf_counter()
            finals, conn_each = [], []
            for i in range(per):
                t_i = time.perf_counter()
                finals.append(slic.enforce_connectivity(raw[i], lab_h[i], s_size, metric))
                conn_each.append((time.perf_counter() - t_i) * 1e3)
            final = np.stack(finals)
            t3 = time.perf_counter()
            torch.from_numpy(final).to(dev)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for i in range(per):
                if not np.array_equal(final[i], out[row * per + i].cpu().numpy()):
                    raise SystemExit(f"SLIC batched {label}: the split call differs")
            split.setdefault("connectivity_each_ms", []).extend(conn_each)
            split.update({"lab_setup_ms": ev[0].elapsed_time(ev[1]),
                          "kmeans_ms": ev[1].elapsed_time(ev[2]), "d2h_ms": (t2 - t1) * 1e3,
                          "connectivity_ms": (t3 - t2) * 1e3, "h2d_ms": (t4 - t3) * 1e3,
                          "split_wall_ms": (t4 - t0) * 1e3})
        # image 0's connectivity pass right after a download of that image
        # alone (its planes just written by the copy), as a single call runs it
        one_raw, one_lab, _ = slic._download(labels[0], lab[0], state[0, 0, 0].float())
        t0 = time.perf_counter()
        slic.enforce_connectivity(one_raw, one_lab, s_size, metric)
        split["connectivity_alone_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            par.superpixel_slic_batched(imgs, s_size, iters, m, metric, mesh=on)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        n_launch, n_kmeans, busy_us = kernel_counts(prof)
        t = {"images": b, "rows": rows, "metric": metric, "wall_ms": statistics.median(batch_ms),
             "walls_ms": batch_ms, "b_single_ms": statistics.median(single_ms),
             "b_singles_ms": single_ms, **split, "iterations": ran, "host_syncs": syncs,
             "launches": n_launch, "kmeans_launches": n_kmeans,
             "device_busy": busy_us / 1e6 / prof_wall if busy_us else None,
             "drift_warnings": len(caught)}
        results[label] = t
        busy = "not measured" if t["device_busy"] is None else f"{t['device_busy']:.3f}"
        phase(f"24s. SLIC batched {label} (S={s_size}, {iters} it, m={m:g}, {metric}, mesh "
              f"{rows}x1): labels byte-equal to superpixel_slic per image; k-means launches "
              f"{iters} of each kernel a batch row ({rows * iters} in all), {syncs} host syncs "
              f"before connectivity, {ran} iterations (B single calls: {each}); warm wall "
              f"{t['wall_ms']:.3f} ms a batch (runs {', '.join(f'{x:.3f}' for x in batch_ms)}) "
              f"against B x the single call {t['b_single_ms']:.3f} ms (host clock, this run); "
              f"split: Lab and set-up {split['lab_setup_ms']:.3f} ms, k-means "
              f"{split['kmeans_ms']:.3f} ms (CUDA events), device->host {split['d2h_ms']:.3f} "
              f"ms, host connectivity {split['connectivity_ms']:.3f} ms (per image "
              f"{', '.join(f'{x:.3f}' for x in split['connectivity_each_ms'])}; image 0 after "
              f"its own download {split['connectivity_alone_ms']:.3f}), host->device "
              f"{split['h2d_ms']:.3f} ms (sum {split['split_wall_ms']:.3f}); kernel launches a "
              f"batch {n_launch} (k-means {n_kmeans}), device busy {busy} of the profiled "
              f"batch (torch.profiler); drift warnings {len(caught)} {since()}")
    return results, launches


def parallel_phases(dev) -> tuple[dict, Counter]:
    """Phases 24-26: the parallel layer and the timing twins.  24: batch
    fan-out on ``make_mesh()`` at BASELINE.md configs 5b and 3b, the ABF
    and gradient, SLIC and Wexler; 25: row sharding on logical shards of one
    card (real kernels on each shard, real halo copies); 26: ``measure``,
    ``trace`` and ``vip-torch-benchmark``.  Every batched and sharded output
    is held byte-equal to the single-device op, and each path's kernel
    launches are counted from 0.  Prints a ``{"parallel": ...}`` line and
    returns its object, with the SLIC k-means kernels' launches on the
    batched SLIC path (``slic_batch_phase``)."""
    import contextlib
    import io
    import warnings

    import torch

    import various_image_processings_tpu_torch as vt
    from various_image_processings_tpu_torch import parallel as par
    from various_image_processings_tpu_torch.parallel import spatial as par_spatial
    from various_image_processings_tpu_torch.cli import benchmark as cli_bench
    from various_image_processings_tpu_torch.core.rng import random_image
    from various_image_processings_tpu_torch.ops.cuda import adaptive_bilateral as kab
    from various_image_processings_tpu_torch.ops.cuda import bilateral as kbf
    from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as kbt
    from various_image_processings_tpu_torch.ops.cuda import gradient as kgr
    from various_image_processings_tpu_torch.ops.cuda import slic as kslic
    from various_image_processings_tpu_torch.ops.cuda import wexler_search as kws
    from various_image_processings_tpu_torch.utils.profiling import (
        cuda_time_ms, measure, measure_throughput)

    t_start = time.perf_counter()
    counters = {"gradient": (kgr, "launches"), "blur_rtv": (kbt, "blur_rtv_launches"),
                "guide": (kbt, "guide_launches"), "bilateral": (kbf, "launches"),
                "adaptive_bilateral": (kab, "launches"), "wexler_search": (kws, "launches"),
                **{f"slic_{name}": (kslic, f"{name}_launches") for name in SLIC_KERNELS}}

    def reset() -> None:
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read() -> dict:
        torch.cuda.synchronize()
        return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

    def expect(label: str, got: dict, want: dict) -> None:
        """The path launched exactly ``want`` (other kernels: none)."""
        full = {name: want.get(name, 0) for name in counters}
        if got != full:
            raise SystemExit(f"{label}: launches {got}, expected {full}")

    def same(label: str, a, b) -> None:
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise SystemExit(f"{label}: differs from the single-device op")

    def since() -> str:
        return f"({time.perf_counter() - t_start:.1f} s into phases 24-26)"

    results = {"batched": {}, "sharded": {}, "twins": {}}
    h, w = MAIN_SHAPE
    k, ss, sc = MAIN_PARAMS
    bh, bw = BTF_SHAPE
    mp_4k = h * w / 1e6

    # 24. batch fan-out on make_mesh(): every CUDA device on the batch axis
    mesh = par.make_mesh()
    phase(f"make_mesh(): {mesh}")
    results["mesh"] = repr(mesh)
    base = torch.from_numpy(random_image(h, w)).to(dev)
    # config 5b: 64 4K frames (row-rolls of one), built on the card
    frames = torch.empty((PARALLEL_BATCH, h, w, 3), dtype=torch.uint8, device=dev)
    for i in range(PARALLEL_BATCH):
        frames[i] = base.roll(i, 0)
    reset()
    out = par.bilateral_filter_batched(frames, k, ss, sc, mesh=mesh)
    expect("config 5b", read(), {"bilateral": PARALLEL_BATCH})
    for i in range(PARALLEL_BATCH):  # one image at a time: 64 outputs are never held twice
        same(f"config 5b image {i}", out[i], vt.bilateral_filter(frames[i], k, ss, sc))
    del out
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    batch_ms = cuda_time_ms(lambda: par.bilateral_filter_batched(frames, k, ss, sc, mesh=mesh),
                            iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated(dev) - resident
    single_ms = cuda_time_ms(lambda: vt.bilateral_filter(frames[0], k, ss, sc), iters=50)
    mps = PARALLEL_BATCH * mp_4k / batch_ms * 1e3
    phase(f"config 5b, {PARALLEL_BATCH}x{h}x{w} k={k}: byte-equal to the single-device op "
          f"per image; {PARALLEL_BATCH} bilateral launches; {batch_ms:.4f} ms a batch (CUDA "
          f"events, median of 5), {mps:.1f} MP/s; {PARALLEL_BATCH} x the single call "
          f"{PARALLEL_BATCH * single_ms:.4f} ms ({single_ms:.4f} ms a call); peak memory "
          f"{peak / 2**30:.3f} GiB over the resident {resident / 2**30:.3f} GiB (the input "
          f"batch among it) {since()}")
    results["batched"]["bf_64x4k"] = {
        "ms": batch_ms, "mps": mps, "launches": PARALLEL_BATCH, "single_ms": single_ms,
        "n_times_single_ms": PARALLEL_BATCH * single_ms, "peak_gib_over_resident": peak / 2**30}

    # config 3b: 8 600x900 frames, BTF k=9 nitr=3
    small = torch.from_numpy(random_image(bh, bw)).to(dev)
    small_frames = torch.stack([small.roll(i, 0) for i in range(BTF_BATCH)])
    reset()
    out = par.bilateral_texture_filter_batched(small_frames, BTF_KSIZE, BTF_NITR, mesh=mesh)
    n = BTF_BATCH * BTF_NITR
    expect("config 3b", read(), {"gradient": n, "blur_rtv": n, "guide": n, "bilateral": n})
    for i in range(BTF_BATCH):
        same(f"config 3b image {i}", out[i],
             vt.bilateral_texture_filter(small_frames[i], BTF_KSIZE, BTF_NITR))
    batch_ms = cuda_time_ms(lambda: par.bilateral_texture_filter_batched(
        small_frames, BTF_KSIZE, BTF_NITR, mesh=mesh), iters=5, warmup=1)
    single_ms = cuda_time_ms(lambda: vt.bilateral_texture_filter(
        small_frames[0], BTF_KSIZE, BTF_NITR), iters=20)
    phase(f"config 3b, {BTF_BATCH}x{bh}x{bw} BTF k={BTF_KSIZE} nitr={BTF_NITR}: byte-equal "
          f"per image; {4 * n} launches; {batch_ms:.4f} ms a batch (CUDA events, median of "
          f"5); {BTF_BATCH} x the single call {BTF_BATCH * single_ms:.4f} ms "
          f"({single_ms:.4f} ms a call) {since()}")
    results["batched"]["btf_8x600x900"] = {
        "ms": batch_ms, "launches": 4 * n, "single_ms": single_ms,
        "n_times_single_ms": BTF_BATCH * single_ms}

    # the ABF and the gradient on 8 4K frames
    eight = frames[:8]
    for name, batched, single, want in (
            ("abf", lambda: par.adaptive_bilateral_filter_batched(eight, k, ss, sc, mesh=mesh),
             lambda i: vt.adaptive_bilateral_filter(eight[i], k, ss, sc),
             {"adaptive_bilateral": len(eight)}),
            ("gradient", lambda: par.gradient_batched(eight, mesh=mesh),
             lambda i: vt.gradient(eight[i]), {"gradient": len(eight)})):
        reset()
        out = batched()
        expect(f"{name} batched", read(), want)
        for i in range(len(eight)):
            same(f"{name} batched image {i}", out[i], single(i))
        batch_ms = cuda_time_ms(batched, iters=5, warmup=1)
        single_ms = cuda_time_ms(lambda: single(0), iters=20)
        phase(f"{name} batched, {len(eight)}x{h}x{w}: byte-equal per image; {batch_ms:.4f} ms a batch, "
              f"{len(eight)} x the single call {len(eight) * single_ms:.4f} ms {since()}")
        results["batched"][f"{name}_8x4k"] = {"ms": batch_ms, "single_ms": single_ms,
                                              "n_times_single_ms": len(eight) * single_ms}
    del frames, eight, out

    # SLIC: each batch row's images as one device program (24s)
    results["batched"]["slic"], slic_launches = slic_batch_phase(dev, mesh, reset, read, expect,
                                                                 same, since)

    # Wexler, config 5a on two 402x700 images (phase 15's texture and its mirror)
    wh, ww = WEXLER_SHAPE
    tex = np.tile(random_image(37, 53) // 2, (-(-wh // 37), -(-ww // 53), 1))[:wh, :ww]
    wex_in = torch.from_numpy(np.stack([tex, tex[:, ::-1]]).copy()).to(dev)
    mask = torch.from_numpy(wexler_masks(wh, ww)["5a"]).to(dev)
    masks = torch.stack([mask, mask])
    reset()
    t0 = time.perf_counter()
    fills = par.inpainting_wexler_batched(wex_in, masks)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    searches = read()
    if searches["wexler_search"] < 2 or any(v for n_, v in searches.items()
                                            if n_ != "wexler_search"):
        raise SystemExit(f"Wexler batched: launches {searches}")
    t0 = time.perf_counter()
    for i in range(2):
        same(f"Wexler batched image {i}", fills[i], vt.inpainting_wexler(wex_in[i], masks[i]))
    single_s = time.perf_counter() - t0
    phase(f"Wexler batched, 2x{wh}x{ww} config 5a: byte-equal to inpainting_wexler per "
          f"image; {searches['wexler_search']} searches through the kernel; "
          f"{batch_s:.3f} s a batch, 2 single calls {single_s:.3f} s (host clock) {since()}")
    results["batched"]["wexler_2x402x700"] = {"s": batch_s, "singles_s": single_s,
                                              "searches": searches["wexler_search"]}

    # 25. row sharding on logical shards of one card.  On one card the shards
    #     run one after another, so sharded - single is the cost of the halo
    #     copies, crops and gather, not a scaling figure
    def logical(batch: int, spatial: int):
        return par.make_mesh(batch=batch, spatial=spatial, devices=[dev] * (batch * spatial))

    def sharded_case(label, fn, ref, single, want, iters=10):
        reset()
        got = fn()
        expect(label, read(), want)
        same(label, got, ref)
        ms, one_ms = cuda_time_ms(fn, iters=iters), cuda_time_ms(single, iters=iters)
        phase(f"{label}: byte-equal (tolerance 0), launches {sum(want.values())}; sharded "
              f"{ms:.4f} ms, single device {one_ms:.4f} ms: halo copies, crops and gather "
              f"cost {ms - one_ms:+.4f} ms (CUDA events, median of {iters}) {since()}")
        results["sharded"][label] = {"ms": ms, "single_ms": one_ms, "overhead_ms": ms - one_ms}

    ref_bf = vt.bilateral_filter(base, k, ss, sc)
    for d in SHARD_COUNTS:
        row = logical(1, d)
        label = f"bf {h}x{w} k={k} on {d} shards"
        sharded_case(label, lambda: par.bilateral_filter_sharded(base, k, ss, sc, mesh=row),
                     ref_bf, lambda: vt.bilateral_filter(base, k, ss, sc), {"bilateral": d})
        # the overhead's parts: the halo exchange (slices, edge rows, one cat a
        # shard) and the gather of the cropped outputs into one tensor
        devices = list(row.devices[0])
        exchange_ms = cuda_time_ms(lambda: par.halo_exchange_rows(
            par_spatial.split_rows(base, devices), k // 2))
        parts = par_spatial.split_rows(ref_bf, devices)
        gather_ms = cuda_time_ms(lambda: par_spatial.gather(parts, dev))
        phase(f"{label}: of which halo exchange {exchange_ms:.4f} ms, gather {gather_ms:.4f} "
              f"ms (CUDA events, median of 20)")
        results["sharded"][label].update(exchange_ms=exchange_ms, gather_ms=gather_ms)
    guide = base.flip(0).contiguous()
    jk, jss, jsc = BTF_PARAMS
    row = logical(1, 4)
    sharded_case(f"jbf {h}x{w} k={jk} on 4 shards",
                 lambda: par.joint_bilateral_filter_sharded(base, guide, jk, jss, jsc,
                                                            mesh=row),
                 vt.joint_bilateral_filter(base, guide, jk, jss, jsc),
                 lambda: vt.joint_bilateral_filter(base, guide, jk, jss, jsc),
                 {"bilateral": 4})
    sharded_case(f"abf {h}x{w} k={k} on 4 shards",
                 lambda: par.adaptive_bilateral_filter_sharded(base, k, ss, sc,
                                                               mesh=row),
                 vt.adaptive_bilateral_filter(base, k, ss, sc),
                 lambda: vt.adaptive_bilateral_filter(base, k, ss, sc),
                 {"adaptive_bilateral": 4})
    sharded_case(f"gradient {h}x{w} on 4 shards",
                 lambda: par.gradient_sharded(base, mesh=row), vt.gradient(base),
                 lambda: vt.gradient(base), {"gradient": 4})
    for img in (small, base):
        ih, iw = img.shape[:2]
        ref = vt.bilateral_texture_filter(img, BTF_KSIZE, BTF_NITR)
        for d in (2, 4):
            n, row = d * BTF_NITR, logical(1, d)
            sharded_case(f"btf {ih}x{iw} k={BTF_KSIZE} nitr={BTF_NITR} on {d} shards",
                         lambda: par.bilateral_texture_filter_sharded(
                             img, BTF_KSIZE, BTF_NITR, mesh=row),
                         ref, lambda: vt.bilateral_texture_filter(img, BTF_KSIZE, BTF_NITR),
                         {"gradient": n, "blur_rtv": n, "guide": n, "bilateral": n}, iters=5)
    four = torch.stack([base.roll(i, 1) for i in range(4)])
    four_guides = four.flip(1).contiguous()
    grid = logical(2, 2)
    for name, fn, ref_i, single in (
            ("bf", lambda: par.bilateral_filter_batch_spatial(four, k, ss, sc, mesh=grid),
             lambda i: vt.bilateral_filter(four[i], k, ss, sc),
             lambda: [vt.bilateral_filter(four[i], k, ss, sc) for i in range(4)]),
            ("jbf", lambda: par.joint_bilateral_filter_batch_spatial(
                four, four_guides, k, ss, sc, mesh=grid),
             lambda i: vt.joint_bilateral_filter(four[i], four_guides[i], k, ss, sc),
             lambda: [vt.joint_bilateral_filter(four[i], four_guides[i], k, ss, sc)
                      for i in range(4)])):
        sharded_case(f"{name} batch-spatial 4x{h}x{w} k={k} on a 2x2 mesh", fn,
                     torch.stack([ref_i(i) for i in range(4)]), single, {"bilateral": 8},
                     iters=5)

    # 26. the timing twins and vip-torch-benchmark
    bf = lambda: vt.bilateral_filter(base, k, ss, sc)  # noqa: E731
    event_ms = cuda_time_ms(bf, iters=50)
    wall_ms = measure(bf, 50)
    tp_ms, tp_mps = measure_throughput(bf, h * w, 50)
    phase(f"measure on the 4K BF: fenced wall mean {wall_ms:.4f} ms, measure_throughput "
          f"{tp_ms:.4f} ms ({tp_mps:.1f} MP/s); cuda_time_ms median {event_ms:.4f} ms; the "
          f"wall mean must not be below the event median {since()}")
    if min(wall_ms, tp_ms) < event_ms:
        raise SystemExit("a fenced wall time came out below the device time")
    # the trace is taken in a fresh process: in this one, the profiled runs
    # of phases 17 and 21-23 can leave CUPTI recording no device activity
    # (seen in a full run), and the trace must show the kernel
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([sys.executable, "-c", TRACE_SCRIPT, tmp], check=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    named = [n_ for n_ in kernels if re.search(r"bilateral_\w*kernel", n_)]
    phase(f"trace: {len(events)} events, device kernels {kernels[:4]}")
    if not named:
        raise SystemExit("the trace names no bilateral kernel")
    results["twins"] = {"measure_ms": wall_ms, "throughput_ms": tp_ms, "throughput_mps": tp_mps,
                        "cuda_time_ms": event_ms, "trace_kernels": len(kernels)}

    def bench(argv) -> dict:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if cli_bench.main(argv) != 0:
                raise SystemExit(f"vip-torch-benchmark {argv} failed")
        lines = {}
        for line in buf.getvalue().splitlines():
            if "[msec]" in line:
                match = re.fullmatch(r"(.+?)\s*: +([0-9.]+) \[msec\]  \( *([0-9.]+) MP/s\)", line)
                if match is None or not float(match.group(2)) > 0:
                    raise SystemExit(f"vip-torch-benchmark line does not parse: {line!r}")
                lines[match.group(1)] = float(match.group(2))
        if len(lines) != 9:
            raise SystemExit(f"vip-torch-benchmark printed {len(lines)} [msec] lines, not 9")
        phase(f"vip-torch-benchmark {' '.join(argv) or '(defaults)'}: "
              f"{time.perf_counter() - t0:.1f} s; " + "; ".join(f"{n_} {v:.4f} ms"
                                                               for n_, v in lines.items()))
        return lines

    results["twins"]["benchmark_default"] = bench([])
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "config.toml")
        with open(cfg, "w") as f:
            f.write("execute_times = 10\n")
        results["twins"]["benchmark_4k"] = bench(["--size", str(h), str(w), cfg])
    results["seconds"] = time.perf_counter() - t_start
    phase(f"phases 24-26 took {results['seconds']:.1f} s")
    print(json.dumps({"parallel": results}), flush=True)
    return results, slic_launches


def queued_ms(fn, n: int = 50) -> float:
    """Device ms per call of ``fn`` run back to back: the launches are
    queued behind a sleeping kernel first, so host launch time is not
    counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s: outlasts enqueueing the n calls
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def fill_grid_cases() -> list[tuple]:
    """(label, image u8, hole bool, initial, cap, box): the fill kernels'
    grid.  box is None for the hole's bucketed box, else (bh, bw, by0, bx0):
    the whole image, or a tight box 33 or 65 pixels wide (one or two
    ring-pick words and a pixel), one row tall, or at the image's left edge
    (the validity region starts at column 0).  Images of values 0..127 (the
    search is exact, so every piece is compared) unless the label says
    0..255 (the search is not compared there: its sums round in each
    order)."""
    from various_image_processings_tpu_torch.core.rng import random_image

    wh, ww = WEXLER_SHAPE
    whole = (wh, ww, 0, 0)
    tex = np.tile(random_image(37, 53) // 2, (-(-wh // 37), -(-ww // 53), 1))[:wh, :ww].copy()
    full = np.tile(random_image(37, 53), (-(-wh // 37), -(-ww // 53), 1))[:wh, :ww].copy()
    masks = {k: v > 0 for k, v in wexler_masks(wh, ww).items()}
    small = np.zeros((200, 300), bool)
    small[80:120, 130:170] = True                      # a 64x64 box, 1600 pixels
    yy, xx = np.mgrid[:60, :70]
    annulus = ((yy - 30) ** 2 + (xx - 35) ** 2 <= 144) & ((yy - 30) ** 2 + (xx - 35) ** 2 > 9)
    border = np.zeros((60, 70), bool)
    border[0:9, 50:70] = True
    lone = np.zeros((20, 20), bool)
    lone[9, 9] = True                                  # every window covers it: the search fails
    # 5c with an annulus around a known island: the restricted ring, whole image
    island = masks["5c"].copy()
    yy, xx = np.mgrid[:wh, :ww]
    d = (yy - 90) ** 2 + (xx - 150) ** 2
    island[(d <= 14 ** 2) & (d > 4 ** 2)] = True
    tight = {}
    for label, (ys, xs) in {"33 wide": (slice(20, 31), slice(17, 50)),
                            "65 wide": (slice(22, 27), slice(2, 67)),
                            "one row": (slice(33, 34), slice(9, 61)),
                            "left edge": (slice(14, 40), slice(0, 23))}.items():
        hole = np.zeros((60, 70), bool)
        hole[ys, xs] = True
        tight[label] = (hole, (ys.stop - ys.start, xs.stop - xs.start, ys.start, xs.start))

    def prefill(img, hole):
        out = img.copy()
        out[hole] = 64
        return out

    cases = [
        ("5a onion peel, cap 256", tex, masks["5a"], True, 256, None),
        ("5a energy pass, cap 1024", prefill(tex, masks["5a"]), masks["5a"], False, 1024, None),
        ("5a energy pass, cap 16", prefill(tex, masks["5a"]), masks["5a"], False, 16, None),
        ("5a energy pass, cap 1024, values 0..255", prefill(full, masks["5a"]), masks["5a"],
         False, 1024, None),
        ("5c onion peel, whole-image box, cap 256", tex, masks["5c"], True, 256, whole),
        ("5c energy pass, whole-image box, cap 1024", prefill(tex, masks["5c"]), masks["5c"],
         False, 1024, whole),
        ("5c + annulus island, whole-image box, onion peel, cap 1024", tex, island, True, 1024,
         whole),
        ("200x300 64x64 box, energy pass, cap 1024", prefill(tex[:200, :300], small), small,
         False, 1024, None),
        ("200x300 64x64 box, onion peel, cap 64", tex[:200, :300], small, True, 64, None),
        ("hole at the image border, onion peel, cap 64", tex[:60, :70], border, True, 64, None),
        ("hole at the image border, energy pass, cap 16", prefill(tex[:60, :70], border), border,
         False, 16, None),
        ("island mask (annulus), onion peel, cap 256", tex[:60, :70], annulus, True, 256, None),
        ("island mask (annulus), whole-image box, cap 32", tex[:60, :70], annulus, True, 32,
         (60, 70, 0, 0)),
        ("failing search 20x20, onion peel", tex[:20, :20], lone, True, 256, None),
        ("failing search 20x20, energy pass", tex[:20, :20], lone, False, 16, None),
    ]
    for label, (hole, box) in tight.items():
        cases.append((f"{label} box, onion peel, cap 16", tex[:60, :70], hole, True, 16, box))
        cases.append((f"{label} box, energy pass, cap 64", prefill(tex[:60, :70], hole), hole,
                      False, 64, box))
    return cases


def fill_pass_for(wexler, img_np, hole, initial, cap, box, route, dev):
    """A ``_FillPass`` on the card for one grid case."""
    import torch

    h, w = hole.shape
    if box is None:
        (bh, bw), (by0, bx0) = wexler.WexlerInpainting._hole_bbox(hole)
        box = (bh, bw, by0, bx0)
    island = wexler._island_known(hole) if initial else None
    rem = torch.from_numpy(hole.astype(np.float32)).to(dev)
    weight = torch.from_numpy(wexler.calculate_weight(hole).astype(np.float32)).to(dev)
    island = None if island is None else torch.from_numpy(island.astype(np.float32)).to(dev)
    return wexler._FillPass(torch.from_numpy(img_np).to(dev).float(), rem, weight, h, w, initial,
                            cap, box, island, route)


FILL_PIECES = ("ring_pick", "filters", "search", "commit")
FILL_BUFFERS = ("img", "rem", "p", "f", "b2", "valid", "keys", "tyx", "state")
FILL_GRID_ITERATIONS = 8  # iterations a grid case at most
FILL_KERNELS = ("wexler_ring_pick", "wexler_filters", "wexler_commit", "wexler_diffusion")
# the diffusion start's boxes (label, image h, w, box (bh, bw, by0, bx0)): 1x1,
# a row, a column, small and coarse-level shapes, the largest box, a box with
# fewer rows than 16 strips, a box at the image border, and two whose threads
# take more than one pixel each
DIFFUSION_BOXES = (
    ("1x1", 9, 9, (1, 1, 4, 4)),
    ("1x128", 20, 140, (1, 128, 7, 5)),
    ("128x1", 140, 20, (128, 1, 5, 7)),
    ("7x13", 30, 40, (7, 13, 11, 17)),
    ("50x87", 64, 100, (50, 87, 6, 8)),
    ("128x128", 150, 160, (128, 128, 10, 20)),
    ("5x200", 20, 220, (5, 200, 6, 9)),
    ("border", 60, 70, (20, 33, 0, 37)),
    ("100x150", 110, 160, (100, 150, 4, 5)),
    ("2x1030", 6, 1040, (2, 1030, 2, 6)),
)


def diffusion_case(h: int, w: int, box: tuple, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(u8 image, f32 hole mask): a hole over ~85% of the box with known
    pixels inside it (a hole-free column), the box's origin a hole pixel."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    bh, bw, by0, bx0 = box
    hole = np.zeros((h, w), bool)
    hole[by0:by0 + bh, bx0:bx0 + bw] = rng.random((bh, bw)) < 0.85
    if bw > 4:
        hole[by0:by0 + bh, bx0 + bw // 3] = False
    hole[by0, bx0] = True
    return src, hole.astype(np.float32)


def fill_a_b(parent, piece: str, k) -> str:
    """The parent's ``piece`` kernel and this tree's on the state of the
    ``_FillPass`` k, timed in turns (parent, change, change, parent), then
    each once from that state with every buffer compared bit for bit.
    Returns the parent's times ("a / b ms") and leaves k's buffers as one
    launch of this tree's kernel leaves them."""
    import torch

    snap = {name: getattr(k, name).clone() for name in FILL_BUFFERS}
    fns = {"parent": parent_fill_launch(parent, piece, k), "change": getattr(k, piece)}
    ms = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        ms[who].append(queued_ms(fns[who], 50))
    after = {}
    for who in ("parent", "change"):
        for name, t in snap.items():
            getattr(k, name).copy_(t)
        fns[who]()
        after[who] = {name: getattr(k, name).clone() for name in FILL_BUFFERS}
    torch.cuda.synchronize()
    bad = [name for name in FILL_BUFFERS
           if not torch.equal(after["parent"][name].view(torch.uint8)
                              if after["parent"][name].dtype != torch.uint8
                              else after["parent"][name],
                              after["change"][name].view(torch.uint8)
                              if after["change"][name].dtype != torch.uint8
                              else after["change"][name])]
    if bad:
        raise SystemExit(f"the parent's Wexler {piece} and this tree's differ in {bad}")
    return " / ".join(f"{t:.4f}" for t in ms["parent"]) + " ms in turns"


def fill_work(k) -> dict:
    """{piece: (bytes, operations)} of an iteration of the pass ``k`` after
    its ring pick: the ring pick reads the box's rows up to its last target's
    (onion peels: one more, and with islands the seed masks where a pixel is
    known) and writes the targets and keys; the filters read the image and
    mask under the targets' and the validity region's windows and write the
    targets' filters, b2 and the region's map; the commit reads and writes
    what its targets touch."""
    import torch
    from various_image_processings_tpu_torch.ops.cuda import wexler_fill as kfill

    height, width = k.height, k.width
    bh, bw, by0, bx0 = k.box
    cap, tp = k.cap, k.f.shape[1]
    count = int(k.state[kfill.COUNT])
    rows = bh
    if count == cap:  # the scan stops at the band that holds the cap-th target
        rows = min(bh, int(k.tyx[0, cap - 1]) - by0 + 1 + k.initial)
    rem_box = k.rem[by0 : by0 + rows, bx0 : bx0 + bw]
    seeds = 0
    if k.island is not None:
        known = rem_box == 0
        seeds = int(known.sum()) + int((known & (k.rem0[by0 : by0 + rows, bx0 : bx0 + bw] <= 0))
                                       .sum())
    vy0, vx0, vh, vw = kfill.validity_region(height, width, k.box)
    tmap = torch.zeros((height, width), device=k.rem.device)
    tmap[k.tyx[0, :count].long(), k.tyx[1, :count].long()] = 1.0
    under = torch.nn.functional.max_pool2d(tmap[None, None], 13, 1, 6)[0, 0] > 0
    under[vy0 : vy0 + vh + 12, vx0 : vx0 + vw + 12] = True
    return {
        "ring_pick": (rows * bw * 4 + seeds * 4 + 2 * cap * 4 + tp * 8 + 32, 9 * rows * bw),
        "filters": (int(under.sum()) * 16 + count * (13 * 117 * 2 + 4) + vh * vw,
                    count * (13 * 117 + 2 * 507) + vh * vw * 169),
        "commit": (count * (8 + 4 + 8 + 4 + 12 + 12 + 4 + 13 * 9 * 2) + 32,
                   count * (9 + 13 * 9 + 2) + 2 * count),
    }


def fill_kernel_phases(dev, parent=None) -> dict:
    """Phases 14b and 16b: the fill-loop kernels (csrc/wexler_fill.cu; the
    JAX package runs the loop as XLA while_loops, no Pallas kernel).  14b:
    each kernel against its plain piece on the card, bit for bit: a kernel
    pass and a plain pass side by side over ``fill_grid_cases()``, the plain
    pass's buffers copied from the kernel pass's before every piece, every
    buffer compared after it (the search too where the image is exact); the
    diffusion start against the plain ``_alt_init_device`` on a 128x128 box
    and a 50x87 level, with and without the dither.  16b: each kernel's
    device time at the 5a top level's energy pass (402x700, a 128x128 box,
    cap 1024), the ring pick's and the filters' also at the 5a onion peel
    (cap 256) and on the whole-image 5c box with an island (cap 1024), queued
    behind a sleep kernel, its plain piece's and its bound; the diffusion
    start's on a 128x128 box; the ring pick and filters at each of the 5a
    energy pass's first 4 iterations (its scan ends lower in the box each
    time), and with ``parent`` (``build_parent``) the parent's ring pick and
    filters in turns with this tree's (parent, change, change, parent) on
    every state timed, their buffers bit-equal.  Returns {kernel:
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, at[, other_shapes]}}."""
    import torch

    from various_image_processings_tpu_torch.models import inpainting as wexler
    from various_image_processings_tpu_torch.ops.cuda import _build
    from various_image_processings_tpu_torch.ops.cuda import wexler_fill as kfill
    from various_image_processings_tpu_torch.utils.profiling import cuda_time_ms

    def bits(t):
        return {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype, t.dtype)

    def used(fp, name):
        """A pass buffer without the search keys of the padded targets (past
        cap), which the kernel computes and nothing reads."""
        return fp.keys[: fp.cap] if name == "keys" else getattr(fp, name)

    def err(a, b) -> float:
        """max |a - b| in f64 over the elements whose bits differ (inf where
        one is a NaN or the two are opposite infinities); the state's words
        count as integers."""
        ne = a.view(bits(a)) != b.view(bits(b))
        if not bool(ne.any()):
            return 0.0
        d = (a[ne].double() - b[ne].double()).abs()
        return float(torch.nan_to_num(d, nan=float("inf")).max())

    t_start = time.perf_counter()
    cases = iterations = 0
    worst = dict.fromkeys(FILL_KERNELS, 0.0)
    for label, img_np, hole, initial, cap, box in fill_grid_cases():
        exact = "0..255" not in label
        k = fill_pass_for(wexler, img_np, hole, initial, cap, box, "cuda", dev)
        p = fill_pass_for(wexler, img_np, hole, initial, cap, box, "torch", dev)
        if "island" in label and k.island is None:
            raise SystemExit(f"fill grid FAILED: {label} has no known island")
        for it in range(FILL_GRID_ITERATIONS):
            for piece in FILL_PIECES:
                for name in FILL_BUFFERS:
                    getattr(p, name).copy_(getattr(k, name))
                getattr(k, piece)()
                getattr(p, piece)()
                if piece == "search" and not exact:
                    continue
                differ = {name: int((used(k, name).view(bits(used(k, name)))
                                     != used(p, name).view(bits(used(p, name)))).sum())
                          for name in FILL_BUFFERS}
                if piece != "search":
                    worst[f"wexler_{piece}"] = max(
                        worst[f"wexler_{piece}"],
                        *(err(used(k, name), used(p, name)) for name in FILL_BUFFERS))
                bad = {n: c for n, c in differ.items() if c}
                if bad:
                    raise SystemExit(f"fill grid FAILED: {label}, iteration {it}, {piece}: "
                                     f"kernel and plain piece differ in {bad} elements")
            iterations += 1
            if not int(k.state[kfill.ACTIVE]):
                break
        cases += 1
        if "failing" in label and not int(k.state[kfill.FAIL]):
            raise SystemExit(f"fill grid FAILED: {label}: the pass did not fail")
    # the diffusion start: a 128x128 box (BEAM_MAX_DIM) and the 5a coarsest
    # level, then DIFFUSION_BOXES (a cluster of min(bh, 16) strips a channel)
    from various_image_processings_tpu_torch.core.rng import random_image
    diffusion_cases = 0
    inputs = []
    for h, w in ((128, 128), (50, 87)):
        hole = np.zeros((h, w), bool)
        hole[h // 5 : h - h // 6, w // 4 : w - w // 5] = True
        hole[h // 2 :, w // 2 - 3 : w // 2 + 3] = True
        (bh, bw), (by0, bx0) = wexler.WexlerInpainting._hole_bbox(hole)
        inputs.append((f"{h}x{w}", random_image(h, w), hole.astype(np.float32),
                       (bh, bw, by0, bx0)))
    for label, h, w, box in DIFFUSION_BOXES:
        inputs.append((label, *diffusion_case(h, w, box), box))
    clusters = {}
    for label, src, rem0, (bh, bw, by0, bx0) in inputs:
        h, w = rem0.shape
        img, rem = torch.from_numpy(src).to(dev), torch.from_numpy(rem0).to(dev)
        clusters[label] = kfill.diffusion_shape(bh, bw)[0]
        if clusters[label] != min(bh, 16):
            raise SystemExit(f"diffusion start FAILED: box {bh}x{bw} got a cluster of "
                             f"{clusters[label]} CTAs")
        for dither in (False, True):
            got = wexler._alt_init_device(img, rem, h, w, (bh, bw), (by0, bx0), dither, "cuda")
            want = wexler._alt_init_device(img, rem, h, w, (bh, bw), (by0, bx0), dither, "torch")
            d = max_diff(got, want)
            worst["wexler_diffusion"] = max(worst["wexler_diffusion"], float(d))
            if d:
                raise SystemExit(f"diffusion start FAILED: {label} box {bh}x{bw} dither "
                                 f"{dither}: max |diff| {d}")
            diffusion_cases += 1
    torch.cuda.synchronize()
    phase(f"14b. Wexler fill kernels vs their plain pieces on the card: {cases} passes "
          f"({iterations} iterations; boxes 64x64 to the whole 402x700 image and tight boxes "
          f"33 and 65 wide, one row tall and at the image's left edge, caps 16 to 1024, onion "
          f"peel and energy passes, a hole at the image border, island masks (the whole 5c "
          f"image with an annulus), a failing search, a full-range image), every buffer "
          f"bit-equal after every piece "
          f"(ring pick, filters, commit; the search where the image is exact); diffusion start "
          f"{diffusion_cases} cases (boxes, with their CTAs a channel: {clusters}; dither off "
          f"and on) bit-equal (tolerance 0); max |diff| {worst} "
          f"({time.perf_counter() - t_start:.1f} s)")

    # 16b. times at the 5a top level's energy pass (the kernels line's), at
    #      its onion peel and on the whole-image 5c box with an island, and
    #      bounds from each pass's own work; max_abs_err is phase 14b's
    #      largest difference
    out = {}
    timed = (("5a energy pass, cap 1024", ("ring_pick", "filters", "commit")),
             ("5a onion peel, cap 256", ("ring_pick", "filters")),
             ("5c + annulus island, whole-image box, onion peel, cap 1024",
              ("ring_pick", "filters")))
    grid = {c[0]: c[1:] for c in fill_grid_cases()}
    for label, pieces in timed:
        img_np, hole, initial, cap, box = grid[label]
        k = fill_pass_for(wexler, img_np, hole, initial, cap, box, "cuda", dev)
        p = fill_pass_for(wexler, img_np, hole, initial, cap, box, "torch", dev)
        k.ring_pick()
        k.filters()
        k.search()
        for name in FILL_BUFFERS:
            getattr(p, name).copy_(getattr(k, name))
        work = fill_work(k)
        bh, bw, _, _ = k.box
        at = (f"{k.height}x{k.width} {label.split(',')[0]}, box {bh}x{bw}, cap {cap}, "
              f"{int(k.state[kfill.COUNT])} targets")
        for piece in pieces:
            name = f"wexler_{piece}"
            k_ms = queued_ms(getattr(k, piece), 50)
            p_ms = cuda_time_ms(getattr(p, piece), iters=5, warmup=1)
            b_ms, b_by = bound(*work[piece])
            cell = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "at": at}
            if name in out:
                out[name]["other_shapes"].append(cell)
            else:
                out[name] = {"max_abs_err": worst[name], **cell, "other_shapes": []}
            was = PARENT_MS.get((name, label), "not measured")
            if parent is not None and piece in ("ring_pick", "filters"):
                was = fill_a_b(parent, piece, k)
            phase(f"16b. {name} at {at}: kernel {k_ms:.4f} ms (parent {was}), plain piece "
                  f"{p_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} ({k_ms / b_ms:.0f}x)")
    # the 5a energy pass's first iterations: each one's targets lie further
    # down the box, where a scan that stops at cap goes further
    img_np, hole, initial, cap, box = grid["5a energy pass, cap 1024"]
    k = fill_pass_for(wexler, img_np, hole, initial, cap, box, "cuda", dev)
    for it in range(4):
        times = []
        for piece in ("ring_pick", "filters"):  # each on the state the pass gives it
            snap = {name: getattr(k, name).clone() for name in FILL_BUFFERS}
            k_ms = queued_ms(getattr(k, piece), 50)
            was = "" if parent is None else f" (parent {fill_a_b(parent, piece, k)})"
            times.append(f"{piece} {k_ms:.4f} ms{was}")
            for name, t in snap.items():
                getattr(k, name).copy_(t)
            getattr(k, piece)()
        last = int(k.tyx[0, k.cap - 1]) - k.box[2]
        k.search()
        k.commit()
        phase(f"16b. 5a energy pass, iteration {it + 1} (targets down to box row {last}): "
              + ", ".join(times))
    # the diffusion start on a 128x128 box: (bh + bw) sweeps of 9 adds and a
    # product a hole pixel and channel
    img = torch.from_numpy(random_image(128, 128)).to(dev)
    hole = np.zeros((128, 128), bool)
    hole[16:112, 20:110] = True
    (bh, bw), (by0, bx0) = wexler.WexlerInpainting._hole_bbox(hole)
    rem = torch.from_numpy(hole.astype(np.float32)).to(dev)
    n_hole = int(hole.sum())
    ninth = float(np.float32(1.0 / 9.0))
    into = img.clone()
    lib = _build.load_library()

    def kernel_alone() -> None:
        """One launch into a preallocated output: the kernel without the
        wrapper's clone of the image (not counted as a main-path launch)."""
        err = lib.vip_wexler_diffusion(img.data_ptr(), rem.data_ptr(), into.data_ptr(), bh, bw,
                                       by0, bx0, 128, 1, ninth,
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"diffusion start launch failed: cudaError_t {err}")

    alone_ms = queued_ms(kernel_alone, 20)
    # a sweep's cost with neighbours (16 strips) and without (one strip: a
    # 1x128 box, one CTA a channel)
    row_img = torch.from_numpy(random_image(3, 130)).to(dev)
    row_rem = torch.zeros((3, 130), device=dev)
    row_rem[1, 1:129] = 1.0
    row_out = row_img.clone()

    def row_alone() -> None:
        err = lib.vip_wexler_diffusion(row_img.data_ptr(), row_rem.data_ptr(),
                                       row_out.data_ptr(), 1, 128, 1, 1, 130, 1, ninth,
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"diffusion start launch failed: cudaError_t {err}")

    row_ms = queued_ms(row_alone, 20)
    k_ms = queued_ms(lambda: wexler._alt_init_device(img, rem, 128, 128, (bh, bw), (by0, bx0),
                                                     True, "cuda"), 20)
    if not torch.equal(into, wexler._alt_init_device(img, rem, 128, 128, (bh, bw), (by0, bx0),
                                                     True, "torch")):
        raise SystemExit("diffusion start FAILED: the kernel alone differs from the plain path")
    p_ms = cuda_time_ms(lambda: wexler._alt_init_device(img, rem, 128, 128, (bh, bw), (by0, bx0),
                                                        True, "torch"), iters=3, warmup=1)
    b_ms, b_by = bound(bh * bw * 7 + n_hole * 3, (bh + bw) * n_hole * 3 * 10 + bh * bw * 6)
    cluster, smem = kfill.diffusion_shape(bh, bw)
    out["wexler_diffusion"] = {"max_abs_err": worst["wexler_diffusion"], "ms": alone_ms,
                               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                               "with_clone_ms": k_ms, "cluster": cluster,
                               "at": f"128x128, box {bh}x{bw}, {n_hole} hole pixels, dither; "
                                     f"the kernel alone ({k_ms:.4f} ms with the clone)"}
    phase(f"16b. wexler_diffusion 128x128 (box {bh}x{bw}, {n_hole} hole pixels, {bh + bw} "
          f"sweeps, dither): kernel {alone_ms:.4f} ms alone, {k_ms:.4f} ms with the clone of "
          f"the image (parent, clone included: {PARENT_MS['wexler_diffusion', '128x128']}); "
          f"{cluster} CTAs a channel in a cluster, {3 * cluster} CTAs, {smem} B of shared "
          f"memory a CTA; plain {p_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({alone_ms / b_ms:.0f}x); {alone_ms * 1e3 / (bh + bw):.3f} us a sweep, against "
          f"{row_ms * 1e3 / 129:.3f} on a 1x128 box (one CTA a channel, no neighbours)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    phase(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    import various_image_processings_tpu_torch as vt
    from various_image_processings_tpu_torch.cli import adaptive_bilateral_filter as cli_abf
    from various_image_processings_tpu_torch.cli import bilateral_filter as cli_bf
    from various_image_processings_tpu_torch.cli import bilateral_texture_filter as cli_btf
    from various_image_processings_tpu_torch.cli import wexler_inpainting as cli_wex
    from various_image_processings_tpu_torch.core.rng import random_array, random_image
    from various_image_processings_tpu_torch.models import inpainting as wexler
    from various_image_processings_tpu_torch.ops import wexler_search as search_op
    from various_image_processings_tpu_torch.ops import bilateral_texture as obt
    from various_image_processings_tpu_torch.ops.adaptive_bilateral import _abf_math
    from various_image_processings_tpu_torch.ops.bilateral import _bilateral_math
    from various_image_processings_tpu_torch.ops.cuda import _build
    from various_image_processings_tpu_torch.ops.cuda import adaptive_bilateral as kab
    from various_image_processings_tpu_torch.ops.cuda import bilateral as kbf
    from various_image_processings_tpu_torch.ops.cuda import bilateral_texture as kbt
    from various_image_processings_tpu_torch.ops.cuda import gradient as kgr
    from various_image_processings_tpu_torch.ops.cuda import wexler_fill as kfill
    from various_image_processings_tpu_torch.ops.cuda import wexler_search as kws
    from various_image_processings_tpu_torch.ops.gradient import _gradient_math
    from various_image_processings_tpu_torch.ops.wexler_search import _search_min_math
    from various_image_processings_tpu_torch.utils.io import imread, imwrite
    from various_image_processings_tpu_torch.utils.profiling import cuda_time_ms

    # 1. build
    t0 = time.perf_counter()
    _build.load_library()
    phase(f"built {_build.library_path().name} from {len(_build.sources())} source(s) "
          f"in {time.perf_counter() - t0:.2f} s")
    ptxas = ptxas_summary(_build.ptxas_report())
    for name, (regs, st, ld) in ptxas.items():
        phase(f"ptxas {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    # the association (each metric's instantiation), the diffusion start, the
    # ring pick and the filters must spill nothing
    unspilled = {name: (st, ld) for name, (_, st, ld) in ptxas.items()
                 if any(k in name for k in ("slic_association_kernel", "wexler_diffusion_kernel",
                                            "wexler_ring_pick_kernel", "wexler_filters_kernel"))}
    phase(f"association, diffusion-start, ring-pick and filters kernels: {len(unspilled)} "
          f"instantiations, spill (stores, loads) {sorted(set(unspilled.values()))} B")
    if len(unspilled) != 6 or any(st or ld for st, ld in unspilled.values()):
        raise SystemExit(f"the association, diffusion-start, ring-pick or filters kernels "
                         f"spill: {unspilled}")
    funcs = sass_functions(str(_build.library_path()))
    for part, what in (("bilateral_kernelILb0ELi4E", "bilateral self, 4 pixels a thread"),
                       ("adaptive_bilateral_kernel", "adaptive bilateral"),
                       ("blur_rtv_kernelILi9ELb0E", "blur + mRTV, k=9"),
                       ("guide_kernelILi9E", "guide, k=9")):
        for name, n, ops in sass_loops(funcs, part):
            top = ", ".join(f"{op} {c}" for op, c in ops.most_common(12))
            phase(f"SASS loop of {what} ({name}): {n} instructions: {top}")
    for part, what in (("guide_kernelILi9E", "guide, k=9 (4 pixels a thread)"),
                       ("gradient_words_kernelILi3E", "gradient, u8 C=3 (4 pixels x 2 rows "
                                                      "a thread)")):
        for name, code in funcs.items():
            if part in name:
                top = ", ".join(f"{op} {c}" for op, c in
                                opcodes([t for _, t in code]).most_common(14))
                phase(f"SASS of the whole {what} kernel ({name}): {len(code)} instructions: "
                      f"{top}")
    parent = None
    if "--parent-csrc" in sys.argv:
        t0 = time.perf_counter()
        parent = build_parent(sys.argv[sys.argv.index("--parent-csrc") + 1])
        phase(f"built the parent's bilateral, guide, gradient, ring-pick and filters kernels in "
              f"{time.perf_counter() - t0:.2f} s")
    def parent_gradient(src):
        out = torch.empty(src.shape[:2], dtype=torch.float32, device=src.device)
        err = parent.vip_gradient(src.data_ptr(), out.data_ptr(), src.shape[0], src.shape[1],
                                  src.shape[2], int(src.dtype == torch.float32),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"the parent's gradient kernel did not launch: cudaError_t {err}")
        return out

    def parent_guide(blurred, rtv):
        out = torch.empty(blurred.shape, dtype=torch.uint8, device=blurred.device)
        err = parent.vip_guide(blurred.data_ptr(), rtv.data_ptr(), out.data_ptr(),
                               rtv.shape[0], rtv.shape[1], BTF_KSIZE,
                               float(kbt.sigma_alpha(BTF_KSIZE)),
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"the parent's guide kernel did not launch: cudaError_t {err}")
        return out

    lb = _build.load_library()
    phase("shared memory per block (all dynamic), as (bytes, tap rows x tap columns a band): "
          "bilateral at 4K " + ", ".join(
              f"k={2 * r + 1} {'joint' if j else 'self'} "
              f"{lb.vip_bilateral_smem_bytes(r, j, MAIN_SHAPE[0])} B "
              f"{lb.vip_bilateral_columns_per_thread(r, MAIN_SHAPE[0])} blocked columns/thread "
              f"{lb.vip_bilateral_pixels_per_thread(r, j)} px/thread "
              f"{lb.vip_bilateral_band(r, j, 0)}x{lb.vip_bilateral_band(r, j, 1)}"
              for r, j in ((4, 0), (5, 0), (8, 1), (15, 0), (31, 0), (32, 0), (31, 1), (32, 1),
                           (109, 0), (110, 0), (74, 1), (75, 1), (150, 1)))
          + "; adaptive bilateral " + ", ".join(
              f"k={2 * r + 1} {lb.vip_adaptive_bilateral_smem_bytes(r)} B "
              f"{lb.vip_adaptive_bilateral_band(r, 0)}x"
              f"{lb.vip_adaptive_bilateral_band(r, 1)}" for r in (4, 88, 89, 150))
          + "; blur + mRTV " + ", ".join(
              f"k={2 * r + 1} {lb.vip_blur_rtv_smem_bytes(r)} B "
              f"{lb.vip_blur_rtv_band(r, 0)}x{lb.vip_blur_rtv_band(r, 1)}"
              for r in (4, 59, 60, 150))
          + "; guide " + ", ".join(
              f"k={2 * r + 1} {lb.vip_guide_smem_bytes(r)} B "
              f"{lb.vip_guide_band(r, 0)}x{lb.vip_guide_band(r, 1)}"
              for r in (4, 54, 55, 110, 150))
          + f"; wexler_search {lb.vip_wexler_search_smem_bytes()} B")

    # 2. parity grid: kernel vs the plain version on the same CUDA tensors,
    #    and vs the plain version on the CPU
    worst = 0
    cases = 0
    for h, w in GRID_SHAPES:
        src_np = random_image(h, w)
        guide_np = src_np[::-1].copy()
        src, guide = torch.from_numpy(src_np).to(dev), torch.from_numpy(guide_np).to(dev)
        for k in GRID_KSIZES:
            for joint in (False, True):
                g = guide if joint else None
                for border, rounding in GRID_MODES:
                    got = kbf.bilateral(src, g, k, 10.0, 30.0, border, rounding)
                    ref = _bilateral_math(src, guide if joint else src, k, 10.0, 30.0,
                                          border, rounding)
                    ref_cpu = _bilateral_math(src.cpu(), (guide if joint else src).cpu(),
                                              k, 10.0, 30.0, border, rounding)
                    d = max(max_diff(got, ref), max_diff(got.cpu(), ref_cpu))
                    cases += 1
                    if d != 0:
                        raise SystemExit(f"parity FAILED: {h}x{w} k={k} joint={joint} "
                                         f"{border}/{rounding}: max |diff| {d}")
                    worst = max(worst, d)
    torch.cuda.synchronize()
    phase(f"parity grid: {cases} cases (k {GRID_KSIZES}, self+joint, "
          f"{list(GRID_MODES)}, shapes {GRID_SHAPES}): max |diff| {worst} (tolerance 0)")

    # 3. the main path, counted: op (impl="auto"), module, CLI
    h, w = MAIN_SHAPE
    k, ss, sc = MAIN_PARAMS
    img_np = random_image(h, w)
    img = torch.from_numpy(img_np).to(dev)
    module = vt.BilateralFilter(h, w, k, ss, sc).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        in_path, out_path = os.path.join(tmp, "in.png"), os.path.join(tmp, "out.png")
        imwrite(in_path, img_np)
        torch.cuda.synchronize()
        kbf.launches = 0
        out = vt.bilateral_filter(img, k, ss, sc)
        torch.cuda.synchronize()
        op_launches = kbf.launches
        out_module = module(img)
        torch.cuda.synchronize()
        module_launches = kbf.launches - op_launches
        cli_bf.main([in_path, "-o", out_path, "--device", "cuda"])
        launches = kbf.launches
        out_cli = imread(out_path)
    phase(f"main path {h}x{w} k={k}: launches op {op_launches}, module {module_launches}, "
          f"CLI {launches - op_launches - module_launches}, total {launches}")
    if op_launches != 1 or module_launches != 1 or launches < 3:
        raise SystemExit("main path did not go through the kernel")
    if out.shape != img.shape or out.dtype != torch.uint8 or not out.is_cuda:
        raise SystemExit(f"bad output {tuple(out.shape)} {out.dtype} {out.device}")
    plain = _bilateral_math(img, img, k, ss, sc)
    d_plain = max_diff(out, plain)
    d_module = max_diff(out_module, out)
    d_cli = int(np.abs(out_cli.astype(np.int64) - out.cpu().numpy().astype(np.int64)).max())
    changed = float((out != img).any(dim=2).float().mean().item())
    phase(f"main path vs plain max |diff| {d_plain}, module vs op {d_module}, "
          f"CLI vs op {d_cli} (tolerance 0); share of pixels changed by the filter "
          f"{changed:.4f} (must be > 0.5)")
    if d_plain or d_module or d_cli or changed < 0.5:
        raise SystemExit("main path output wrong")
    worst = max(worst, d_plain, d_module, d_cli)

    # 4. times at the main path's shape
    taps, lut = kbf.device_tables(k, ss, sc, img.device)
    ms = cuda_time_ms(lambda: kbf.joint_bilateral(img, None, taps, lut, k // 2), iters=50)
    op_ms = cuda_time_ms(lambda: vt.bilateral_filter(img, k, ss, sc), iters=50)
    plain_ms = cuda_time_ms(lambda: _bilateral_math(img, img, k, ss, sc), iters=10)
    mp = h * w / 1e6
    phase(f"4K k=9 bilateral: kernel {ms:.4f} ms ({mp / ms * 1e3:.1f} MP/s; parent "
          f"{PARENT_MS['bilateral 4K k=9']} ms), "
          f"op {op_ms:.4f} ms ({mp / op_ms * 1e3:.1f} MP/s), "
          f"plain {plain_ms:.4f} ms ({mp / plain_ms * 1e3:.1f} MP/s)")
    n_taps = int(taps.shape[0])
    # per tap: ws * lut, 3 products and 4 sums; per pixel and channel: a division and a rounding
    bf_bound, bf_bound_by = bound(2 * h * w * 3, h * w * (8 * n_taps + 6))
    phase(f"4K k=9 bilateral bound: {bf_bound:.4f} ms by {bf_bound_by} ({n_taps} taps)")

    # 5. the BTF-shaped joint filter (k=17, sigma_s=8, sigma_c=sqrt 3, cpp variant)
    bh, bw = BTF_SHAPE
    bk, bss, bsc = BTF_PARAMS
    src = torch.from_numpy(random_image(bh, bw)).to(dev)
    guide = torch.flip(src, dims=(0,)).contiguous()
    got = kbf.bilateral(src, guide, bk, bss, bsc, "reflect101", "rint")
    d_btf = max_diff(got, _bilateral_math(src, guide, bk, bss, bsc, "reflect101", "rint"))
    if d_btf:
        raise SystemExit(f"BTF-shaped JBF parity FAILED: max |diff| {d_btf}")
    btaps, blut = kbf.device_tables(bk, bss, bsc, src.device)
    jbf_ms = cuda_time_ms(lambda: kbf.joint_bilateral(src, guide, btaps, blut, bk // 2,
                                                      "reflect101", "rint"), iters=50)
    jbf_plain_ms = cuda_time_ms(lambda: _bilateral_math(src, guide, bk, bss, bsc,
                                                        "reflect101", "rint"), iters=10)
    phase(f"BTF-shaped JBF {bh}x{bw} k={bk}: max |diff| {d_btf} (tolerance 0), "
          f"kernel {jbf_ms:.4f} ms (parent {PARENT_MS['JBF 600x900 k=17']} ms), plain "
          f"{jbf_plain_ms:.4f} ms")

    # 5b. the bilateral kernel's cells, with the parent's kernel in turns
    bilateral_kernel_phases(dev, parent)

    # 6. gradient grid: u8 and f32, 1 to 4 channels (1 and 3 at 4K), rows
    #    that are whole words and rows that are not, and a u8 image one byte
    #    off a word boundary; kernel vs plain on the card and vs plain on
    #    the CPU
    g_worst, g_cases = 0, 0
    grad_inputs = []
    for gh, gw in GRADIENT_SHAPES:
        n = gh * gw * 4
        grad_inputs += [(torch.from_numpy(random_array(n).reshape(gh, gw, 4)), GRADIENT_CHANNELS),
                        (torch.from_numpy(random_array(n, 255.0, np.float32).reshape(gh, gw, 4)),
                         GRADIENT_CHANNELS)]
    grad_inputs += [(torch.from_numpy(img_np), (1, 3)), (torch.from_numpy(img_np).float(), (1, 3))]
    for x, channels in grad_inputs:
        for c in channels:
            xc = x[:, :, :c].contiguous()
            got = kgr.gradient(xc.to(dev))
            d = max(max_abs(got, _gradient_math(xc.to(dev).float())),
                    max_abs(got.cpu(), _gradient_math(xc.float())))
            g_cases += 1
            if d:
                raise SystemExit(f"gradient parity FAILED: {tuple(xc.shape)} {xc.dtype}: "
                                 f"max |diff| {d}")
            g_worst = max(g_worst, d)
    odd = torch.from_numpy(random_array(37 * 64 * 3 + 1))
    x_odd = odd.to(dev)[1:].view(37, 64, 3)  # contiguous, one byte past a word boundary
    d = max(max_abs(kgr.gradient(x_odd), _gradient_math(x_odd.float())),
            max_abs(kgr.gradient(x_odd).cpu(), _gradient_math(odd[1:].view(37, 64, 3).float())))
    g_cases += 1
    if d:
        raise SystemExit(f"gradient parity FAILED on an unaligned u8 image: max |diff| {d}")
    phase(f"gradient grid: {g_cases} cases (u8/f32, C {GRADIENT_CHANNELS} on shapes "
          f"{GRADIENT_SHAPES}, C 1 and 3 at {MAIN_SHAPE}, an unaligned u8 (37, 64, 3)): "
          f"max |diff| {g_worst} (tolerance 0)")

    # 7. blur + mRTV and guide grid: kernel vs plain on the card (and blur +
    #    mRTV vs plain on the CPU); the guide is held to 0 on the card
    s_worst, guide_worst, guide_cpu, s_cases = 0, 0, 0, 0
    for sh, sw in STAGE_SHAPES:
        x = torch.from_numpy(random_image(sh, sw)).to(dev)
        mag = _gradient_math(x.float())
        for sk in STAGE_KSIZES:
            blurred, rtv = kbt.blur_and_rtv(x, mag, sk)
            bp, rp = obt._blur_and_rtv_math(x.float(), mag, sk)
            bc, rc = obt._blur_and_rtv_math(x.cpu().float(), mag.cpu(), sk)
            ds = max(max_abs(blurred, bp), max_abs(rtv, rp), max_abs(blurred.cpu(), bc),
                     max_abs(rtv.cpu(), rc))
            g = kbt.guide(blurred, rtv, sk)
            dg = max_diff(g, obt._guide_math(bp, rp, sk))
            guide_cpu = max(guide_cpu, max_diff(g.cpu(), obt._guide_math(bc, rc, sk)))
            s_cases += 1
            if ds or dg:
                raise SystemExit(f"BTF stage parity FAILED: {sh}x{sw} k={sk}: blur+mRTV "
                                 f"max |diff| {ds}, guide max |diff| {dg}")
            s_worst = max(s_worst, ds)
            guide_worst = max(guide_worst, dg)
    phase(f"blur+mRTV / guide grid: {s_cases} cases (k {STAGE_KSIZES}, shapes "
          f"{STAGE_SHAPES}): blurred and rtv max |diff| {s_worst} vs plain on the card and "
          f"the CPU (tolerance 0); guide "
          f"max |diff| {guide_worst} vs plain on the card (tolerance 0), {guide_cpu} vs "
          f"plain on the CPU (torch.exp on the CPU is another implementation)")

    # 7. (continued) the guide on ties: rtv planes of 4 levels with equal
    #    minima in different rows and columns of a window and whole flat
    #    windows, and a blurred image that differs by tap, so a wrong pick
    #    moves the output; kernel vs plain on the card
    tie_worst, tie_cases = 0, 0
    for th_, tw_ in TIE_SHAPES:
        blurred, rtv = (torch.from_numpy(a).to(dev) for a in tie_inputs(th_, tw_, th_ * tw_))
        for tk in TIE_KSIZES:
            d = max_diff(kbt.guide(blurred, rtv, tk), obt._guide_math(blurred, rtv, tk))
            tie_cases += 1
            if d:
                raise SystemExit(f"guide tie parity FAILED: {th_}x{tw_} k={tk}: max |diff| {d}")
            tie_worst = max(tie_worst, d)
    guide_worst = max(guide_worst, tie_worst)
    phase(f"guide tie grid: {tie_cases} cases (k {TIE_KSIZES}, shapes {TIE_SHAPES}): max "
          f"|diff| {tie_worst} vs plain on the card (tolerance 0)")

    # 8. the BTF path, counted: op (impl="auto", both variants), module, CLI
    counters = ((kgr, "launches"), (kbt, "blur_rtv_launches"), (kbt, "guide_launches"),
                (kbf, "launches"), (kab, "launches"), (kws, "launches"))
    counter_names = ("gradient, blur_rtv, guide, bilateral, adaptive_bilateral, "
                     "wexler_search")

    fill_counters = tuple((kfill, f"{name}_launches")
                          for name in ("ring_pick", "filters", "commit", "diffusion"))

    def reset() -> None:
        torch.cuda.synchronize()
        for mod, attr in counters + fill_counters:
            setattr(mod, attr, 0)

    def read() -> list[int]:
        torch.cuda.synchronize()
        return [getattr(mod, attr) for mod, attr in counters]

    def read_fill() -> list[int]:
        """The fill-loop kernels' launches: ring pick, filters, commit,
        diffusion start."""
        torch.cuda.synchronize()
        return [getattr(mod, attr) for mod, attr in fill_counters]

    path_launches = [0] * len(counters)
    btf_np = random_image(bh, bw)
    btf_in = torch.from_numpy(btf_np).to(dev)
    btf_module = vt.BilateralTextureFilter(bh, bw, BTF_KSIZE, BTF_NITR)
    btf_worst = 0
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.png")
        imwrite(in_path, btf_np)
        for variant in ("cuda", "cpp"):
            reset()
            out = vt.bilateral_texture_filter(btf_in, BTF_KSIZE, BTF_NITR, variant=variant)
            op_counts = read()
            plain = vt.bilateral_texture_filter(btf_in, BTF_KSIZE, BTF_NITR, impl="torch",
                                                variant=variant)
            module_counts, d_module = [0] * len(counters), 0
            if variant == "cuda":  # the module is the reference's CUDA pipeline
                reset()
                out_module = btf_module(btf_in)
                module_counts = read()
                d_module = max_diff(out_module, out)
            out_path = os.path.join(tmp, f"out_{variant}.png")
            reset()
            cli_btf.main([in_path, str(BTF_KSIZE), str(BTF_NITR), "-o", out_path,
                          "--device", "cuda", "--variant", variant])
            cli_counts = read()
            out_cli = torch.from_numpy(imread(out_path))
            d_plain, d_cli = max_diff(out, plain), max_diff(out.cpu(), out_cli)
            changed = float((out != btf_in).any(dim=2).float().mean().item())
            phase(f"BTF path {bh}x{bw} k={BTF_KSIZE} nitr={BTF_NITR} variant={variant}: "
                  f"launches ({counter_names}) op {op_counts}, module "
                  f"{module_counts}, CLI {cli_counts}; vs plain on the card max |diff| "
                  f"{d_plain}, module vs op {d_module}, CLI vs op {d_cli} (tolerance 0); "
                  f"share of pixels changed {changed:.4f} (must be > 0.5)")
            if (op_counts != [BTF_NITR] * 4 + [0, 0]
                    or (variant == "cuda" and module_counts != op_counts)):
                raise SystemExit("BTF path did not launch exactly 4*nitr kernels per call")
            if min(cli_counts[:4]) < 1:
                raise SystemExit("BTF CLI did not go through every kernel")
            if (out.shape != btf_in.shape or out.dtype != torch.uint8 or d_plain or d_module
                    or d_cli or changed < 0.5):
                raise SystemExit("BTF path output wrong")
            btf_worst = max(btf_worst, d_plain, d_module, d_cli)
            path_launches = [a + b + c + d for a, b, c, d in
                             zip(path_launches, op_counts, module_counts, cli_counts)]

    # 9. times: each kernel, its plain version and the whole filter, at
    #    600x900 and at 4K
    times = {}
    for label, x_np in (("600x900", btf_np), ("4K", img_np)):
        x = torch.from_numpy(x_np).to(dev)
        xh, xw = x.shape[:2]
        px = xh * xw
        mag = kgr.gradient(x)
        blurred, rtv = kbt.blur_and_rtv(x, mag, BTF_KSIZE)
        gd = kbt.guide(blurred, rtv, BTF_KSIZE)
        jt, jl = obt.jbf_tables(BTF_KSIZE, dev)
        xf = x.float()
        bp, rp = obt._blur_and_rtv_math(xf, mag, BTF_KSIZE)
        n_jbf = int(jt.shape[0])
        r = BTF_KSIZE
        rows = {
            "gradient": (lambda: kgr.gradient(x), lambda: _gradient_math(xf),
                         bound(px * 3 + px * 4, px * (3 * 6 + 1))),
            "blur_rtv": (lambda: kbt.blur_and_rtv(x, mag, BTF_KSIZE),
                         lambda: obt._blur_and_rtv_math(xf, mag, BTF_KSIZE),
                         # ordered window sum of G; separable max/min/box passes; per pixel
                         bound(px * 3 + px * 4 + px * 12 + px * 4, px * (r * r + 12 * r + 10))),
            "guide": (lambda: kbt.guide(blurred, rtv, BTF_KSIZE),
                      lambda: obt._guide_math(bp, rp, BTF_KSIZE),
                      # separable first-minimum argmin; alpha and blend per pixel
                      bound(px * 12 + px * 4 + px * 3, px * (4 * r + 20))),
            "bilateral": (lambda: kbf.joint_bilateral(x, gd, jt, jl, BTF_KSIZE - 1),
                          lambda: _bilateral_math(x, gd, 2 * BTF_KSIZE - 1, BTF_KSIZE - 1.0,
                                                  obt.JBF_SIGMA_COLOR),
                          bound(3 * px * 3, px * (8 * n_jbf + 6))),
        }
        for name, (kernel, plain_fn, (b_ms, b_by)) in rows.items():
            k_ms = queued_ms(kernel, 50 if label == "600x900" else 20)
            p_ms = cuda_time_ms(plain_fn, iters=3, warmup=1)
            times[(label, name)] = (k_ms, p_ms, b_ms, b_by)
            phase(f"{label} {name}: kernel {k_ms:.4f} ms (parent {PARENT_MS[(label, name)]} "
                  f"ms), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
        if parent is not None:
            parent_rows = {
                "gradient": (lambda: parent_gradient(x), rows["gradient"][0]),
                "guide": (lambda: parent_guide(blurred, rtv), rows["guide"][0]),
            }
            if not (torch.equal(parent_gradient(x), mag)
                    and torch.equal(parent_guide(blurred, rtv), gd)):
                raise SystemExit("the parent's kernels and this tree's differ")
            n_ab = 50 if label == "600x900" else 20
            for name, (old, new) in parent_rows.items():
                ab = [queued_ms(f, n_ab) for f in (old, new, new, old)]
                phase(f"{label} {name} A/B in turns (parent, change, change, parent): "
                      f"{', '.join(f'{t:.4f}' for t in ab)} ms; bound "
                      f"{times[(label, name)][2]:.4f} ms")
        op = lambda: vt.bilateral_texture_filter(x, BTF_KSIZE, BTF_NITR)  # noqa: E731
        dev_ms = queued_ms(op, 20 if label == "600x900" else 5)
        op_ms = cuda_time_ms(op, iters=10, warmup=2)
        t0 = time.perf_counter()
        btf_plain = vt.bilateral_texture_filter(x, BTF_KSIZE, BTF_NITR, impl="torch")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        del btf_plain
        kernel_sum = BTF_NITR * sum(times[(label, n)][0] for n in rows)
        phase(f"{label} BTF k={BTF_KSIZE} nitr={BTF_NITR}: op {op_ms:.4f} ms per call "
              f"({px / op_ms / 1e3:.1f} MP/s), device {dev_ms:.4f} ms back to back "
              f"({px / dev_ms / 1e3:.1f} MP/s), sum of its 12 kernels {kernel_sum:.4f} ms; "
              f"plain {plain_s * 1e3:.1f} ms (one call, host clock); parent "
              f"{PARENT_MS[('BTF', label)]}")
        if parent is not None:
            def parent_btf():
                """The BTF call with the parent's gradient and guide kernels."""
                y = x
                for _ in range(BTF_NITR):
                    b, r_ = kbt.blur_and_rtv(y, parent_gradient(y), BTF_KSIZE)
                    y = kbf.joint_bilateral(y, parent_guide(b, r_), jt, jl, BTF_KSIZE - 1)
                return y

            if not torch.equal(parent_btf(), op()):
                raise SystemExit("the BTF with the parent's kernels differs from this tree's")
            n_ab = 20 if label == "600x900" else 5
            ab = [queued_ms(f, n_ab) for f in (parent_btf, op, op, parent_btf)]
            phase(f"{label} BTF A/B, device back to back in turns (parent's gradient and guide, "
                  f"change, change, parent): {', '.join(f'{t:.4f}' for t in ab)} ms "
                  f"({', '.join(f'{px / t / 1e3:.1f}' for t in ab)} MP/s)")
        if label == "600x900":
            n_calls = 100
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_calls):
                op()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host_us = (t1 - t0) / n_calls * 1e6
            wall_ms = (t2 - t0) / n_calls * 1e3
            phase(f"600x900 BTF back to back, {n_calls} calls: host {host_us:.1f} us per call "
                  f"to enqueue 12 launches, wall {wall_ms:.4f} ms per call, device busy "
                  f"share {dev_ms / wall_ms:.3f}")

    # 10. the bilateral kernel where TPU kernel #3 (taps > 480) took over: 4K k=31 self
    k31_ms = queued_ms(lambda: kbf.bilateral(img, None, 31, 10.0, 30.0), 10)
    k31_plain_ms = cuda_time_ms(lambda: _bilateral_math(img, img, 31, 10.0, 30.0), iters=1,
                                warmup=1)
    k31_taps = int(kbf.device_tables(31, 10.0, 30.0, dev)[0].shape[0])
    k31_bound, k31_by = bound(2 * h * w * 3, h * w * (8 * k31_taps + 6))
    phase(f"4K k=31 bilateral ({k31_taps} taps): kernel {k31_ms:.4f} ms, plain "
          f"{k31_plain_ms:.4f} ms, bound {k31_bound:.4f} ms by {k31_by}")

    # 11. ABF parity grid: kernel vs plain on the card and vs plain on the CPU
    def abf_case(x_np, ak, ass, asc) -> tuple[int, int]:
        """(max |diff| of kernel vs plain on the card and on the CPU,
        all-zero output pixels)."""
        x = torch.from_numpy(x_np).to(dev)
        got = kab.adaptive_bilateral(x, ak, ass, asc)
        d = max(max_diff(got, _abf_math(x, ak, ass, asc)),
                max_diff(got.cpu(), _abf_math(x.cpu(), ak, ass, asc)))
        if d:
            raise SystemExit(f"ABF parity FAILED: {tuple(x.shape)} k={ak} sigma_s={ass} "
                             f"sigma_c={asc}: max |diff| {d}")
        return d, int((got == 0).all(dim=2).sum().item())

    abf_worst, abf_cases = 0, 0
    for ah, aw in ABF_SHAPES:
        x_np = random_image(ah, aw)
        for ak in ABF_KSIZES:
            abf_worst = max(abf_worst, abf_case(x_np, ak, 10.0, 30.0)[0])
            abf_cases += 1
    band_zero = under_zero = 0
    for ak, ass, asc, ah, aw in ABF_BAND_POINTS:
        d, zeros = abf_case(random_image(ah, aw), ak, ass, asc)
        abf_worst, band_zero, abf_cases = max(abf_worst, d), band_zero + zeros, abf_cases + 1
    for i, (ak, ass, asc, ah, aw) in enumerate(ABF_UNDERFLOW_POINTS):
        x_np = np.random.default_rng(777 + i).integers(0, 256, (ah, aw, 3), np.uint8)
        d, zeros = abf_case(x_np, ak, ass, asc)
        abf_worst, under_zero, abf_cases = max(abf_worst, d), under_zero + zeros, abf_cases + 1
    phase(f"ABF parity grid: {abf_cases} cases (k {ABF_KSIZES} at sigma (10, 30) on shapes "
          f"{ABF_SHAPES}, 4 subnormal-band and 4 underflow points): max |diff| {abf_worst} vs "
          f"plain on the card and on the CPU (tolerance 0); all-zero output pixels: band "
          f"points {band_zero}, underflow points {under_zero} (must be > 0)")
    if under_zero == 0:
        raise SystemExit("ABF underflow points gave no all-zero pixel: the sumk == 0 select "
                         "did not run")

    # 12. the ABF path, counted: op (impl="auto"), module, CLI, every counter
    #     reset just before and read just after
    abf_module = vt.AdaptiveBilateralFilter(h, w, k, ss, sc)
    with tempfile.TemporaryDirectory() as tmp:
        in_path, out_path = os.path.join(tmp, "in.png"), os.path.join(tmp, "out_abf.png")
        imwrite(in_path, img_np)
        reset()
        abf_out = vt.adaptive_bilateral_filter(img, k, ss, sc)
        abf_op_counts = read()
        reset()
        abf_out_module = abf_module(img)
        abf_module_counts = read()
        reset()
        cli_abf.main([in_path, "-o", out_path, "--device", "cuda"])
        abf_cli_counts = read()
        abf_out_cli = torch.from_numpy(imread(out_path))
    abf_launches = abf_op_counts[4] + abf_module_counts[4] + abf_cli_counts[4]
    phase(f"ABF path {h}x{w} k={k} sigma_s={ss} sigma_c={sc}: launches ({counter_names}) "
          f"op {abf_op_counts}, module "
          f"{abf_module_counts}, CLI {abf_cli_counts}")
    if (abf_op_counts != [0, 0, 0, 0, 1, 0] or abf_module_counts != [0, 0, 0, 0, 1, 0]
            or abf_cli_counts[:4] != [0, 0, 0, 0] or abf_cli_counts[4] < 1
            or abf_cli_counts[5] != 0):
        raise SystemExit("ABF path did not go through the kernel alone")
    if abf_out.shape != img.shape or abf_out.dtype != torch.uint8 or not abf_out.is_cuda:
        raise SystemExit(f"bad ABF output {tuple(abf_out.shape)} {abf_out.dtype} "
                         f"{abf_out.device}")
    abf_d_plain = max_diff(abf_out, _abf_math(img, k, ss, sc))
    abf_d_module = max_diff(abf_out_module, abf_out)
    abf_d_cli = max_diff(abf_out.cpu(), abf_out_cli)
    abf_changed = float((abf_out != img).any(dim=2).float().mean().item())
    phase(f"ABF path vs plain on the card max |diff| {abf_d_plain}, module vs op "
          f"{abf_d_module}, CLI vs op {abf_d_cli} (tolerance 0); share of pixels changed "
          f"{abf_changed:.4f} (must be > 0.5)")
    if abf_d_plain or abf_d_module or abf_d_cli or abf_changed < 0.5:
        raise SystemExit("ABF path output wrong")
    abf_worst = max(abf_worst, abf_d_plain, abf_d_module, abf_d_cli)

    # 13. ABF times: the kernel queued behind a sleep kernel, the op with CUDA
    #     events, the plain version; at 4K and 512x512
    abf_times = {}
    abf_n_taps = int(kab.device_tables(k, ss, sc, dev)[0].shape[0])
    for label, x_np in (("4K", img_np), ("512x512", random_image(*ABF_SMALL_SHAPE))):
        x = torch.from_numpy(x_np).to(dev)
        px = x.shape[0] * x.shape[1]
        k_ms = queued_ms(lambda: kab.adaptive_bilateral(x, k, ss, sc),
                         20 if label == "4K" else 100)
        o_ms = cuda_time_ms(lambda: vt.adaptive_bilateral_filter(x, k, ss, sc), iters=20)
        p_ms = cuda_time_ms(lambda: _abf_math(x, k, ss, sc), iters=3, warmup=1)
        # per tap: 3 (p-c), 3 (-o), 3 abs, 2 adds, ws*lut, 3 products, 4 sums;
        # per pixel: 6(k-1) separable box adds, 3 divisions and 3 subtractions
        # for the offset, 3 divisions, 3 adds, 3 floors and a compare to store
        b_ms, b_by = bound(2 * px * 3, px * (19 * abf_n_taps + 6 * k + 10))
        abf_times[label] = (k_ms, p_ms, b_ms, b_by)
        phase(f"{label} ABF k={k}: kernel {k_ms:.4f} ms ({px / k_ms / 1e3:.1f} MP/s; parent "
              f"{PARENT_MS[('ABF', label)]} ms), op "
              f"{o_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
              f"({abf_n_taps} taps)")

    regs = ptxas_summary(_build.ptxas_report())
    for part in ("adaptive_bilateral_kernel", "blur_rtv_kernelILi9ELb0E", "guide_kernelILi9E",
                 "gradient_words_kernelILi3E"):
        for name, (r, st, ld) in regs.items():
            if part in name:
                phase(f"redesigned kernel {name}: {r} registers, spill stores {st} B, spill "
                      f"loads {ld} B (ptxas)")

    # 14. Wexler search grid: kernel vs plain on the same CUDA tensors.  With
    #     image values 0..127 every partial sum of the masked SSD is an integer
    #     below 2^24, so the two are held bit-equal.  On full-range images the
    #     sums round in each order: |d energy| <= tol = max(4, 1e-6 S), S the
    #     f64 sum of the absolute terms at the plain pick, and the picks equal
    #     wherever the best f64 energy leads the second best by more than 2 tol
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's product stays f32

    def search_inputs(shape, t, initial, seed, max_value):
        """(p117, f13, valid): a random image with values 0..max_value, a 5x5
        hole plus a hole pixel at (9, 9) (which every window of a 20x20 image
        covers), and t random targets."""
        rng = np.random.default_rng(seed)
        sh, sw = shape
        x = torch.from_numpy(rng.integers(0, max_value + 1, (sh, sw, 3)).astype(np.float32))
        rem = torch.zeros((sh, sw))
        rem[sh // 3 : sh // 3 + 5, sw // 3 : sw // 3 + 5] = 1.0
        rem[min(9, sh - 1), min(9, sw - 1)] = 1.0
        ty, tx = torch.from_numpy(rng.integers(0, sh, t)), torch.from_numpy(rng.integers(0, sw, t))
        x, rem, ty, tx = (v.to(dev) for v in (x, rem, ty, tx))
        f13, valid, _ = wexler._search_filters(x, rem, ty, tx, sh, sw, initial)
        return wexler._build_p117(x, sw), f13, valid

    def im2col(p117, f13, valid, dtype):
        """The candidate matrix (ncand, 13*117) and the filters (13*117, T)."""
        n_cy, n_cx = valid.shape
        a = p117.to(dtype).unfold(0, f13.shape[0], 1).permute(0, 1, 3, 2)
        a = a.reshape(n_cy * n_cx, -1)
        return a, f13.to(dtype).reshape(a.shape[1], -1)

    s_cases = s_none = s_clear = s_picks = 0
    s_full_worst = 0.0
    for shape in SEARCH_SHAPES:
        for t in SEARCH_TARGETS:
            for initial in (False, True):
                for max_value in (127, 255):
                    p117, f13, valid = search_inputs(shape, t, initial, s_cases, max_value)
                    emin, idx = kws.search_min(p117, f13, valid)
                    emin_p, idx_p = _search_min_math(p117, f13, valid)
                    s_cases += 1
                    where = f"{shape} T={t} initial={initial} values 0..{max_value}"
                    if not valid.any():
                        s_none += 1
                        if not (torch.isinf(emin).all() and not idx.any()):
                            raise SystemExit(f"search grid FAILED at {where}: no valid "
                                             "candidate, and not (+inf, 0)")
                    if max_value == 127 or not valid.any():
                        if not (torch.equal(emin, emin_p) and torch.equal(idx, idx_p)):
                            raise SystemExit(f"search grid FAILED at {where}: not bit-equal")
                        continue
                    a, fm = im2col(p117, f13, valid, torch.float64)
                    tol = torch.clamp(1e-6 * (a[idx_p.long()] * fm.abs().t()).sum(1), min=4.0)
                    d = (emin.double() - emin_p.double()).abs()
                    two = torch.topk(torch.where(valid.reshape(-1, 1), a @ fm, torch.inf), 2,
                                     dim=0, largest=False).values
                    clear = (two[1] - two[0]) > 2 * tol
                    s_full_worst = max(s_full_worst, float(d.max()))
                    s_clear, s_picks = s_clear + int(clear.sum()), s_picks + t
                    if (d > tol).any() or not torch.equal(idx[clear], idx_p[clear]):
                        raise SystemExit(f"search grid FAILED at {where}: max |d energy| "
                                         f"{float(d.max())}, picks equal where clear: "
                                         f"{torch.equal(idx[clear], idx_p[clear])}")
                    del a, fm, two
    torch.cuda.synchronize()
    phase(f"Wexler search grid: {s_cases} cases (shapes {SEARCH_SHAPES}, T {SEARCH_TARGETS}, "
          f"initial and energy-pass masks, values 0..127 and 0..255): kernel vs plain on the "
          f"card bit-equal in energies and picks at values 0..127 (tolerance 0); at 0..255 "
          f"max |d energy| {s_full_worst} (tolerance max(4, 1e-6 S)), picks equal at each of "
          f"the {s_clear} targets (of {s_picks}) whose best energy leads by more than 2 tol; "
          f"{s_none} cases with no valid candidate gave (+inf, 0)")

    fill_k = fill_kernel_phases(dev, parent)

    # 15. the Wexler path, counted: configs 5a and 5c through op, module and
    #     CLI on a 402x700 periodic texture of values 0..127 (the true hole
    #     content exists elsewhere in the frame, and the search is exact)
    wh, ww = WEXLER_SHAPE
    wex_np = np.tile(random_image(37, 53) // 2, (-(-wh // 37), -(-ww // 53), 1))[:wh, :ww].copy()
    wex = torch.from_numpy(wex_np).to(dev)
    wex_masks = wexler_masks(wh, ww)
    wex_module = vt.WexlerInpainting()
    real_pass_core, pass_shapes = wexler._pass_core, []

    def counted_pass_core(img_f, rem_f, weight, height, width, initial, *args, **kwargs):
        pass_shapes.append((tuple(img_f.shape[:2]), initial))
        return real_pass_core(img_f, rem_f, weight, height, width, initial, *args, **kwargs)

    wex_launches = 0
    wex_fill_launches = [0] * len(fill_counters)
    wex_paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        in_path = os.path.join(tmp, "in.png")
        imwrite(in_path, wex_np)
        for cfg, mask_np in wex_masks.items():
            mask = torch.from_numpy(mask_np).to(dev)
            mask_path = os.path.join(tmp, f"mask_{cfg}.png")
            out_path = os.path.join(tmp, f"out_{cfg}.png")
            imwrite(mask_path, mask_np)
            reset()
            search_op.plain_searches = 0
            wexler.plain_pieces = 0
            wexler.host_syncs = 0
            pass_shapes.clear()
            wexler._pass_core = counted_pass_core
            try:
                out = vt.inpainting_wexler(wex, mask)
                op_counts, op_fill = read(), read_fill()
            finally:
                wexler._pass_core = real_pass_core
            syncs = wexler.host_syncs
            passes = Counter(shape for shape, _ in pass_shapes)
            onion_passes = sum(initial for _, initial in pass_shapes)
            reset()
            out_module = wex_module(wex, mask)
            module_counts, module_fill = read(), read_fill()
            reset()
            cli_wex.main([in_path, mask_path, "-o", out_path, "--device", "cuda"])
            cli_counts, cli_fill = read(), read_fill()
            plain_on_path = search_op.plain_searches + wexler.plain_pieces
            out_cli = torch.from_numpy(imread(out_path))
            out_plain = vt.inpainting_wexler(wex, mask, impl="torch")
            searches = op_counts[5]
            ring_picks, n_filters, commits, diffusions = op_fill
            per_iteration = (ring_picks + n_filters + searches + commits) / max(searches, 1)
            per_level = ", ".join(f"{lh}x{lw} {n}" for (lh, lw), n in
                                  sorted(passes.items(), reverse=True))
            keep = torch.from_numpy(mask_np == 0).to(dev)
            mse = float(((out.double() - wex.double())[~keep] ** 2).mean())
            psnr = f"{10 * math.log10(255.0 ** 2 / mse):.2f} dB" if mse else "inf (exact)"
            d_plain, d_module = max_diff(out, out_plain), max_diff(out_module, out)
            d_cli = max_diff(out.cpu(), out_cli)
            known_same = torch.equal(out[keep], wex[keep])
            wex_paths[cfg] = {"host_syncs": syncs, "iterations": searches,
                              "launches_an_iteration": per_iteration,
                              "ring_picks": ring_picks, "diffusion_starts": diffusions}
            phase(f"Wexler path {cfg} {wh}x{ww} ({int((mask_np > 0).sum())} hole pixels): "
                  f"launches ({counter_names}) op {op_counts}, module {module_counts}, CLI "
                  f"{cli_counts} (2 calls); fill kernels (ring pick, filters, commit, "
                  f"diffusion) op {op_fill}, module {module_fill}, CLI {cli_fill}; plain "
                  f"pieces and searches on the path {plain_on_path}; "
                  f"{len(passes)} pyramid levels, passes per level {per_level} "
                  f"({onion_passes} onion peel); {searches} iterations a call, kernel launches "
                  f"an iteration {per_iteration:.3f} (filters, search and commit once each, "
                  f"the ring pick once more at the end of each onion-peel pass); {syncs} host "
                  f"syncs a call (bound {WEXLER_MAX_SYNCS}); hole PSNR "
                  f"{psnr} against the true texture; vs the plain path on the card "
                  f"max |diff| {d_plain}, module vs op {d_module}, CLI vs op {d_cli} "
                  f"(tolerance 0); known pixels unchanged: {known_same}")
            if (op_counts[:5] != [0] * 5 or searches < 1 or module_counts != op_counts
                    or cli_counts[:5] != [0] * 5 or cli_counts[5] != 2 * searches
                    or module_fill != op_fill or cli_fill != [2 * c for c in op_fill]
                    or n_filters != searches or commits != searches
                    or ring_picks != searches + onion_passes or diffusions != 2
                    or plain_on_path != 0):
                raise SystemExit("Wexler path did not run every piece of the fill loop through "
                                 "its kernel")
            if syncs > WEXLER_MAX_SYNCS:
                raise SystemExit(f"Wexler path: {syncs} host syncs a call, above the bound "
                                 f"{WEXLER_MAX_SYNCS}")
            if (out.shape != wex.shape or out.dtype != torch.uint8 or not out.is_cuda
                    or d_plain or d_module or d_cli or not known_same):
                raise SystemExit("Wexler path output wrong")
            wex_launches += searches + module_counts[5] + cli_counts[5]
            wex_fill_launches = [a + b + c + d for a, b, c, d in
                                 zip(wex_fill_launches, op_fill, module_fill, cli_fill)]

    # 16. search times at 402x700 for the main path's target counts: the
    #     kernel alone on the wrapper's padded buffers and the wrapper (pads
    #     and decode included), queued behind a sleep kernel; the plain
    #     version; its bound (useful work: T, not the padded tile); and for
    #     context at T = 256 and 1024 the cuBLAS f32 and bf16 products of the
    #     im2col'd candidates by the filters alone, the (ncand, T) matrix the
    #     kernel never writes (the port calls neither)
    wex_times = {}
    for t in SEARCH_TIMED_TARGETS:
        p117, f13, valid = search_inputs(WEXLER_SHAPE, t, False, 7000 + t, 127)
        n_cy, n_cx = valid.shape
        p_pad, f_pad, valid_u8, keys, _ = kws.prepare(p117, f13, valid)
        k_ms = queued_ms(lambda: kws.launch(p_pad, f_pad, valid_u8, keys, n_cy), 20)
        w_ms = queued_ms(lambda: kws.search_min(p117, f13, valid), 20)
        p_ms = cuda_time_ms(lambda: _search_min_math(p117, f13, valid), iters=3, warmup=1)
        context = ""
        if t >= 256:
            gemm = {}
            for dtype in (torch.float32, torch.bfloat16):
                a, fm = im2col(p117, f13, valid, dtype)
                gemm[dtype] = cuda_time_ms(lambda: a @ fm, iters=5, warmup=1)
                del a, fm
            context = (f"; context: cuBLAS f32 product alone {gemm[torch.float32]:.4f} ms, "
                       f"bf16 {gemm[torch.bfloat16]:.4f} ms")
        ncand, depth = n_cy * n_cx, f13.shape[0] * f13.shape[1]
        flop = 2 * ncand * t * depth
        b_ms, b_by = bound(p117.numel() * 2 + f13.numel() * 2 + ncand + t * 8, flop,
                           BF16_TENSOR_OPS_PER_S)
        wex_times[t] = (k_ms, p_ms, b_ms, b_by)
        phase(f"{wh}x{ww} search T={t} (padded to {f_pad.shape[1]}): kernel {k_ms:.4f} ms "
              f"({flop / k_ms / 1e9:.1f} TFLOP/s useful bf16, {b_ms / k_ms:.3f} of the bound), "
              f"wrapper {w_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
              f"({flop:.4g} FLOP at {BF16_TENSOR_OPS_PER_S:.3g}/s){context}")

    # 17. whole inpaint, warm: wall time (host clock, synchronized, median of
    #     3) and, from one profiled call, the device-busy share and the search
    #     and fill kernels' shares of that wall time; then the loop body: two
    #     energy passes whose iteration counts differ launch the same number
    #     of other device kernels, so an iteration holds no torch op.  Every
    #     profile is a full_trace
    loop_kernels = ("wexler_ring_pick_kernel", "wexler_filters_kernel", "wexler_search_kernel",
                    "wexler_commit_kernel")

    retakes = [0]

    def full_trace(run, activities):
        """A profile of run() that recorded every launch. A trace, warm or
        cold, can miss a prefix of its events, so a spin kernel opens the
        trace, and the trace is taken again, 5 times at most, until it holds
        that kernel and as many loop kernels as the wrappers counted;
        retakes[0] counts the traces taken again."""
        for attempt in range(5):
            retakes[0] += attempt > 0
            reset()
            with torch.profiler.profile(activities=activities) as prof:
                torch.cuda._sleep(1 << 20)
                torch.cuda.synchronize()
                run()
            launched = sum(read_fill()[:3]) + read()[5]
            seen = Counter()
            for evt in prof.key_averages():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    seen["spin" if "spin_kernel" in evt.key
                         else any(name in evt.key for name in loop_kernels)] += evt.count
            if seen["spin"] == 1 and seen[True] >= launched:
                return prof
        raise SystemExit("the profiler dropped launches from 5 traces of a Wexler run")

    def device_us(prof) -> tuple[float, float, float]:
        total = search = fill = 0.0
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA or "spin_kernel" in evt.key:
                continue
            us = getattr(evt, "self_device_time_total", None)
            us = evt.self_cuda_time_total if us is None else us
            total += us
            if "wexler_search_kernel" in evt.key:
                search += us
            elif "wexler_" in evt.key:
                fill += us
        return total, search, fill

    wex_walls = {}
    for cfg, mask_np in wex_masks.items():
        mask = torch.from_numpy(mask_np).to(dev)
        walls, enqueues = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vt.inpainting_wexler(wex, mask)
            enqueues.append(time.perf_counter() - t0)  # the host's part: the call returned
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        prof = full_trace(lambda: (vt.inpainting_wexler(wex, mask), torch.cuda.synchronize()),
                          [torch.profiler.ProfilerActivity.CPU,
                           torch.profiler.ProfilerActivity.CUDA])
        n_search = read()[5]
        busy_us, search_us, fill_us = device_us(prof)
        wex_walls[cfg] = wall
        wex_paths[cfg].update(wall_s=wall, walls_s=walls, enqueue_s=enqueues,
                              device_ms=busy_us / 1e3,
                              busy=busy_us / 1e6 / wall if busy_us else None,
                              search_ms=search_us / 1e3, fill_kernels_ms=fill_us / 1e3)
        shares = ("not measured (the profiler recorded no device time)" if busy_us == 0 else
                  f"device busy {busy_us / 1e6 / wall:.3f} of the wall time, the search kernel "
                  f"{search_us / 1e6 / wall:.3f} ({search_us / 1e3:.3f} ms in {n_search} "
                  f"launches), the fill kernels {fill_us / 1e3:.3f} ms; all kernels "
                  f"{busy_us / 1e3:.3f} ms, under the profiler")
        phase(f"Wexler {cfg} whole inpaint {wh}x{ww}, warm: wall {wall:.4f} s (runs "
              f"{', '.join(f'{x:.4f}' for x in walls)} s; the call returned to the host after "
              f"{', '.join(f'{x:.4f}' for x in enqueues)} s); {shares}")
    hole_5a = wex_masks["5a"] > 0
    bbox_5a = vt.WexlerInpainting._hole_bbox(hole_5a)
    rem_5a = torch.from_numpy(hole_5a.astype(np.float32)).to(dev)
    weight_5a = torch.from_numpy(wexler.calculate_weight(hole_5a).astype(np.float32)).to(dev)
    body = {}
    for cap in (1024, 256):
        n_iter = -(-int(hole_5a.sum()) // cap)

        def energy_pass():
            wexler._pass_core(wex.float(), rem_5a, weight_5a, wh, ww, False, cap, *bbox_5a,
                              n_iter=n_iter)
            torch.cuda.synchronize()

        energy_pass()
        prof = full_trace(energy_pass, [torch.profiler.ProfilerActivity.CUDA])
        counts = Counter()
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in evt.key:
                counts[any(name in evt.key for name in loop_kernels)] += evt.count
        body[n_iter] = (counts[True], counts[False])
    (n_a, (ours_a, other_a)), (n_b, (ours_b, other_b)) = body.items()
    if ours_a == ours_b == 0:
        phase("Wexler loop body: not measured (the profiler recorded no device kernel)")
    else:
        phase(f"Wexler loop body (an energy pass at the 5a top level, {wh}x{ww}): "
              f"{n_a} iterations launch {ours_a} loop kernels and {other_a} other device "
              f"kernels and copies, {n_b} iterations {ours_b} and {other_b}: "
              f"{(other_b - other_a) / (n_b - n_a):g} torch ops an iteration; {retakes[0]} "
              f"incomplete traces of phase 17 taken again")
        if ours_a != 4 * n_a or ours_b != 4 * n_b or other_a != other_b:
            raise SystemExit("the Wexler loop body launches more than its 4 kernels")
    wex_paths["loop_body"] = {str(n): list(v) for n, v in body.items()}
    print(json.dumps({"wexler": wex_paths}), flush=True)

    # 18. past the one-tile limits: each kernel against its plain version at
    #     the first k whose halo tile does not fit one block and at 301 (the
    #     tiles go in bands), on a small image; sparse tap tables with taps
    #     on both sides of a band edge keep the plain versions cheap
    def band_taps(radius, rows):
        d = 2 * radius
        ys = sorted(y for y in {0, radius, d, rows - 1, rows, 2 * rows} if y <= d)
        pos = [(y, x) for y in ys for x in (0, radius, d)]
        table = np.zeros((len(pos), 4), np.int32)
        table[:, :2] = pos
        table[:, 2] = (0.125 + np.arange(len(pos)) / len(pos)).astype(np.float32).view(np.int32)
        return table

    from various_image_processings_tpu_torch.core.luts import color_table
    from various_image_processings_tpu_torch.ops.adaptive_bilateral import _abf_taps_math
    from various_image_processings_tpu_torch.ops.bilateral import _taps_math
    lx_np = random_image(*LARGE_SHAPE)
    lx, lg = torch.from_numpy(lx_np).to(dev), torch.from_numpy(lx_np[::-1].copy()).to(dev)
    large, large_worst = [], 0
    _, bf_lut = kbf.device_tables(3, 10.0, 30.0, dev)
    for joint, r in LARGE_BF_RADII:
        table = band_taps(r, lb.vip_bilateral_band(r, int(joint), 0))
        d = 0
        for border, rounding in GRID_MODES:
            got = kbf.joint_bilateral(lx, lg if joint else None, torch.from_numpy(table).to(dev),
                                      bf_lut, r, border, rounding)
            d = max(d, max_diff(got, _taps_math(lx, lg if joint else lx, table, bf_lut, r,
                                                border, rounding)))
        large_worst = max(large_worst, d)
        large.append(f"bilateral {'joint' if joint else 'self'} k={2 * r + 1} "
                     f"({lb.vip_bilateral_band(r, int(joint), 0)} tap rows a band) {d}")
    abf_lut = torch.from_numpy(color_table(sc, 1536)).to(dev)
    for r in LARGE_ABF_RADII:
        table = band_taps(r, lb.vip_adaptive_bilateral_band(r, 0))
        got = kab.adaptive_bilateral_taps(lx, torch.from_numpy(table).to(dev), abf_lut, r)
        d = max_diff(got, _abf_taps_math(lx, table, abf_lut, r))
        large_worst = max(large_worst, d)
        large.append(f"adaptive_bilateral k={2 * r + 1} "
                     f"({lb.vip_adaptive_bilateral_band(r, 0)} tap rows a band) {d}")
    lmag = _gradient_math(lx.float())
    for sk in LARGE_STAGE_KSIZES:
        blurred, rtv = kbt.blur_and_rtv(lx, lmag, sk)
        bp, rp = obt._blur_and_rtv_math(lx.float(), lmag, sk)
        ds = max(max_abs(blurred, bp), max_abs(rtv, rp))
        dg = max_diff(kbt.guide(blurred, rtv, sk), obt._guide_math(bp, rp, sk))
        large_worst = max(large_worst, ds, dg)
        large.append(f"blur_rtv k={sk} ({lb.vip_blur_rtv_band(sk // 2, 0)} tap rows a "
                     f"band) {ds}, guide k={sk} ({lb.vip_guide_band(sk // 2, 0)}) {dg}")
    bk_in = torch.from_numpy(random_image(20, 30)).to(dev)
    out_auto = vt.bilateral_texture_filter(bk_in, BTF_LARGE_KSIZE, 1)
    d_btf77 = max_diff(out_auto, vt.bilateral_texture_filter(bk_in, BTF_LARGE_KSIZE, 1,
                                                             impl="torch"))
    large_worst = max(large_worst, d_btf77)
    torch.cuda.synchronize()
    phase(f"past the one-tile limits, {LARGE_SHAPE[0]}x{LARGE_SHAPE[1]} image, kernel vs plain "
          f"max |diff| (tolerance 0): {'; '.join(large)}; BTF k={BTF_LARGE_KSIZE} nitr=1 "
          f"(JBF k'={2 * BTF_LARGE_KSIZE - 1}) impl=auto vs impl=torch {d_btf77}")
    if large_worst:
        raise SystemExit("a kernel differs from its plain version past its one-tile limit")

    # 19. full-range fills: the 5a hole in images with values 0..255, where
    #     the search's sums pass 2^24 and round in the kernel's order: a tile
    #     of random_image(37, 53) (the true content repeats elsewhere) and a
    #     smooth field (a bicubic upsampling of random_image(26, 44): no
    #     exact repeat, so near-ties decide).  The kernel path's hole PSNR
    #     against the true image must be no more than 2 dB below the plain
    #     path's (PARITY.md's window for the JAX fill against the reference)
    coarse = torch.from_numpy(random_image(26, 44)).to(dev).permute(2, 0, 1)[None].float()
    smooth = torch.nn.functional.interpolate(coarse, size=(wh, ww), mode="bicubic",
                                             align_corners=False)
    fills = {
        "tiled texture": torch.from_numpy(np.tile(random_image(37, 53), (
            -(-wh // 37), -(-ww // 53), 1))[:wh, :ww].copy()).to(dev),
        "smooth field": smooth.round().clamp(0, 255)[0].permute(1, 2, 0).to(torch.uint8)
                              .contiguous(),
    }
    mask_5a = torch.from_numpy(wex_masks["5a"]).to(dev)
    hole = mask_5a > 0
    for label, full in fills.items():
        reset()
        full_out = vt.inpainting_wexler(full, mask_5a)
        full_counts = read()
        full_plain = vt.inpainting_wexler(full, mask_5a, impl="torch")

        def hole_psnr(x) -> float:
            mse = float(((x.double() - full.double())[hole] ** 2).mean())
            return math.inf if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)

        psnr_k, psnr_p = hole_psnr(full_out), hole_psnr(full_plain)
        changed = int((full_out != full_plain).any(dim=2).sum().item())
        phase(f"full-range fill 5a {wh}x{ww}, {label} (values 0..255): {full_counts[5]} "
              f"searches through the kernel; hole PSNR kernel path {psnr_k:.2f} dB, plain path "
              f"{psnr_p:.2f} dB (must be >= plain - 2 dB); pixels that differ between the "
              f"paths {changed}; known pixels unchanged: "
              f"{torch.equal(full_out[~hole], full[~hole])}")
        if (full_counts[5] < 1 or psnr_k < psnr_p - 2.0
                or not torch.equal(full_out[~hole], full[~hole])):
            raise SystemExit("full-range fill outside the hole-PSNR window")

    slic_launches = slic_phases(dev, img_np)
    slic_launches.update(parallel_phases(dev)[1])  # the batched SLIC path's
    slic_k = slic_kernel_phases(dev)

    main_label = "600x900"
    entries = [{
        "name": "bilateral",
        "route": "cuda",
        "source": "various_image_processings_tpu_torch/csrc/bilateral.cu",
        "replaces": "various_image_processings_tpu/ops/pallas/bilateral.py:117",
        "launches": launches + path_launches[3],
        "max_abs_err": max(worst, btf_worst),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bf_bound,
        "bound_by": bf_bound_by,
        "library_ms": None,
        "at": f"{h}x{w} k={k} self",
    }]
    for i, (name, source, replaces, err) in enumerate((
            ("gradient", "gradient.cu", "gradient.py:20", g_worst),
            ("blur_rtv", "bilateral_texture.cu", "bilateral_texture.py:39", s_worst),
            ("guide", "bilateral_texture.cu", "bilateral_texture.py:137", guide_worst))):
        k_ms, p_ms, b_ms, b_by = times[(main_label, name)]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"various_image_processings_tpu_torch/csrc/{source}",
            "replaces": f"various_image_processings_tpu/ops/pallas/{replaces}",
            "launches": path_launches[i],
            "max_abs_err": max(err, btf_worst),
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "at": f"{bh}x{bw} k={BTF_KSIZE}",
        })
    k_ms, p_ms, b_ms, b_by = abf_times["4K"]
    entries.append({
        "name": "adaptive_bilateral",
        "route": "cuda",
        "source": "various_image_processings_tpu_torch/csrc/adaptive_bilateral.cu",
        "replaces": "various_image_processings_tpu/ops/pallas/adaptive_bilateral.py:74",
        "launches": abf_launches,
        "max_abs_err": abf_worst,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "at": f"{h}x{w} k={k}",
    })
    k_ms, p_ms, b_ms, b_by = wex_times[1024]
    entries.append({
        "name": "wexler_search",
        "route": "cuda",
        "source": "various_image_processings_tpu_torch/csrc/wexler_search.cu",
        "replaces": "various_image_processings_tpu/ops/pallas/wexler_search.py:63",
        "launches": wex_launches,
        "max_abs_err": s_full_worst,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "at": f"{wh}x{ww} T=1024",
    })
    fill_replaces = {
        "wexler_ring_pick": ":414 (_pass_core's while_loop: its cond :503-506 and the ring "
                            ":446-488) and :528 (_energy_loops_device's stop)",
        "wexler_filters": ":414 (_pass_core's body: the target side of _ring_targets_search "
                          ":265-340)",
        "wexler_commit": ":414 (_pass_core's body: the failure test, scatters, p117 update and "
                         "energy :491-501)",
        "wexler_diffusion": ":568 (_alt_init_device's fori_loop)",
    }
    for name, n in zip(FILL_KERNELS, wex_fill_launches):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "various_image_processings_tpu_torch/csrc/wexler_fill.cu",
            "replaces": "various_image_processings_tpu/models/inpainting.py"
                        + fill_replaces[name] + "; XLA, no Pallas kernel",
            "launches": n,
            **{key: fill_k[name][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by")},
            "library_ms": None,
            "at": fill_k[name]["at"],
            **({"other_shapes": fill_k[name]["other_shapes"]}
               if fill_k[name].get("other_shapes") else {}),
        })
    s_size, iters, m = SLIC_PARAMS
    # the euclidean instantiations, the update kernel (every metric's), then
    # the association and snap keys of each ΔE metric
    slic_entries = [("association", "euclidean"), ("snap_keys", "euclidean"), ("update", None)]
    slic_entries += [(name, metric) for metric in DELTA_E_METRICS
                     for name in ("association", "snap_keys")]
    for name, metric in slic_entries:
        cell = slic_k["512x512" if metric in (None, "euclidean") else f"512x512 {metric}"]
        b_ms, b_by = cell["bound"][name]
        delta_e = metric not in (None, "euclidean")
        entries.append({
            "name": f"slic_{name}" + (f"_{metric}" if delta_e else ""),
            "route": "cuda",
            "source": "various_image_processings_tpu_torch/csrc/slic_kmeans.cu",
            "replaces": "various_image_processings_tpu/models/slic.py:129 (XLA while_loop, "
                        "no Pallas kernel)",
            "launches": slic_launches[name, metric] if metric else slic_launches[name],
            "max_abs_err": max(v for (k, mt), v in slic_k["worst"].items()
                               if k == name and (metric is None or mt == metric)),
            "ms": cell["kernel_ms"][name],
            "plain_ms": cell["plain_ms"][name],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "at": f"{SLIC_SHAPE[0]}x{SLIC_SHAPE[1]} smooth S={s_size} m={m:g}"
                  + (f" {metric}" if delta_e else "") + ", an iteration",
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
