"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``various_image_processings_tpu_torch/csrc``
with nvcc, holds it against its plain PyTorch version over a parity grid,
drives the main path (the 4K k=9 bilateral filter, through the op, the
``BilateralFilter`` module and the CLI) with the launch counter reset just
before, and times kernel and plain version with CUDA events.  Every phase
prints a line; any failure exits non-zero.  On success the line before the
last is ``{"kernels": [...]}`` and the last is
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits 1.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

MAIN_SHAPE = (2160, 3840)                 # 4K, u8 BGR
MAIN_PARAMS = (9, 10.0, 30.0)             # ksize, sigma_space, sigma_color
BTF_SHAPE = (600, 900)
BTF_PARAMS = (17, 8.0, math.sqrt(3.0))    # the JBF stage of a k=9 BTF iteration
GRID_KSIZES = (1, 3, 5, 9, 13, 17, 25, 27, 31)
GRID_SHAPES = ((50, 50), (37, 61), (8, 5), (1, 1))
GRID_MODES = (("replicate", "trunc"), ("reflect101", "rint"))


def max_diff(a, b) -> int:
    return int((a.int() - b.to(a.device).int()).abs().max().item())


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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

    import numpy as np

    import various_image_processings_tpu_torch as vt
    from various_image_processings_tpu_torch.cli import bilateral_filter as cli_bf
    from various_image_processings_tpu_torch.core.rng import random_image
    from various_image_processings_tpu_torch.ops.bilateral import _bilateral_math
    from various_image_processings_tpu_torch.ops.cuda import _build
    from various_image_processings_tpu_torch.ops.cuda import bilateral as kbf
    from various_image_processings_tpu_torch.utils.io import imread, imwrite
    from various_image_processings_tpu_torch.utils.profiling import cuda_time_ms

    # 1. build
    t0 = time.perf_counter()
    kbf._lib()
    phase(f"built {_build.library_path().name} from {len(_build.sources())} source(s) "
          f"in {time.perf_counter() - t0:.2f} s")

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
    phase(f"4K k=9 bilateral: kernel {ms:.4f} ms ({mp / ms * 1e3:.1f} MP/s), "
          f"op {op_ms:.4f} ms ({mp / op_ms * 1e3:.1f} MP/s), "
          f"plain {plain_ms:.4f} ms ({mp / plain_ms * 1e3:.1f} MP/s)")

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
          f"kernel {jbf_ms:.4f} ms, plain {jbf_plain_ms:.4f} ms")

    print(json.dumps({"kernels": [{
        "name": "bilateral",
        "route": "cuda",
        "source": "various_image_processings_tpu_torch/csrc/bilateral.cu",
        "replaces": "various_image_processings_tpu/ops/pallas/bilateral.py:117",
        "launches": launches,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
