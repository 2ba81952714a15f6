"""Benchmark harness — twin of the JAX package's ``vip-benchmark`` and of the
reference's sample/benchmark/main.cpp (:203-243), with the same TOML schema
(config.toml: global execute_times + per-filter sections) and the same
default workload (100×100 random u8 BGR in [100, 120)).  Where the reference
times cpp vs cuda and the JAX package xla vs pallas, this times the plain
PyTorch version (``torch``) and the hand-written kernels (``cuda``); with
``--device cpu`` it times ``torch`` alone, since a kernel needs a CUDA
tensor.  Adds MP/s and ``--size`` for production-scale runs."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..core.rng import MT19937
from ..utils.profiling import fence, measure
from ._common import device_of

DEFAULTS = {
    "execute_times": 50,
    "BilateralFilter": {"ksize": 9},
    "AdaptiveBilateralFilter": {"ksize": 9},
    "BilateralTextureFilter": {"ksize": 9, "nitr": 3},
    "SuperpixelSLIC": {"superpixel_size": 10, "num_iteration": 10},
}


def parse_config(path: str | None):
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in DEFAULTS.items()}
    if path:
        import tomllib
        with open(path, "rb") as f:
            loaded = tomllib.load(f)
        if "execute_times" in loaded:
            cfg["execute_times"] = loaded["execute_times"]
        for section in ("BilateralFilter", "AdaptiveBilateralFilter",
                        "BilateralTextureFilter", "SuperpixelSLIC"):
            cfg[section].update(loaded.get(section, {}))
    return cfg


def print_duration(name: str, msec: float, mps: float | None = None):
    extra = f"  ({mps:8.1f} MP/s)" if mps is not None else ""
    print(f"{name:<40} : {msec:10.6f} [msec]{extra}")


def main(argv=None):
    p = argparse.ArgumentParser(description="various_image_processings_tpu_torch benchmark")
    p.add_argument("config", nargs="?", default=None, help="TOML config path")
    p.add_argument("--size", type=int, nargs=2, default=(100, 100),
                   metavar=("H", "W"), help="image size (default 100 100)")
    p.add_argument("--device", default="cuda",
                   help="torch device the image is filtered on (default: cuda)")
    args = p.parse_args(argv)
    cfg = parse_config(args.config)
    n = cfg["execute_times"]
    h, w = args.size
    device = device_of(args)

    # random u8 BGR in [100, 120) (sample/benchmark/main.cpp:210-213)
    raw = MT19937(42).raw(h * w * 3)
    img = (100 + raw % np.uint32(20)).astype(np.uint8).reshape(h, w, 3)
    img_dev = torch.from_numpy(img).to(device)
    pixels = h * w
    impls = ("torch", "cuda") if device.type == "cuda" else ("torch",)

    print(f"image size        : {w}x{h}")
    print(f"execute times     : {n}")
    for section, params in cfg.items():
        if isinstance(params, dict):
            print(f"[{section}] {params}")
    if device.type != "cuda":
        print(f"device {device}: timing impl=torch only (the kernels need a CUDA tensor)")
    print()

    from ..ops.adaptive_bilateral import adaptive_bilateral_filter
    from ..ops.bilateral import bilateral_filter
    from ..ops.bilateral_texture import bilateral_texture_filter
    from ..ops.gradient import gradient
    from ..ops.slic import superpixel_slic

    for impl in impls:
        ms = measure(lambda: gradient(img_dev, impl=impl), n)
        print_duration(f"gradient ({impl})", ms, pixels / ms / 1e3)

    k = cfg["BilateralFilter"]["ksize"]
    for impl in impls:
        ms = measure(lambda: bilateral_filter(img_dev, k, impl=impl), n)
        print_duration(f"bilateral_filter k={k} ({impl})", ms, pixels / ms / 1e3)

    k = cfg["AdaptiveBilateralFilter"]["ksize"]
    for impl in impls:
        ms = measure(lambda: adaptive_bilateral_filter(img_dev, k, impl=impl), n)
        print_duration(f"adaptive_bilateral_filter k={k} ({impl})", ms,
                       pixels / ms / 1e3)

    k = cfg["BilateralTextureFilter"]["ksize"]
    nitr = cfg["BilateralTextureFilter"]["nitr"]
    for impl in impls:
        ms = measure(lambda: bilateral_texture_filter(img_dev, k, nitr, impl=impl),
                     max(n // 5, 2))
        print_duration(f"bilateral_texture_filter k={k} nitr={nitr} ({impl})",
                       ms, pixels / ms / 1e3)

    s = cfg["SuperpixelSLIC"]["superpixel_size"]
    it = cfg["SuperpixelSLIC"]["num_iteration"]
    fence(superpixel_slic(img_dev, s, it))  # warm-up
    t0 = time.perf_counter()
    iters = max(n // 5, 2)
    for _ in range(iters):
        fence(superpixel_slic(img_dev, s, it))
    ms = (time.perf_counter() - t0) / iters * 1e3
    print_duration(f"superpixel_slic S={s} itr={it}", ms, pixels / ms / 1e3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
