"""Shared CLI plumbing for the per-algorithm samples.

The reference samples display results with cv::imshow; these headless twins
write PNGs next to the input (or to --output) and print timing.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..ops._dispatch import VALID_IMPLS
from ..utils.io import imread, imwrite


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("filename", help="input image path")
    p.add_argument("--output", "-o", default=None,
                   help="output path (default: <input>_<algo>.png)")
    p.add_argument("--impl", default="auto", choices=VALID_IMPLS)
    p.add_argument("--device", default="cuda",
                   help="torch device the image is filtered on (default: cuda)")
    p.add_argument("--side-by-side", action="store_true",
                   help="also write an input|result composite PNG — the "
                        "headless twin of the reference samples' paired "
                        "cv::imshow windows")
    return p


def device_of(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device} needs a CUDA GPU and none is "
                           "available; pass --device cpu")
    return device


def load_image(path: str, device: torch.device) -> torch.Tensor:
    img = imread(path)
    print(f"input: {path} {img.shape[1]}x{img.shape[0]}")
    return torch.from_numpy(img).to(device)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_and_save(name: str, fn, args, out_default_suffix: str,
                 device: torch.device) -> np.ndarray:
    t0 = time.perf_counter()
    fn()
    _synchronize(device)
    t1 = time.perf_counter()
    out = fn()
    _synchronize(device)
    t2 = time.perf_counter()
    print(f"{name}: first call {t1 - t0:.3f}s, warm {1e3 * (t2 - t1):.3f}ms")
    out = out.cpu().numpy()
    out_path = args.output
    if out_path is None:
        root, _ = os.path.splitext(args.filename)
        out_path = f"{os.path.basename(root)}_{out_default_suffix}.png"
    imwrite(out_path, out)
    print(f"wrote {out_path}")
    if args.side_by_side:
        src = imread(args.filename)
        sep = np.full((src.shape[0], 2, 3), 255, np.uint8)
        root, _ = os.path.splitext(out_path)
        sbs_path = f"{root}_sbs.png"
        imwrite(sbs_path, np.concatenate([src, sep, out], axis=1))
        print(f"wrote {sbs_path} (input | result)")
    return out
