"""CLI twin of sample/slic/main.cpp: ``filename [superpixel_size [iterations
[color_scale]]]`` (defaults S=30, 10 iterations, m=20).  Writes the
mean-color superpixel rendering and the red-contour overlay, like the
sample's draw_superpixel / draw_contour (sample/slic/main.cpp:8-66).
The k-means runs on ``--device``: on the GPU, on the hand-written kernels
(``ops/slic.py``'s route)."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..utils.io import imread, imwrite
from ._common import device_of


def draw_contour(labels: np.ndarray) -> np.ndarray:
    """255 where the label differs from the right/down neighbour."""
    edge = np.zeros(labels.shape, np.uint8)
    edge[:, :-1] |= (labels[:, :-1] != labels[:, 1:]).astype(np.uint8) * 255
    edge[:-1, :] |= (labels[:-1, :] != labels[1:, :]).astype(np.uint8) * 255
    edge[:, -1] = 255  # right/bottom borders compare against label -1
    edge[-1, :] = 255
    return edge


def draw_superpixel(image: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Mean color per superpixel."""
    n = labels.max() + 1
    flat = labels.reshape(-1)
    out = np.zeros((n, 3), np.float64)
    counts = np.bincount(flat, minlength=n).astype(np.float64)
    for c in range(3):
        out[:, c] = np.bincount(flat, weights=image[:, :, c].reshape(-1), minlength=n)
    colors = (out / np.maximum(counts, 1)[:, None]).astype(np.uint8)
    return colors[labels]


def main(argv=None):
    p = argparse.ArgumentParser(description="SLIC superpixels")
    p.add_argument("filename", help="input image path")
    p.add_argument("superpixel_size", nargs="?", type=int, default=30)
    p.add_argument("iterations", nargs="?", type=int, default=10)
    p.add_argument("color_scale", nargs="?", type=float, default=20.0)
    p.add_argument("--output", "-o", default=None,
                   help="mean-color output path (default: <input>_slic_mean.png)")
    p.add_argument("--device", default="cuda",
                   help="torch device the k-means runs on (default: cuda)")
    args = p.parse_args(argv)

    from ..ops.slic import superpixel_slic
    device = device_of(args)
    img = imread(args.filename)
    labels = superpixel_slic(img, args.superpixel_size, args.iterations, args.color_scale,
                             device=device).cpu().numpy()
    print(f"superpixels: {labels.max() + 1}")

    root = os.path.basename(os.path.splitext(args.filename)[0])
    imwrite(args.output or f"{root}_slic_mean.png", draw_superpixel(img, labels))
    overlay = img.copy()
    overlay[draw_contour(labels) > 0] = (0, 0, 255)
    imwrite(f"{root}_slic_contour.png", overlay)
    print(f"wrote {args.output or f'{root}_slic_mean.png'}, {root}_slic_contour.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
