"""CLI twin of sample/wexler_inpainting/main.cpp: ``image mask`` → writes
result.png (or --output)."""

from __future__ import annotations

import sys

import torch

from ..utils.io import imread_gray
from ._common import base_parser, device_of, load_image, run_and_save


def main(argv=None):
    p = base_parser("Wexler exemplar-based inpainting")
    p.add_argument("mask", help="mask image (hole where > 0)")
    args = p.parse_args(argv)
    if args.output is None:
        args.output = "result.png"

    from ..ops.inpainting import inpainting_wexler
    device = device_of(args)
    img = load_image(args.filename, device)
    mask = torch.from_numpy(imread_gray(args.mask)).to(device)
    run_and_save("inpainting_wexler",
                 lambda: inpainting_wexler(img, mask, impl=args.impl, verbose=True),
                 args, "wexler", device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
