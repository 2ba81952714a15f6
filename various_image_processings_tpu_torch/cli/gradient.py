"""CLI twin of sample/gradient/main.cpp: ``filename``.  The f32 magnitude is
rescaled to u8 by the image max for viewing, like the sample's convert_to_u8
(sample/gradient/main.cpp:9-18)."""

from __future__ import annotations

import sys

import torch

from ._common import base_parser, device_of, load_image, run_and_save


def main(argv=None):
    p = base_parser("Sobel-style gradient magnitude")
    args = p.parse_args(argv)

    from ..ops.gradient import gradient
    device = device_of(args)
    img = load_image(args.filename, device)

    def run():
        g = gradient(img, impl=args.impl)
        return (g * 255.0 / g.max().clamp_min(1e-9)).to(torch.uint8)

    run_and_save("gradient", run, args, "gradient", device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
