"""CLI twin of sample/adaptive_bilateral_filter/main.cpp:
``filename [ksize] [sigma_space] [sigma_color]``."""

from __future__ import annotations

import sys

from ._common import base_parser, device_of, load_image, run_and_save


def main(argv=None):
    p = base_parser("Adaptive bilateral filter (Zhang–Allebach)")
    p.add_argument("ksize", nargs="?", type=int, default=9)
    p.add_argument("sigma_space", nargs="?", type=float, default=10.0)
    p.add_argument("sigma_color", nargs="?", type=float, default=30.0)
    args = p.parse_args(argv)

    from ..ops.adaptive_bilateral import adaptive_bilateral_filter
    device = device_of(args)
    img = load_image(args.filename, device)
    run_and_save("adaptive_bilateral_filter",
                 lambda: adaptive_bilateral_filter(img, args.ksize, args.sigma_space,
                                                   args.sigma_color, impl=args.impl),
                 args, "abf", device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
