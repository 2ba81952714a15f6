"""CLI twin of sample/bilateral_texture_filter/main.cpp:
``filename [ksize] [nitr]``."""

from __future__ import annotations

import sys

from ._common import base_parser, device_of, load_image, run_and_save


def main(argv=None):
    p = base_parser("Bilateral texture filter (Cho et al. 2014)")
    p.add_argument("ksize", nargs="?", type=int, default=9)
    p.add_argument("nitr", nargs="?", type=int, default=3)
    p.add_argument("--variant", choices=("cuda", "cpp"), default="cuda",
                   help="reference pipeline to match: 'cuda' (in-repo JBF) "
                        "or 'cpp' (cv::ximgproc::jointBilateralFilter final "
                        "stage)")
    args = p.parse_args(argv)

    from ..ops.bilateral_texture import bilateral_texture_filter
    device = device_of(args)
    img = load_image(args.filename, device)
    run_and_save("bilateral_texture_filter",
                 lambda: bilateral_texture_filter(img, args.ksize, args.nitr, impl=args.impl,
                                                  variant=args.variant),
                 args, "btf", device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
