"""CLI twin of sample/bilateral_filter/main.cpp:
``filename [ksize] [sigma_space] [sigma_color]``."""

from __future__ import annotations

import sys

from ._common import base_parser, device_of, load_image, run_and_save


def main(argv=None):
    p = base_parser("Bilateral filter (edge-preserving smoothing)")
    p.add_argument("ksize", nargs="?", type=int, default=9)
    p.add_argument("sigma_space", nargs="?", type=float, default=10.0)
    p.add_argument("sigma_color", nargs="?", type=float, default=30.0)
    p.add_argument("--compare", action="store_true",
                   help="print max abs diff vs cv2.bilateralFilter (the "
                        "reference sample does the same, "
                        "sample/bilateral_filter/main.cpp:29)")
    args = p.parse_args(argv)

    from ..ops.bilateral import bilateral_filter
    device = device_of(args)
    img = load_image(args.filename, device)
    out = run_and_save("bilateral_filter",
                       lambda: bilateral_filter(img, args.ksize, args.sigma_space,
                                                args.sigma_color, impl=args.impl),
                       args, "bf", device)
    if args.compare:
        import cv2
        import numpy as np
        src = img.cpu().numpy()
        oracle = cv2.bilateralFilter(src, args.ksize, args.sigma_color,
                                     args.sigma_space,
                                     borderType=cv2.BORDER_REPLICATE)
        diff = np.abs(out.astype(int) - oracle.astype(int)).max()
        print(f"max abs diff vs cv2.bilateralFilter: {diff}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
