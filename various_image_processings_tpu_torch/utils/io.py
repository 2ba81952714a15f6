"""Image I/O via OpenCV: BGR u8, like the reference's cv::imread-based
samples."""

from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return np.asarray(img)


def imread_gray(path: str) -> np.ndarray:
    """(H, W) u8, e.g. an inpainting mask."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return np.asarray(img)


def imwrite(path: str, img: np.ndarray) -> None:
    import cv2

    if not cv2.imwrite(path, np.asarray(img)):
        raise OSError(f"could not write {path}")
