"""Class-style API: shape-specialized filters and Wexler inpainting as
``nn.Module``s, and SLIC superpixels."""

from .filters import AdaptiveBilateralFilter, BilateralFilter, BilateralTextureFilter
from .inpainting import WexlerInpainting
from .slic import SuperpixelSLIC

__all__ = ["AdaptiveBilateralFilter", "BilateralFilter", "BilateralTextureFilter",
           "SuperpixelSLIC", "WexlerInpainting"]
