"""Class-style API: shape-specialized filters and Wexler inpainting as
``nn.Module``s."""

from .filters import AdaptiveBilateralFilter, BilateralFilter, BilateralTextureFilter
from .inpainting import WexlerInpainting

__all__ = ["AdaptiveBilateralFilter", "BilateralFilter", "BilateralTextureFilter",
           "WexlerInpainting"]
