"""Class-style API: shape-specialized filters as ``nn.Module``s."""

from .filters import AdaptiveBilateralFilter, BilateralFilter, BilateralTextureFilter

__all__ = ["AdaptiveBilateralFilter", "BilateralFilter", "BilateralTextureFilter"]
