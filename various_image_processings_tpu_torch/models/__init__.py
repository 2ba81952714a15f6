"""Class-style API: shape-specialized filters as ``nn.Module``s."""

from .filters import BilateralFilter, BilateralTextureFilter

__all__ = ["BilateralFilter", "BilateralTextureFilter"]
