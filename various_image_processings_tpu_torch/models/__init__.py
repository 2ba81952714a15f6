"""Class-style API: shape-specialized filters as ``nn.Module``s."""

from .filters import BilateralFilter

__all__ = ["BilateralFilter"]
