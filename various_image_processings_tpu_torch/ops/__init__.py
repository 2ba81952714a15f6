"""Public ops.  Each takes ``impl="auto" | "torch" | "cuda"``; ``"auto"``
runs the CUDA kernel on a CUDA tensor and the plain PyTorch version on a
CPU tensor."""

from .bilateral import bilateral_filter, joint_bilateral_filter
from .bilateral_texture import bilateral_texture_filter
from .gradient import gradient

__all__ = ["bilateral_filter", "bilateral_texture_filter", "gradient",
           "joint_bilateral_filter"]
