"""Public ops.  Each takes ``impl="auto" | "torch" | "cuda"``; ``"auto"``
runs the CUDA kernel on a CUDA tensor and the plain PyTorch version on a
CPU tensor."""

from .bilateral import bilateral_filter, joint_bilateral_filter

__all__ = ["bilateral_filter", "joint_bilateral_filter"]
