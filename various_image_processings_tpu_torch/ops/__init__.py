"""Public ops.  Each filter takes ``impl="auto" | "torch" | "cuda"``; ``"auto"``
runs the CUDA kernel on a CUDA tensor and the plain PyTorch version on a
CPU tensor.  The integral image is plain PyTorch on every device."""

from .adaptive_bilateral import adaptive_bilateral_filter
from .bilateral import bilateral_filter, joint_bilateral_filter
from .bilateral_texture import bilateral_texture_filter
from .gradient import gradient
from .integral_image import integral_image, window_sums

__all__ = ["adaptive_bilateral_filter", "bilateral_filter", "bilateral_texture_filter",
           "gradient", "integral_image", "joint_bilateral_filter", "window_sums"]
