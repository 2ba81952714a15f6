"""Public ops.  Each filter takes ``impl="auto" | "torch" | "cuda"``; ``"auto"``
runs the CUDA kernel on a CUDA tensor and the plain PyTorch version on a
CPU tensor.  The integral image is plain PyTorch on every device;
``inpainting_wexler`` takes ``impl`` for its exemplar search.
``superpixel_slic`` has no kernel and no ``impl``: plain PyTorch k-means on
the device, native C++ connectivity on the host."""

from .adaptive_bilateral import adaptive_bilateral_filter
from .bilateral import bilateral_filter, joint_bilateral_filter
from .bilateral_texture import bilateral_texture_filter
from .gradient import gradient
from .inpainting import inpainting_wexler
from .integral_image import integral_image, window_sums
from .slic import superpixel_slic

__all__ = ["adaptive_bilateral_filter", "bilateral_filter", "bilateral_texture_filter",
           "gradient", "inpainting_wexler", "integral_image", "joint_bilateral_filter",
           "superpixel_slic", "window_sums"]
