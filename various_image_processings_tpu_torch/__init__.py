"""various_image_processings_tpu_torch — the PyTorch / CUDA port of
various_image_processings_tpu, for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; each kernel the JAX package wrote in Pallas for
the TPU is a CUDA C++ kernel written for sm_90a (``csrc/``), built with nvcc
at first use.  The package imports neither jax nor the JAX package, which
stays the reference the port is tested against.

Ported: the bilateral and joint bilateral filters, the gradient
magnitude, the bilateral texture filter, the border-replicated integral
image, the adaptive bilateral filter, the Gaussian pyramid, Wexler
exemplar-based inpainting, SLIC superpixels (exact OpenCV Lab, CIEDE2000,
the k-means as plain PyTorch on the device, the connectivity pass in native
C++ on the host), the class API's ``DeviceImage`` and ``warmup()``, the
parallel layer (``parallel/``: a mesh of devices, batch fan-out, row-sharded
stencils with halo exchange, batched SLIC and Wexler), the timing utilities
(``utils/profiling.py``) and the benchmark CLI (``vip-torch-benchmark``).
That is every module of the JAX package but ``golden/``, the tests' oracle.
"""

__version__ = "0.1.0"

from . import core as core
from .core import DeviceImage as DeviceImage
from . import models as models
from . import ops as ops
from . import parallel as parallel
from . import utils as utils
from .models import AdaptiveBilateralFilter as AdaptiveBilateralFilter
from .models import BilateralFilter as BilateralFilter
from .models import BilateralTextureFilter as BilateralTextureFilter
from .models import SuperpixelSLIC as SuperpixelSLIC
from .models import WexlerInpainting as WexlerInpainting
from .ops import (
    adaptive_bilateral_filter as adaptive_bilateral_filter,
    bilateral_filter as bilateral_filter,
    bilateral_texture_filter as bilateral_texture_filter,
    gradient as gradient,
    inpainting_wexler as inpainting_wexler,
    integral_image as integral_image,
    joint_bilateral_filter as joint_bilateral_filter,
    superpixel_slic as superpixel_slic,
    window_sums as window_sums,
)
