"""various_image_processings_tpu_torch — the PyTorch / CUDA port of
various_image_processings_tpu, for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; each kernel the JAX package wrote in Pallas for
the TPU is a CUDA C++ kernel written for sm_90a (``csrc/``), built with nvcc
at first use.  The package imports neither jax nor the JAX package, which
stays the reference the port is tested against.

Ported so far: the bilateral and joint bilateral filters.
"""

__version__ = "0.1.0"

from . import core as core
from . import models as models
from . import ops as ops
from .models import BilateralFilter as BilateralFilter
from .ops import (
    bilateral_filter as bilateral_filter,
    joint_bilateral_filter as joint_bilateral_filter,
)
