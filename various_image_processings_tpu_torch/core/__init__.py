"""Building blocks: LUTs, the MT19937 test-image twin, padding, Lab
conversion, CIEDE2000 and the DeviceImage container."""

from .ciede2000 import ciede2000_ref_square, ciede2000_square
from .colors import bgr2lab_u8, bgr2lab_u8_exact
from .device_image import DeviceImage
from .luts import (COLOR_TABLE_SIZE_BILATERAL, color_table, gauss_coeff_f32,
                   pre_compute_kernels, space_kernel, tap_table)
from .pad import (cdiv, reflect101_indices, reflect101_pad, replicate_pad, replicate_pad_np,
                  round_up)
from .rng import MT19937, random_array, random_image

__all__ = [
    "ciede2000_ref_square", "ciede2000_square", "bgr2lab_u8", "bgr2lab_u8_exact",
    "DeviceImage",
    "COLOR_TABLE_SIZE_BILATERAL", "color_table", "gauss_coeff_f32",
    "pre_compute_kernels", "space_kernel", "tap_table", "cdiv", "reflect101_indices",
    "reflect101_pad", "replicate_pad", "replicate_pad_np", "round_up", "MT19937",
    "random_array", "random_image",
]
