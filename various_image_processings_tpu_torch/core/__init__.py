"""Host-side building blocks: LUTs, the MT19937 test-image twin, padding."""

from .luts import (COLOR_TABLE_SIZE_BILATERAL, color_table, gauss_coeff_f32,
                   space_kernel, tap_table)
from .pad import cdiv, reflect101_indices, reflect101_pad, replicate_pad, round_up
from .rng import MT19937, random_array, random_image

__all__ = [
    "COLOR_TABLE_SIZE_BILATERAL", "color_table", "gauss_coeff_f32",
    "space_kernel", "tap_table", "cdiv", "reflect101_indices", "reflect101_pad",
    "replicate_pad", "round_up", "MT19937", "random_array", "random_image",
]
