"""Multi-device layer: batch fan-out over a mesh of devices and spatial
row-sharding with halo exchange, bit-identical to the single-device ops.

Counterpart of ``various_image_processings_tpu/parallel/``.  Like the JAX
layer it is single-controller: one process holds a (batch × spatial) grid of
``torch.device`` (``mesh.py``) and moves halos and outputs between shards as
tensor copies.  A grid may list one device several times (logical shards).
Multi-GPU meshes (peer copies between cards) are written for but unverified:
the port has been run on one GPU only."""

from .mesh import make_mesh as make_mesh
from .mesh import BATCH_AXIS as BATCH_AXIS
from .mesh import SPATIAL_AXIS as SPATIAL_AXIS
from .batch import batched_apply as batched_apply
from .batch import bilateral_filter_batched as bilateral_filter_batched
from .batch import bilateral_texture_filter_batched as bilateral_texture_filter_batched
from .batch import adaptive_bilateral_filter_batched as adaptive_bilateral_filter_batched
from .batch import gradient_batched as gradient_batched
from .batch import joint_bilateral_filter_batched as joint_bilateral_filter_batched
from .batch import bilateral_filter_batch_spatial as bilateral_filter_batch_spatial
from .batch import joint_bilateral_filter_batch_spatial as joint_bilateral_filter_batch_spatial
from .batch import superpixel_slic_batched as superpixel_slic_batched
from .batch import inpainting_wexler_batched as inpainting_wexler_batched
from .spatial import halo_exchange_rows as halo_exchange_rows
from .spatial import stencil_apply_sharded as stencil_apply_sharded
from .spatial import bilateral_filter_sharded as bilateral_filter_sharded
from .spatial import adaptive_bilateral_filter_sharded as adaptive_bilateral_filter_sharded
from .spatial import gradient_sharded as gradient_sharded
from .spatial import bilateral_texture_filter_sharded as bilateral_texture_filter_sharded
from .spatial import joint_bilateral_filter_sharded as joint_bilateral_filter_sharded
