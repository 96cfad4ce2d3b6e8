"""Multi-device and multi-process execution (``parallel/sharding.py``,
``parallel/multihost.py``)."""

from .sharding import (
    ROWS_AXIS, THETA_AXIS, Mesh, approx_batch_update_sharded, default_mesh_shape,
    exact_batch_update_sharded, make_mesh, pad_theta_batch, pad_to_multiple,
    shard_rows, sorted_batch_rowsharded, sorted_batch_sharded,
)
from . import multihost

__all__ = [
    "ROWS_AXIS", "THETA_AXIS", "Mesh", "approx_batch_update_sharded", "default_mesh_shape",
    "exact_batch_update_sharded", "make_mesh", "multihost",
    "pad_theta_batch", "pad_to_multiple", "shard_rows", "sorted_batch_rowsharded",
    "sorted_batch_sharded",
]
