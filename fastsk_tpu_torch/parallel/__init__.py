"""Multi-device execution of the packed exact engine (``parallel/sharding.py``)."""

from .sharding import (
    ROWS_AXIS, THETA_AXIS, Mesh, default_mesh_shape, host_gather, make_mesh,
    pad_to_multiple,
)

__all__ = [
    "ROWS_AXIS", "THETA_AXIS", "Mesh", "default_mesh_shape", "host_gather",
    "make_mesh", "pad_to_multiple",
]
