"""Spatial (H-axis) sharding of extraction over several devices
(posfeat_tpu/parallel)."""

from .banded_detect import check_detector, detect, sample_feat_by_coord
from .banded_ops import Bands
from .spatial import SpatialMesh, check_model, spatial_extract, spatial_mesh

__all__ = [
    "Bands",
    "SpatialMesh",
    "check_detector",
    "check_model",
    "detect",
    "sample_feat_by_coord",
    "spatial_extract",
    "spatial_mesh",
]
