"""patchwork_tpu — a LiDAR perception engine on JAX/XLA.

Brand-new implementation (not a port) of the Recursive Patchwork ground
segmentation pipeline with multi-LiDAR fusion, pure-array ingest, BEV
visualization, CLI/streaming front ends, and mesh-sharded batch execution,
built on JAX / XLA / pjit.  See SURVEY.md for the structural map
of the reference implementation this replaces.
"""

from .core.config import LidarConfig, PatchworkConfig, default_lidar_configs
from .core.types import GroundResult, PointCloud, ScanBatch
from .segment.engine import (
    filter_ground,
    make_filter_ground,
    make_filter_ground_batched,
)


def __getattr__(name):  # lazy heavy imports
    if name == "RecursivePatchwork":
        from .api import RecursivePatchwork

        return RecursivePatchwork
    if name == "PointCloudProcessor":
        from .processor import PointCloudProcessor

        return PointCloudProcessor
    if name == "LidarFusion":
        from .fusion.fusion import LidarFusion

        return LidarFusion
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    "PatchworkConfig",
    "LidarConfig",
    "default_lidar_configs",
    "PointCloud",
    "ScanBatch",
    "GroundResult",
    "filter_ground",
    "make_filter_ground",
    "make_filter_ground_batched",
    "RecursivePatchwork",
    "PointCloudProcessor",
    "LidarFusion",
    "__version__",
]
