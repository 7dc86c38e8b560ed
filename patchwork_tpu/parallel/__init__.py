from .mesh import DATA_AXIS, POINT_AXIS, make_mesh, replicated, scan_batch_sharding
from .multihost import host_summary, initialize_multihost, is_multihost
from .sharded import (
    make_dp_sharded_filter_ground,
    make_sharded_filter_ground,
    make_sharded_pipeline,
)
from .shardmap_engine import make_shardmap_patchwork
