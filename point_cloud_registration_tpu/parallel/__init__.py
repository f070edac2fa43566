"""Multi-device / multi-host execution: runtime init, meshes, sharded align."""

from point_cloud_registration_tpu.parallel import distributed
from point_cloud_registration_tpu.parallel.map_sharded import (
    ShardedMapMeta,
    ShardedVoxelMap,
    align_map_sharded,
    make_map_mesh,
    shard_voxel_map,
    shard_voxel_map_on_mesh,
)
from point_cloud_registration_tpu.parallel.mesh import make_mesh
from point_cloud_registration_tpu.parallel.sharded import (
    STATS_FNS,
    align_batched_sharded,
    align_sharded,
)
