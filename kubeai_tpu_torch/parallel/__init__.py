"""Parallelism layer: device meshes, sharding rules, collectives.
Counterpart of kubeai_tpu/parallel/__init__.py.

A mesh is a `torch.distributed` DeviceMesh over one rank per device
(parallel/mesh.py); each rank keeps its shard of the weights
(parallel/sharding.py) and the sharded forwards call the tp group's
collectives (parallel/collectives.py) where the JAX package's GSPMD
inserts its own.
"""

from kubeai_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    mesh_from_topology,
    AXIS_DATA,
    AXIS_TENSOR,
    AXIS_SEQ,
    AXIS_EXPERT,
)
from kubeai_tpu_torch.parallel.sharding import (
    ShardingRules,
    logical_to_physical,
    shard_params,
)
