"""Device meshes over torch.distributed ranks.
Counterpart of kubeai_tpu/parallel/mesh.py.

The JAX package builds a `jax.sharding.Mesh` over the chips one
controller drives. Here one process drives one device, so a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
initialised default process group, with the dim names of MESH_AXES:

  dp  — data parallel (whole-request replication)
  pp  — pipeline parallel (layer stages)
  sp  — sequence parallel (ring attention for long context)
  tp  — tensor parallel (weight sharding)
  ep  — expert parallel, folded over the tp dim as in the JAX package:
        MoE layers read the tensor dim as the expert dim.

The caller initialises the group (`torch.distributed.init_process_group`
with its address, world size and rank): NCCL where each rank has a card
of its own, gloo on the CPU and where several ranks share one card.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch.distributed as dist

AXIS_DATA = "dp"
AXIS_PIPELINE = "pp"
AXIS_TENSOR = "tp"
AXIS_SEQ = "sp"
AXIS_EXPERT = "ep"

# The JAX package's axis order: tp innermost, so neighbouring ranks share a
# tensor-parallel group.
MESH_AXES = (AXIS_DATA, AXIS_PIPELINE, AXIS_SEQ, AXIS_TENSOR)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. Product must equal the world size."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    def axis_sizes(self) -> tuple[int, int, int, int]:
        return (self.dp, self.pp, self.sp, self.tp)


def parse_topology(topology: str) -> tuple[int, ...]:
    """Parse a GKE-style TPU topology string like '2x2' or '2x2x4'."""
    if not re.fullmatch(r"\d+(x\d+)*", topology):
        raise ValueError(f"invalid TPU topology {topology!r}")
    return tuple(int(p) for p in topology.split("x"))


def topology_num_chips(topology: str) -> int:
    return math.prod(parse_topology(topology))


def mesh_from_topology(topology: str, *, tp: int | None = None, sp: int = 1,
                       device_type: str | None = None):
    """A mesh for one slice described by a topology string: by default the
    whole slice is tensor-parallel (tp = chip count)."""
    n = topology_num_chips(topology)
    if tp is None:
        tp = n // sp
    cfg = MeshConfig(dp=n // (tp * sp), sp=sp, tp=tp)
    return build_mesh(cfg, device_type=device_type)


def build_mesh(cfg: MeshConfig, *, device_type: str | None = None):
    """A DeviceMesh with dims MESH_AXES over every rank of the default
    process group. `device_type` defaults to "cuda" on an NCCL group and
    "cpu" otherwise. Every rank calls it, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised process group "
            "(torch.distributed.init_process_group)"
        )
    world = dist.get_world_size()
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg} needs {cfg.num_devices} devices, got {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, cfg.axis_sizes(), mesh_dim_names=MESH_AXES)


def single_device_mesh(device_type: str | None = None):
    """A world-size-1 mesh."""
    return build_mesh(MeshConfig(), device_type=device_type)


def axis_size(mesh, axis: str) -> int:
    """The size of a mesh dim (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))
