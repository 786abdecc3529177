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
`rank_layout` and `init_rank` do that for a slice described as the
entry point's flags describe it (the counterpart of the JAX entry
point's `jax.distributed.initialize`): `topology chips / num_processes`
ranks in each process, global rank `process_id * local + local_rank`.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import re

import torch
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


# ---- the ranks of a slice ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """The ranks of one slice: `world` ranks (the topology's chips) over
    `num_processes` processes of `local` ranks each, this process being
    `process_id`; they meet at `coordinator` (host:port) when there are
    several processes."""

    topology: str
    world: int
    num_processes: int
    process_id: int
    local: int
    coordinator: str = ""

    def global_rank(self, local_rank: int) -> int:
        return self.process_id * self.local + local_rank


def rank_layout(topology: str, num_processes: int = 1, process_id: int = 0,
                coordinator: str = "") -> RankLayout:
    """The layout the entry point's --tpu-topology, --num-processes,
    --process-id and --dcn-coordinator describe. Raises ValueError, naming
    the numbers, when the chips do not divide over the processes."""
    world = topology_num_chips(topology)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(
            f"process id {process_id} is not one of {num_processes} processes")
    if world % num_processes:
        raise ValueError(
            f"topology {topology} has {world} chips, which do not divide over "
            f"{num_processes} processes")
    if num_processes > 1 and not coordinator:
        raise ValueError(
            f"{num_processes} processes need a coordinator address (host:port)")
    return RankLayout(topology, world, num_processes, process_id,
                      world // num_processes, coordinator)


@dataclasses.dataclass(frozen=True)
class RankPlacement:
    """Where one rank runs: its device, the backend of its group, and how
    many ranks of this process share that device."""

    device: torch.device
    backend: str
    ranks_per_device: int


def place_rank(layout: RankLayout, local_rank: int, device: str) -> RankPlacement:
    """Local rank r takes `cuda:r` over NCCL when the process sees at least
    `layout.local` GPUs. Where fewer GPUs are seen, every local rank takes
    `cuda:0` over gloo (NCCL refuses two ranks on one device), which is
    time-slicing, not parallel speed. `device="cpu"` runs every rank on
    the CPU over gloo."""
    kind = torch.device(device).type
    if kind == "cpu":
        return RankPlacement(torch.device("cpu"), "gloo", layout.local)
    if kind != "cuda":
        raise ValueError(f"ranks run on cuda or cpu, not {device!r}")
    if torch.cuda.device_count() >= layout.local:
        return RankPlacement(torch.device("cuda", local_rank), "nccl", 1)
    return RankPlacement(torch.device("cuda", 0), "gloo", layout.local)


def rendezvous_address(layout: RankLayout, local_store: str) -> str:
    """The init_method of the slice's group: the coordinator over TCP when
    there are several processes, else the file store `local_store` (a path
    that does not exist yet, shared by the process's local ranks)."""
    if layout.num_processes > 1:
        return f"tcp://{layout.coordinator}"
    return f"file://{local_store}"


def init_rank(layout: RankLayout, local_rank: int, device: str, rendezvous: str,
              timeout_s: float):
    """Join the slice's process group as `local_rank` of this process and
    build its mesh (`mesh_from_topology`). Returns (placement, mesh,
    host_group): `host_group` is a gloo group of every rank, for the host
    tensors that lockstep serving broadcasts, so none of them enters the
    NCCL group or a CUDA graph. Every rank of the slice calls it."""
    placement = place_rank(layout, local_rank, device)
    if placement.device.type == "cuda":
        torch.cuda.set_device(placement.device)
    dist.init_process_group(
        placement.backend, init_method=rendezvous,
        rank=layout.global_rank(local_rank), world_size=layout.world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    host_group = (dist.group.WORLD if placement.backend == "gloo"
                  else dist.new_group(backend="gloo"))
    mesh = mesh_from_topology(layout.topology)
    return placement, mesh, host_group
