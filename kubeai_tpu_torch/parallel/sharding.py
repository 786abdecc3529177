"""Logical-axis sharding rules for model parameters.
Counterpart of kubeai_tpu/parallel/sharding.py.

Every parameter carries *logical* axis names (each family's
`param_specs`), and a `ShardingRules` table maps them to mesh dims,
Megatron-style as in the JAX package:

  - attn q/k/v, mlp gate/up: column-parallel (output feature dim on tp)
  - attn out, mlp down:      row-parallel    (input feature dim on tp)
  - embeddings, lm_head:     vocab on tp
  - MoE experts:             expert dim on tp (expert parallelism)

`shard_params` cuts each leaf to the calling rank's shard (`leaf_cuts`),
the block a `NamedSharding` of the same spec places on that rank's
device; `engine.weights.ShardPlan` applies it to an engine's tree, and
the same cuts to a checkpoint's tensors. In JAX,
GSPMD then inserts the collectives; here the sharded forwards call them
(parallel/collectives.py). `named_sharding` and `param_shardings` have
no counterpart: torch has no jit in/out shardings, and a rank's tensors
are its shard.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from kubeai_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_PIPELINE,
    AXIS_SEQ,
    AXIS_TENSOR,
)

# Logical axis names used across models.
BATCH = "batch"
LAYERS = "layers"  # stacked-layer axis (pipeline stages shard it)
SEQUENCE = "sequence"
VOCAB = "vocab"
EMBED = "embed"
HEADS = "heads"
KV_HEADS = "kv_heads"
HEAD_DIM = "head_dim"
MLP = "mlp"
EXPERT = "expert"
KV_SLOTS = "kv_slots"  # KV-cache slot (request) axis
LORA_RANK = "lora_rank"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Map logical axis name -> mesh dim name (or None = replicate)."""

    rules: tuple[tuple[str, str | None], ...] = (
        (LAYERS, AXIS_PIPELINE),  # pp=1 meshes: dim size 1 -> replicated
        (BATCH, AXIS_DATA),
        (SEQUENCE, AXIS_SEQ),
        (VOCAB, AXIS_TENSOR),
        (EMBED, None),
        (HEADS, AXIS_TENSOR),
        (KV_HEADS, AXIS_TENSOR),
        (HEAD_DIM, None),
        (MLP, AXIS_TENSOR),
        (EXPERT, AXIS_TENSOR),  # MoE experts reuse the tp dim (see mesh.py)
        (KV_SLOTS, AXIS_DATA),
        (LORA_RANK, None),
    )

    def physical(self, logical_axis: str | None) -> str | None:
        if logical_axis is None:
            return None
        for name, phys in self.rules:
            if name == logical_axis:
                return phys
        raise KeyError(f"no sharding rule for logical axis {logical_axis!r}")

    def spec(self, logical_axes: tuple[str | None, ...]) -> tuple[str | None, ...]:
        return tuple(self.physical(a) for a in logical_axes)

    def replicating(self, logical_axis: str) -> "ShardingRules":
        """These rules with `logical_axis` replicated."""
        return ShardingRules(tuple(
            (name, None if name == logical_axis else phys) for name, phys in self.rules
        ))


DEFAULT_RULES = ShardingRules()


def logical_to_physical(
    logical_axes: tuple[str | None, ...],
    rules: ShardingRules = DEFAULT_RULES,
) -> tuple[str | None, ...]:
    """The mesh dim of each axis (None = replicated): the port's
    PartitionSpec."""
    return rules.spec(logical_axes)


def leaf_cuts(shape, physical: tuple[str | None, ...], mesh) -> list[tuple[int, int, int]]:
    """(axis, start, length) of this rank's block along each axis that a
    spec of mesh dims cuts: the axis in equal parts, one per rank of its
    dim, the part at the rank's coordinate; an axis whose dim is None or
    of size 1 is not cut. Raises where a dim does not divide its axis (the
    JAX sharding would pad the last block)."""
    if len(physical) != len(shape):
        raise ValueError(f"spec {physical} does not match a tensor of shape {tuple(shape)}")
    cuts = []
    for axis, dim in enumerate(physical):
        if dim is None:
            continue
        n = mesh.size(mesh.mesh_dim_names.index(dim))
        if n == 1:
            continue
        if shape[axis] % n:
            raise ValueError(
                f"axis {axis} of shape {tuple(shape)} does not divide over "
                f"{n} ranks of mesh dim {dim!r}"
            )
        part = shape[axis] // n
        cuts.append((axis, mesh.get_local_rank(dim) * part, part))
    return cuts


def narrow(x: torch.Tensor, cuts: list[tuple[int, int, int]]) -> torch.Tensor:
    """`x` narrowed by `cuts` ((axis, start, length) each): a new
    contiguous tensor, so `x` can be freed; with no cut, `x` itself."""
    for axis, start, length in cuts:
        x = x.narrow(axis, start, length)
    return x.clone(memory_format=torch.contiguous_format) if cuts else x


def shard_leaf(x: torch.Tensor, physical: tuple[str | None, ...], mesh) -> torch.Tensor:
    """This rank's block of `x` under a spec of mesh dims (`leaf_cuts`). A
    leaf that nothing cuts (replicated, or every dim of its axes of size
    1) is `x` itself."""
    return narrow(x, leaf_cuts(x.shape, physical, mesh))


def shard_params(
    params: Any,
    logical_specs: Any,
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
) -> Any:
    """This rank's shard of a param tree, given a matching tree of logical
    axis tuples, cut leaf by leaf at load. A leaf that appears twice (a
    tied `lm_head`) stays one tensor."""
    cut: dict[int, torch.Tensor] = {}

    def walk(leaf, axes):
        if isinstance(leaf, dict):
            return {k: walk(v, axes[k]) for k, v in leaf.items()}
        key = id(leaf)
        if key not in cut:
            cut[key] = shard_leaf(leaf, rules.spec(axes), mesh)
        return cut[key]

    return walk(params, logical_specs)
