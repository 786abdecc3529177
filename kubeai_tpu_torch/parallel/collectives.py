"""The collectives of tensor parallelism, which XLA's GSPMD inserts unseen
in the JAX package (kubeai_tpu/parallel/sharding.py) and the port's
sharded forwards call themselves.

A layer on a tp rank holds its heads' columns of wq/wk/wv, their rows of
wo, its columns of w_gate/w_up and its rows of w_down (mixtral: its
experts), and its block of the vocabulary in `embed` and `lm_head`
(parallel/sharding.py). So:

  - `embed`: each rank looks up the tokens of its vocabulary block (zeros
    for the others) and one all_reduce sums the rows;
  - `all_reduce` after the row-parallel products (`wo`, `w_down`, and
    mixtral's expert combine): each rank's partial sum over its columns;
  - `gather_vocab`: the f32 logits of each rank's vocabulary block, all
    gathered into the full row, so every rank samples from the same
    logits with the same seed and no token is broadcast.

The all_reduce sums in f32 and rounds once to the activation dtype: at
world size 1 it returns its input bit for bit. Every function is a no-op
without a mesh (`tp=None`).

Backends: on NCCL the collectives run on the card and a CUDA graph
captures them (engine/graphs.py); the communicator is warmed up before
any capture (`warm_up`). On gloo (the CPU, and several ranks on one
card, where NCCL refuses to run) gloo copies a CUDA tensor through the
host itself, and no graph is captured.

Host decisions that read the clock (the engine's adaptive speculation)
must agree on every rank, or ranks would enter different collectives:
`agree` broadcasts rank 0's choice over a gloo group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubeai_tpu_torch.parallel.mesh import AXIS_TENSOR


class TpLayout:
    """The tp dim's size and this rank's coordinate, and the rank-local
    head counts they give: what cutting weights needs (weights.ShardPlan),
    without the group."""

    def __init__(self, size: int, rank: int):
        self.size = size
        self.rank = rank

    @classmethod
    def of(cls, mesh) -> "TpLayout":
        return cls(mesh.size(mesh.mesh_dim_names.index(AXIS_TENSOR)),
                   mesh.get_local_rank(AXIS_TENSOR))

    # ---- head layout ---------------------------------------------------

    def local_heads(self, num_heads: int) -> int:
        if num_heads % self.size:
            raise ValueError(f"{num_heads} heads do not divide over tp={self.size}")
        return num_heads // self.size

    def kv_replicated(self, num_kv_heads: int) -> bool:
        """Whether tp exceeds the KV heads, so that each KV head is held
        by the tp / num_kv_heads ranks whose q heads read it."""
        if num_kv_heads % self.size == 0:
            return False
        if self.size % num_kv_heads:
            raise ValueError(
                f"{num_kv_heads} KV heads over tp={self.size}: neither divides the other"
            )
        return True

    def local_kv_heads(self, num_kv_heads: int) -> int:
        return 1 if self.kv_replicated(num_kv_heads) else num_kv_heads // self.size

    def kv_head(self, num_kv_heads: int) -> int:
        """The KV head this rank holds when they are replicated: the one
        its q heads read (rank * num_kv_heads // tp)."""
        return self.rank * num_kv_heads // self.size


class TensorParallel(TpLayout):
    """The tp dim of a mesh, as the sharded forwards use it: its group,
    size, this rank's coordinate, and the rank-local head counts."""

    def __init__(self, mesh):
        layout = TpLayout.of(mesh)
        super().__init__(layout.size, layout.rank)
        self.group = mesh.get_group(AXIS_TENSOR)
        self.backend = dist.get_backend(self.group)
        # A CUDA graph captures NCCL collectives; gloo's run on the host.
        self.capturable = self.backend == "nccl"
        self._host_group = None
        if self.size > 1:
            self._host_group = (
                self.group if self.backend == "gloo" else dist.new_group(
                    dist.get_process_group_ranks(self.group), backend="gloo")
            )

    # ---- collectives ---------------------------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x, in f32, rounded once to x's dtype."""
        y = x.float()
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the full [V, E] table from this rank's [V / tp, E]
        block: each rank's rows where the token lies in its block, zeros
        elsewhere, summed over the ranks."""
        rows = table.shape[0]
        local = tokens - self.rank * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * inside[..., None].to(table.dtype)
        return self.all_reduce(x)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """[N, V / tp] logits of this rank's vocabulary block -> [N, V], in
        rank order."""
        src = logits.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=-1)

    def agree(self, value: int) -> int:
        """Rank 0's value, on every rank of the group."""
        if self._host_group is None:
            return value
        t = torch.tensor([value], dtype=torch.int64)
        dist.broadcast(t, src=dist.get_global_rank(self._host_group, 0), group=self._host_group)
        return int(t.item())

    def warm_up(self, device: torch.device) -> None:
        """One all_reduce and one all_gather on `device`, synchronized: the
        communicator is built here, before a graph captures its
        collectives."""
        x = torch.ones((1, 8), device=device)
        self.all_reduce(x)
        self.gather_vocab(x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def all_reduce(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    return x if tp is None else tp.all_reduce(x)


def embed(table: torch.Tensor, tokens: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    return table[tokens] if tp is None else tp.embed(table, tokens)


def gather_vocab(logits: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    return logits if tp is None else tp.gather_vocab(logits)
