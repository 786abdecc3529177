"""One rank of the sharded embedding tests (tests/test_torch_embeddings_tp.py).

As tests/torch_tp_ranks.py: spawned (spawn start method), torch, numpy
and the port only, never JAX; numpy trees and inputs in, a pickle of
results out; a `file://` rendezvous under the test's tmp_path, gloo with
a timeout.

For each case every rank cuts its shard of the tree (`weights.ShardPlan`)
and runs `llama.hidden_states` and one `llama.trunk_layer` under its tp
group; then the lockstep embedding op: rank 0 embeds the same batch
through `LockstepEngine.embed`, then serves one greedy request, and the
other ranks mirror both in `worker_loop`.
"""

from __future__ import annotations

import datetime
import os
import pickle

import torch
import torch.distributed as dist

from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.multihost import LockstepEngine, StreamDigest, worker_loop
from kubeai_tpu_torch.engine.weights import ShardPlan
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parallel.collectives import TensorParallel
from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeai_tpu_torch.parity import params_from_numpy

# Seconds a collective may wait for the other ranks.
TIMEOUT_S = 60
ENGINE = dict(num_slots=2, max_seq_len=64, page_size=8, decode_chunk=4)


def run_case(case: dict, mesh, rank: int) -> dict:
    fam = get_model_family(case["family"])
    cfg = tl.LlamaConfig(**case["config"], dtype=torch.float32)
    params = params_from_numpy(case["tree"])
    shard = ShardPlan(fam, cfg, mesh).shard(params)
    tp = TensorParallel(mesh)
    tokens = torch.from_numpy(case["tokens"]).long()
    lengths = torch.from_numpy(case["lengths"])
    out = {}
    with torch.no_grad():
        out["hidden_states"] = fam.hidden_states(shard, cfg, tokens, lengths, tp=tp).numpy()
        x = torch.from_numpy(case["trunk_x"])
        out["trunk_layer"] = tl.trunk_layer(x, tl._layer(shard, 1), cfg, tp).numpy()
    eng = Engine(fam, cfg, params, mesh=mesh, device="cpu",
                 cfg=EngineConfig(cache_dtype=torch.float32, **ENGINE))
    greedy = SamplingParams(temperature=0.0, max_tokens=6)
    if rank == 0:
        ls = LockstepEngine(eng)
        out["lockstep"] = ls.embed(tokens, lengths).numpy()
        out["stream"] = ls.generate([case["prompt"]], greedy)[0]
        ls.shutdown()
        out["digest"] = ls.digest.hexdigest()
    else:
        out["digest"] = worker_loop(eng, digest=StreamDigest()).hexdigest()
    return out


def run(rank: int, world: int, rendezvous: str, inputs_path: str, out_path: str) -> None:
    """Rank `rank` of a gloo world of `world` ranks: every case of the
    pickle at `inputs_path`, its results pickled to `out_path`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = build_mesh(MeshConfig(tp=world))
        with open(inputs_path, "rb") as f:
            spec = pickle.load(f)
        out = {case["name"]: run_case(case, mesh, rank) for case in spec["cases"]}
        tmp = f"{out_path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, out_path)
    finally:
        dist.destroy_process_group()
