"""One rank of the gemma tensor-parallel tests (tests/test_torch_gemma_tp.py).

As tests/torch_tp_ranks.py: the test spawns `world` processes (spawn
start method), each running `run`; this module imports torch, numpy and
the port only, never JAX. The parent writes the JAX trees and the
forwards' inputs as numpy into a pickle; each rank writes what it
computed into a pickle of its own. The ranks meet through a `file://`
rendezvous under the test's tmp_path, over gloo with a timeout.

For each config every rank cuts its shard of the tree
(`weights.ShardPlan`) and runs the sharded forwards (`prefill`, each
chunk of `prefill_chunk`, `decode_step_paged` in both layouts) on its KV
heads of the parent's pools and staging cache; then, for each of the
config's engine modes at this world, `Engine(..., mesh=...)` on the whole
tree serves the parent's waves. At the served run's world every rank
also runs its oracle (`served_oracle`).
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from torch_tp_ranks import run_waves

from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.server import engine_config, parse_args, resolve_ranks
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import ShardPlan, load_hf_config, load_params
from kubeai_tpu_torch.models import gemma as tg
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parallel.collectives import TensorParallel
from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeai_tpu_torch.parity import params_from_numpy

# Seconds a collective may wait for the other ranks.
TIMEOUT_S = 60


def local_heads(a: np.ndarray, tp, kvh: int) -> torch.Tensor:
    """The rank's KV heads of a full [..., KVH, D] array: KVH / tp of
    them, or where tp exceeds the KV heads the one its q heads read."""
    n = tp.local_kv_heads(kvh)
    first = tp.kv_head(kvh) if tp.kv_replicated(kvh) else tp.rank * n
    return torch.from_numpy(a[..., first:first + n, :].copy())


def forwards(params: dict, cfg, tp, inputs: dict) -> dict:
    """{forward: (logits, the rank's K, the rank's V)} as numpy; the
    chunks' entries are keyed `chunk<start>` (logits None but the last)."""
    kvh = cfg.num_kv_heads
    out = {}
    with torch.no_grad():
        pre = inputs["prefill"]
        logits, k, v = tg.prefill(params, cfg, torch.from_numpy(pre["tokens"]).long(),
                                  torch.from_numpy(pre["lengths"]), tp=tp)
        out["prefill"] = (logits.numpy(), k.numpy(), v.numpy())
        ch = inputs["chunk"]
        kc, vc = local_heads(ch["k_stale"], tp, kvh), local_heads(ch["v_stale"], tp, kvh)
        n, C = int(ch["length"]), int(ch["size"])
        for start in range(0, n, C):
            last = start + C >= n
            logits, kc, vc = tg.prefill_chunk(
                params, cfg, torch.from_numpy(ch["tokens"][None, start:start + C]).long(),
                torch.tensor(start), torch.tensor(n), kc, vc, want_logits=last, tp=tp)
            out[f"chunk{start}"] = (None if logits is None else logits.numpy(),
                                    kc.numpy().copy(), vc.numpy().copy())
        dec = inputs["decode"]
        for layout in ("per_layer", "fused"):
            kp, vp = local_heads(dec["k_pages"], tp, kvh), local_heads(dec["v_pages"], tp, kvh)
            logits, kp, vp = tg.decode_step_paged(
                params, cfg, torch.from_numpy(dec["tokens"]).long(),
                torch.from_numpy(dec["positions"]).long(), kp, vp,
                torch.from_numpy(dec["block_tables"]), attn_kernel=layout, tp=tp)
            out[f"decode_{layout}"] = (logits.numpy(), kp.numpy(), vp.numpy())
    return out


def run_config(case: dict, spec: dict, mesh, world: int) -> dict:
    fam = get_model_family("gemma")
    cfg = tg.GemmaConfig(**case["config"], dtype=torch.float32)
    params = params_from_numpy(case["tree"])
    res = {"streams": {}, "prefix_stats": {}}
    shard = ShardPlan(fam, cfg, mesh).shard(params)
    res["logits"] = forwards(shard, cfg, TensorParallel(mesh), case["inputs"])
    res["wq_columns"] = shard["layers"]["wq"].shape[-1]
    res["embed_rows"] = shard["embed"].shape[0]
    for mode, kw in case["modes"].get(world, {}).items():
        eng = Engine(fam, cfg, params, mesh=mesh, device="cpu", cfg=EngineConfig(
            cache_dtype=torch.float32, **spec["base"], **kw))
        res["streams"][mode] = run_waves(eng, spec["waves"])
        res["prefix_stats"][mode] = dict(eng.prefix_stats)
        res["kv_heads"] = eng.cache.k_pages.shape[-2]
    return res


def served_oracle(served: dict, mesh) -> list:
    """The plain SPMD oracle of a served run on a gemma checkpoint (every
    rank runs the requests itself): the rank-local shard of the
    checkpoint in bf16 in an engine of the entry point's configuration
    for its flags, each request run alone in order. Streams of unary
    requests as text."""
    args = parse_args(["--model-url", served["model_dir"], *served["flags"]])
    resolve_ranks(args)
    hf = load_hf_config(served["model_dir"])
    family = get_model_family(hf["architectures"][0])
    cfg = family.config_from_hf(hf)
    tok = ByteTokenizer()
    eng = Engine(family, cfg, load_params(family.name, served["model_dir"], cfg, device="cpu",
                                          shard=ShardPlan(family, cfg, mesh)),
                 mesh=mesh, presharded=True, device="cpu", eos_token_ids=tok.eos_token_ids,
                 cfg=engine_config(args))
    out = []
    for ids, sp, stream in served["requests"]:
        toks = eng.generate([ids], SamplingParams(**sp))[0]
        out.append(toks if stream else tok.decode(toks))
    return out


def run(rank: int, world: int, rendezvous: str, inputs_path: str, out_path: str) -> None:
    """Rank `rank` of a gloo world of `world` ranks: every config of the
    pickle at `inputs_path`, and at the served run's world its oracle,
    the results pickled to `out_path`."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = build_mesh(MeshConfig(tp=world))
        with open(inputs_path, "rb") as f:
            spec = pickle.load(f)
        out = {case["name"]: run_config(case, spec, mesh, world) for case in spec["cases"]}
        if spec["served"]["world"] == world:
            out["served"] = served_oracle(spec["served"], mesh)
        tmp = f"{out_path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, out_path)
    finally:
        dist.destroy_process_group()
