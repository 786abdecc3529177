"""One rank of the tensor-parallel tests (tests/test_torch_tp.py).

The test spawns `world` processes, each running `run` (spawn start
method: the parent has JAX's threads). This module imports torch, numpy
and the port only, never JAX, so the children never import it: the
parent writes the JAX trees and inputs as numpy into a pickle, and each
rank writes what it computed into a pickle of its own. The ranks meet
through a `file://` rendezvous under the test's tmp_path, over gloo with
a timeout, so a rank that desyncs fails the test instead of hanging it.

For each case (a model, its numpy parameter tree and engine settings,
and the whole adapters it loads) every rank builds `Engine(...,
mesh=build_mesh(MeshConfig(tp=world)))` in each of the case's modes and
runs the same requests; with `logits`,
it also runs the sharded forwards (prefill, both decode layouts, the
verify window for the llama family) on the engine's shard of the
params and the rank's KV heads of the parent's pools.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models import mixtral as tm
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeai_tpu_torch.parity import params_from_numpy

# Seconds a collective may wait for the other ranks.
TIMEOUT_S = 60
CONFIGS = {"llama": tl.LlamaConfig, "qwen": tl.LlamaConfig, "mixtral": tm.MixtralConfig}


def run_waves(eng, waves) -> list[list[int]]:
    """Each wave's (prompt, sampling kwargs[, adapter]) requests added at
    once and stepped until done; the streams in request order."""
    streams = []
    for wave in waves:
        rids = [eng.add_request(p, SamplingParams(**sp), adapter=(a[0] if a else None))
                for p, sp, *a in wave]
        out = {rid: [] for rid in rids}
        while eng.has_work():
            for ev in eng.step():
                out[ev.rid].append(ev.token)
        streams += [out[rid] for rid in rids]
    return streams


def _local_heads(pages: np.ndarray, eng) -> torch.Tensor:
    """The rank's KV heads of a full [..., KVH, D] pool."""
    tp, kvh = eng._tp, eng.model_cfg.num_kv_heads
    n = tp.local_kv_heads(kvh)
    first = tp.kv_head(kvh) if tp.kv_replicated(kvh) else tp.rank * n
    return torch.from_numpy(np.ascontiguousarray(pages[..., first:first + n, :]))


def forward_logits(eng, inputs: dict, verify: bool) -> dict:
    """The sharded forwards on the engine's params: {name: (logits, the
    rank's K, the rank's V)} as numpy. With adapters loaded, each forward
    takes the engine's (rank-local) buffers and the inputs' `lora_idx`."""
    fam, cfg, params = eng.family, eng.model_cfg, eng.params

    def kw(name):
        if eng._lora is None:
            return {"tp": eng._tp}
        return {"tp": eng._tp, "lora": eng._lora,
                "lora_idx": torch.from_numpy(inputs["lora_idx"][name]).long()}

    out = {}
    with torch.no_grad():
        pre = inputs["prefill"]
        logits, k, v = fam.prefill(params, cfg, torch.from_numpy(pre["tokens"]).long(),
                                   torch.from_numpy(pre["lengths"]), **kw("prefill"))
        out["prefill"] = (logits.numpy(), k.numpy(), v.numpy())
        dec = inputs["decode"]
        for layout in ("per_layer", "fused"):
            kp, vp = _local_heads(dec["k_pages"], eng), _local_heads(dec["v_pages"], eng)
            logits, kp, vp = fam.decode_step_paged(
                params, cfg, torch.from_numpy(dec["tokens"]).long(),
                torch.from_numpy(dec["positions"]).long(), kp, vp,
                torch.from_numpy(dec["block_tables"]), attn_kernel=layout, **kw("decode"))
            out[f"decode_{layout}"] = (logits.numpy(), kp.numpy(), vp.numpy())
        if verify:
            ver = inputs["verify"]
            kp, vp = _local_heads(ver["k_pages"], eng), _local_heads(ver["v_pages"], eng)
            logits, kp, vp = fam.decode_verify_paged(
                params, cfg, torch.from_numpy(ver["tokens"]).long(),
                torch.from_numpy(ver["positions"]).long(), kp, vp,
                torch.from_numpy(ver["block_tables"]), **kw("verify"))
            out["verify"] = (logits.numpy(), kp.numpy(), vp.numpy())
    return out


def run_case(case: dict, spec: dict, mesh) -> dict:
    fam = get_model_family(case["family"])
    cfg = CONFIGS[case["family"]](**case["config"], dtype=torch.float32)
    params = params_from_numpy(case["tree"])
    res = {"streams": {}, "prefix_stats": {}}
    for mode, kw in case["modes"].items():
        eng = Engine(fam, cfg, params, mesh=mesh, device="cpu", cfg=EngineConfig(
            cache_dtype=torch.float32, **spec["base"], **case["engine"], **kw))
        for name, weights in case.get("adapters", {}).items():
            eng.load_adapter(name, weights)
        res["streams"][mode] = run_waves(eng, case.get("waves") or spec["waves"])
        res["prefix_stats"][mode] = dict(eng.prefix_stats)
        if mode == "per_layer":
            res["kv_heads"] = eng.cache.k_pages.shape[-2]
            res["wq_columns"] = eng.params["layers"]["wq"]
            res["wq_columns"] = (res["wq_columns"]["w8"] if isinstance(res["wq_columns"], dict)
                                 else res["wq_columns"]).shape[-1]
            if case["logits"]:
                res["logits"] = forward_logits(eng, spec["inputs"],
                                               fam.decode_verify_paged is not None)
    return res


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
        out = {case["name"]: run_case(case, spec, mesh) for case in spec["cases"]}
        tmp = f"{out_path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, out_path)
    finally:
        dist.destroy_process_group()
