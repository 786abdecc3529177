"""The ranks and checkpoints of the lockstep tests (tests/test_torch_multihost.py).

This module imports torch, numpy and the port only, never JAX, so the
processes that the tests spawn (spawn start method) never import it: the
parent writes the numpy trees and requests into a pickle, and each rank
writes what it produced into a pickle of its own. The ranks meet through
a `file://` rendezvous under the test's tmp_path, over gloo with a
timeout.

`run_lockstep` is one rank of the two-rank world: rank 0 drives
`LockstepEngine` through the legs of the JAX package's
tests/integration/test_multihost_serving.py (seeded sampling, a cancel in
mid-flight, an adapter loaded through the broadcast and used, a base
request, the prefix-cache pair) and rank 1 runs `worker_loop`; both
return their engine's stream digest. Then both ranks run `run_spmd`, the
plain SPMD oracle of the tests' served runs. `run_diverged_load` plants
an adapter load that fails on rank 1 only.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine.multihost import LockstepEngine, StreamDigest, worker_loop
from kubeai_tpu_torch.engine.lora_weights import load_peft_adapter
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import (
    ShardPlan,
    load_hf_config,
    load_params,
    save_safetensors,
)
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.models.registry import get_model_family
from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeai_tpu_torch.parity import params_from_numpy

# Seconds a collective may wait for the other rank.
TIMEOUT_S = 60


def write_llama_checkpoint(path, cfg: dict, seed: int = 0, bias: bool = False) -> str:
    """`path`/model.safetensors and config.json: a LlamaForCausalLM (or,
    with `bias`, Qwen2ForCausalLM) of `cfg`'s widths (HF config keys),
    tensors under their Hugging Face names drawn with numpy from `seed`
    in bf16, projections stored [out, in]; the head's printable-byte rows
    drawn 8 times larger, so that greedy picks are decisive bytes."""
    rng = np.random.default_rng(seed)
    E, M, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = E // H

    def rnd(*shape, scale=0.05, mean=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale + mean
        return torch.from_numpy(a).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": rnd(V, E, scale=0.5),
         "model.norm.weight": rnd(E, scale=0.1, mean=1.0)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name in ("input_layernorm", "post_attention_layernorm"):
            t[f"{p}{name}.weight"] = rnd(E, scale=0.1, mean=1.0)
        for name, shape in (("q_proj", (H * D, E)), ("k_proj", (KVH * D, E)),
                            ("v_proj", (KVH * D, E)), ("o_proj", (E, H * D))):
            t[f"{p}self_attn.{name}.weight"] = rnd(*shape, scale=0.2)
        if bias:
            for name, out in (("q_proj", H * D), ("k_proj", KVH * D), ("v_proj", KVH * D)):
                t[f"{p}self_attn.{name}.bias"] = rnd(out, scale=0.1)
        for name, shape in (("gate_proj", (M, E)), ("up_proj", (M, E)), ("down_proj", (E, M))):
            t[f"{p}mlp.{name}.weight"] = rnd(*shape, scale=0.1)
    head = rnd(V, E, scale=0.05)
    head[32:127] *= 8
    t["lm_head.weight"] = head
    config = {"architectures": ["Qwen2ForCausalLM" if bias else "LlamaForCausalLM"],
              "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "max_position_embeddings": 512,
              "torch_dtype": "bfloat16", **cfg}
    save_safetensors(str(path), t, config)
    return str(path)


LORA_HF = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}


def write_peft_adapter(path, cfg, seed: int, r: int = 4, alpha: float = 8.0) -> str:
    """A PEFT adapter directory: rank-`r` lora_A / lora_B over wq, wk, wv
    and wo of every layer of the port config `cfg`, drawn with numpy from
    `seed` in bf16, and its adapter_config.json."""
    rng = np.random.default_rng(seed)
    dims = tl.lora_dims(cfg)
    tensors = {}
    for i in range(cfg.num_layers):
        for target, hf in LORA_HF.items():
            din, dout = dims[target]
            name = f"base_model.model.model.layers.{i}.self_attn.{hf}"
            for part, shape in (("lora_A", (r, din)), ("lora_B", (dout, r))):
                w = rng.standard_normal(shape).astype(np.float32) * 0.3
                tensors[f"{name}.{part}.weight"] = torch.from_numpy(w).to(torch.bfloat16)
    save_safetensors(str(path), tensors, {})
    os.replace(os.path.join(path, "model.safetensors"),
               os.path.join(path, "adapter_model.safetensors"))
    os.remove(os.path.join(path, "config.json"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "target_modules": list(LORA_HF.values())}, f)
    return str(path)


def _drain(eng, rid) -> list[int]:
    toks = []
    while eng.has_work():
        toks += [e.token for e in eng.step() if e.rid == rid]
    return toks


def run_spmd(served: dict, mesh) -> list:
    """The plain SPMD oracle of a served run (no lockstep: every rank runs
    the same requests itself): the checkpoint's rank-local shard in bf16
    in an engine of the server's configuration, the adapter loaded, each
    request run alone in order. Streams of unary requests as text; and
    the served run's embedding vectors (`embed_oracle`)."""
    hf = load_hf_config(served["model_dir"])
    family = get_model_family(hf["architectures"][0])
    cfg = family.config_from_hf(hf)
    tok = ByteTokenizer()
    eng = Engine(family, cfg, load_params(family.name, served["model_dir"], cfg, device="cpu",
                                          shard=ShardPlan(family, cfg, mesh)),
                 mesh=mesh, presharded=True, device="cpu", eos_token_ids=tok.eos_token_ids,
                 cfg=EngineConfig(**served["engine"]))
    eng.load_adapter("tenant", load_peft_adapter(served["adapter_dir"], cfg))
    out = []
    for ids, sp, adapter, stream in served["requests"]:
        toks = eng.generate([ids], SamplingParams(**sp), adapter=adapter)[0]
        out.append(toks if stream else tok.decode(toks))
    return out, embed_oracle(eng, served["embed_inputs"])


def embed_oracle(eng, texts: list[str]) -> list[list[float]]:
    """/v1/embeddings' vectors of `texts` as a server on `eng` computes
    them: the ids right-padded to the engine's bucket, one batch, the
    family's hidden_states (under the engine's tp group)."""
    tok = ByteTokenizer()
    ids = [tok.encode(t) or [0] for t in texts]
    tokens = torch.zeros((len(ids), eng._bucket(max(map(len, ids)))), dtype=torch.long)
    for row, i in enumerate(ids):
        tokens[row, :len(i)] = torch.tensor(i)
    kw = {} if eng._tp is None else {"tp": eng._tp}
    with torch.no_grad():
        return eng.family.hidden_states(eng.params, eng.model_cfg, tokens,
                                        torch.tensor([len(i) for i in ids]), **kw).tolist()


def run_lockstep(rank: int, world: int, rendezvous: str, inputs_path: str,
                 out_path: str) -> None:
    """One rank of the lockstep world (tp = world): rank 0 drives the legs
    through LockstepEngine, the others run worker_loop."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(inputs_path, "rb") as f:
            spec = pickle.load(f)
        cfg = tl.LlamaConfig(**spec["config"], dtype=torch.float32)
        mesh = build_mesh(MeshConfig(tp=world))
        eng = Engine("llama", cfg, params_from_numpy(spec["tree"]), device="cpu", mesh=mesh,
                     cfg=EngineConfig(cache_dtype=torch.float32, **spec["engine"]))
        out = {}
        if rank == 0:
            ls = LockstepEngine(eng)
            out["outs"] = ls.generate(spec["prompts"], SamplingParams(**spec["sampling"]))
            # Cancel path: admit a long request, cancel after two steps.
            rid = ls.add_request(spec["cancel_prompt"],
                                 SamplingParams(temperature=0.0, max_tokens=40))
            got = []
            for _ in range(2):
                got += [e for e in ls.step() if e.rid == rid]
            ls.cancel(rid)
            while ls.has_work():
                ls.step()
            out["cancel_tokens"] = len(got)
            lsp = SamplingParams(temperature=0.0, max_tokens=8)
            ls.load_adapter("fin", spec["adapter"])
            out["lora"] = _drain(ls, ls.add_request(spec["lora_prompt"], lsp, adapter="fin"))
            out["base"] = _drain(ls, ls.add_request(spec["lora_prompt"], lsp))
            out["unloaded"] = ls.unload_adapter("fin")
            out["apc"] = ls.generate(spec["apc_prompts"], lsp)
            out["apc_stats"] = dict(eng.prefix_stats)
            ls.shutdown()
            out["digest"] = ls.digest.hexdigest()
        else:
            digest = worker_loop(eng, digest=StreamDigest())
            out["digest"] = digest.hexdigest()
            out["apc_stats"] = dict(eng.prefix_stats)
        out["wq_columns"] = eng.params["layers"]["wq"].shape[-1]
        out["lora_b_columns"] = eng._lora["wq"]["B"].shape[-1]
        if "served" in spec:
            out["spmd"], out["spmd_embed"] = run_spmd(spec["served"], mesh)
        tmp = f"{out_path}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, out_path)
    finally:
        dist.destroy_process_group()


def run_diverged_load(rank: int, world: int, rendezvous: str, inputs_path: str,
                      out_path: str) -> None:
    """One rank of a world whose rank 1 fails the adapter load that rank 0
    broadcasts: rank 0 loads it and keeps serving requests (the second
    after rank 1 has had time to end), rank 1 runs worker_loop with its
    engine's load_adapter raising. Each writes the error that ended it
    (None if nothing did), then raises it again."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    error = None
    try:
        with open(inputs_path, "rb") as f:
            spec = pickle.load(f)
        cfg = tl.LlamaConfig(**spec["config"], dtype=torch.float32)
        eng = Engine("llama", cfg, params_from_numpy(spec["tree"]), device="cpu",
                     mesh=build_mesh(MeshConfig(tp=world)),
                     cfg=EngineConfig(cache_dtype=torch.float32, **spec["engine"]))
        lsp = SamplingParams(temperature=0.0, max_tokens=8)
        if rank == 0:
            ls = LockstepEngine(eng)
            ls.load_adapter("fin", spec["adapter"])
            _drain(ls, ls.add_request(spec["lora_prompt"], lsp, adapter="fin"))
            time.sleep(2.0)
            _drain(ls, ls.add_request(spec["lora_prompt"], lsp, adapter="fin"))
            ls.shutdown()
        else:
            def planted(name, weights):
                raise RuntimeError(f"planted: adapter {name} failed to load on rank 1")

            eng.load_adapter = planted
            worker_loop(eng)
    except Exception as e:  # noqa: BLE001 — written for the test, then raised
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        with open(out_path, "wb") as f:
            pickle.dump({"error": error}, f)
        dist.destroy_process_group()
