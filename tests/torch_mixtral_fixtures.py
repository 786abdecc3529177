"""Mixtral for the port's tests: the tiny f32 model that both packages
run (`mixtral_models`), and checkpoints with Hugging Face names, random
tensors drawn with numpy from a seed and written by
kubeai_tpu_torch.engine.weights.save_safetensors (no download, no
transformers)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kubeai_tpu.models import mixtral as jm
from kubeai_tpu_torch.engine.weights import save_safetensors
from kubeai_tpu_torch.models import mixtral as tm
from kubeai_tpu_torch.parity import params_from_numpy


def port_config(jcfg) -> tm.MixtralConfig:
    """The port's f32 config with the JAX config's fields."""
    return tm.MixtralConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(jcfg) if f.name != "dtype"},
                            dtype=torch.float32)


def mixtral_models(seed: int = 0):
    """(JAX config, JAX params, port config, port params): the JAX
    `init_params` draw on `MixtralConfig.tiny()` in f32 with the router
    scaled to std 0.5, the experts to 0.1, wq and wk to 0.5 and the
    embedding to 0.2, so that the routing, the attention and the experts
    each move the output."""
    jcfg = dataclasses.replace(jm.MixtralConfig.tiny(vocab_size=512), dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jm.init_params(jcfg, jax.random.PRNGKey(seed)))
    for name, scale in (("router", 25), ("w_gate", 5), ("w_up", 5), ("w_down", 5),
                        ("wq", 25), ("wk", 25)):
        tree["layers"][name] = tree["layers"][name] * scale
    tree["embed"] = tree["embed"] * 10
    return jcfg, jax.tree.map(jnp.asarray, tree), port_config(jcfg), params_from_numpy(tree)


def hf_config(**overrides) -> dict:
    """A small MixtralForCausalLM config.json dict (MixtralConfig.tiny's
    widths)."""
    cfg = {
        "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
        "vocab_size": 512, "hidden_size": 64, "intermediate_size": 96,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_local_experts": 4, "num_experts_per_tok": 2, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5, "max_position_embeddings": 512,
    }
    cfg.update(overrides)
    return cfg


def write_mixtral_checkpoint(path, cfg: dict, seed: int = 0,
                             dtype: torch.dtype = torch.bfloat16) -> str:
    """`path`/model.safetensors and config.json for `cfg` (hf_config's
    keys). Projections are stored [out, in], as HF stores them: the
    router `block_sparse_moe.gate` [X, E], each expert's w1 and w3 [M, E]
    and w2 [E, M]; norms are values near 1."""
    rng = np.random.default_rng(seed)
    E, M, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KVH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    X, D = cfg["num_local_experts"], E // H

    def rnd(*shape, scale=0.05, mean=0.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale + mean
        return torch.from_numpy(a).to(dtype)

    tensors = {"model.embed_tokens.weight": rnd(V, E, scale=0.2),
               "model.norm.weight": rnd(E, scale=0.1, mean=1.0)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name in ("input_layernorm", "post_attention_layernorm"):
            tensors[p + name + ".weight"] = rnd(E, scale=0.1, mean=1.0)
        for name, shape in (("q_proj", (H * D, E)), ("k_proj", (KVH * D, E)),
                            ("v_proj", (KVH * D, E)), ("o_proj", (E, H * D))):
            tensors[f"{p}self_attn.{name}.weight"] = rnd(*shape)
        tensors[f"{p}block_sparse_moe.gate.weight"] = rnd(X, E, scale=0.5)
        for e in range(X):
            for name, shape in (("w1", (M, E)), ("w2", (E, M)), ("w3", (M, E))):
                tensors[f"{p}block_sparse_moe.experts.{e}.{name}.weight"] = rnd(*shape)
    tensors["lm_head.weight"] = rnd(V, E, scale=0.2)
    save_safetensors(str(path), tensors, cfg)
    return str(path)
