"""Gemma and Gemma-2 checkpoints with Hugging Face names for the port's
tests: random tensors drawn with numpy from a seed, written by
kubeai_tpu_torch.engine.weights.save_safetensors (no download, no
transformers)."""

import numpy as np
import torch

from kubeai_tpu_torch.engine.weights import save_safetensors


def hf_config(gemma2: bool, **overrides) -> dict:
    """A small config.json dict: Gemma2ForCausalLM with its softcaps,
    query scale and window, or GemmaForCausalLM."""
    cfg = {
        "architectures": ["Gemma2ForCausalLM" if gemma2 else "GemmaForCausalLM"],
        "model_type": "gemma2" if gemma2 else "gemma",
        "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 512,
    }
    if gemma2:
        cfg.update(sliding_window=8, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, query_pre_attn_scalar=16)
    cfg.update(overrides)
    return cfg


def write_gemma_checkpoint(path, cfg: dict, seed: int = 0,
                           dtype: torch.dtype = torch.bfloat16,
                           ascii_scale: float = 1.0) -> str:
    """`path`/model.safetensors and config.json for `cfg` (hf_config's
    keys). Projections are stored [out, in], as HF stores them; norms are
    zero-centred values near 0. `ascii_scale` multiplies the embedding's
    rows of the printable bytes (32-126): the logits are tied to it, so a
    large scale makes greedy picks bytes that ByteTokenizer decodes."""
    rng = np.random.default_rng(seed)
    E, M, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KVH, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    gemma2 = cfg["model_type"] == "gemma2"

    def rnd(*shape, scale=0.05):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(dtype)

    embed = rnd(V, E, scale=0.2)
    embed[32:127] *= ascii_scale
    tensors = {"model.embed_tokens.weight": embed, "model.norm.weight": rnd(E, scale=0.1)}
    norms = ["input_layernorm", "post_attention_layernorm"]
    if gemma2:
        norms += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name in norms:
            tensors[p + name + ".weight"] = rnd(E, scale=0.1)
        for name, shape in (("q_proj", (H * D, E)), ("k_proj", (KVH * D, E)),
                            ("v_proj", (KVH * D, E)), ("o_proj", (E, H * D))):
            tensors[f"{p}self_attn.{name}.weight"] = rnd(*shape)
        for name, shape in (("gate_proj", (M, E)), ("up_proj", (M, E)),
                            ("down_proj", (E, M))):
            tensors[f"{p}mlp.{name}.weight"] = rnd(*shape)
    save_safetensors(str(path), tensors, cfg)
    return str(path)
