"""PEFT adapter checkpoint loading to the stacked LoRA weight tree.
Counterpart of kubeai_tpu/engine/lora_weights.py.

HF PEFT layout: adapter_config.json {r, lora_alpha, target_modules} +
adapter_model.safetensors with per-layer tensors
  base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight [r, in]
  base_model.model.model.layers.{i}.self_attn.q_proj.lora_B.weight [out, r]
(or the same names without the `base_model.model.` prefix).

Output: {target: (A [NL, in, r], B [NL, r, out])} as f32 numpy arrays,
with the alpha/r scaling folded into B (the LoRA convention of
kubeai_tpu_torch.models.llama), what `Engine.load_adapter` takes. Layers
without the target get zeros. Tensors stored in bf16 or f16 are widened
to f32 by torch before numpy sees them (numpy has no bf16).
"""

from __future__ import annotations

import json
import os

import numpy as np

from kubeai_tpu_torch.engine.weights import (
    LazyTensors,
    WeightLoadError,
    resolve_model_dir,
)

_HF_TO_NATIVE = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
}


def load_peft_adapter(path_or_url: str, model_cfg, max_rank: int = 16) -> dict:
    adapter_dir = resolve_model_dir(path_or_url)
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    if not os.path.exists(cfg_path):
        raise WeightLoadError(f"no adapter_config.json in {adapter_dir}")
    with open(cfg_path) as f:
        acfg = json.load(f)
    r = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", r))
    scaling = alpha / r
    if r > max_rank:
        raise WeightLoadError(f"adapter rank {r} exceeds engine max {max_rank}")

    tensors = LazyTensors(adapter_dir)
    NL = model_cfg.num_layers

    out: dict = {}
    for hf_name, native in _HF_TO_NATIVE.items():
        a_list, b_list, found = [], [], False
        for i in range(NL):
            a_key = None
            for pattern in (
                f"base_model.model.model.layers.{i}.self_attn.{hf_name}.lora_A.weight",
                f"model.layers.{i}.self_attn.{hf_name}.lora_A.weight",
            ):
                if pattern in tensors:
                    a_key = pattern
                    break
            if a_key is None:
                a_list.append(None)
                b_list.append(None)
                continue
            found = True
            b_key = a_key.replace("lora_A", "lora_B")
            # LazyTensors returns f32 torch tensors (widened from bf16/f16).
            A = tensors[a_key].numpy().T  # [in, r]
            B = tensors[b_key].numpy().T * scaling  # [r, out]
            a_list.append(A)
            b_list.append(B)
        if not found:
            continue
        in_dim = next(a.shape[0] for a in a_list if a is not None)
        out_dim = next(b.shape[1] for b in b_list if b is not None)
        A_stack = np.stack(
            [a if a is not None else np.zeros((in_dim, r), np.float32)
             for a in a_list]
        )
        B_stack = np.stack(
            [b if b is not None else np.zeros((r, out_dim), np.float32)
             for b in b_list]
        )
        out[native] = (A_stack, B_stack)
    if not out:
        raise WeightLoadError(
            f"no supported LoRA targets found in {adapter_dir} "
            f"(supported: {sorted(_HF_TO_NATIVE)})"
        )
    return out
