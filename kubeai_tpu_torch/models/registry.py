"""Model-family registry: maps engine model ids and HF `architectures` to
implementations. Counterpart of kubeai_tpu/models/registry.py, with the
families this port serves: `llama` (also Mistral) and `qwen` (the llama
computation with q/k/v biases).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

_FAMILIES: dict[str, "ModelFamily"] = {}


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """A family bundle: config parser, param init, prefill/decode fns."""

    name: str
    config_from_hf: Callable
    tiny_config: Callable
    init_params: Callable
    prefill: Callable
    decode_step_paged: Callable
    # Multi-position verify forward for speculative decoding (None =
    # speculation unsupported for this family).
    decode_verify_paged: Callable | None = None
    hf_architectures: tuple[str, ...] = ()


def register_model_family(family: ModelFamily) -> ModelFamily:
    _FAMILIES[family.name] = family
    for arch in family.hf_architectures:
        _FAMILIES[arch] = family
    return family


def get_model_family(name: str) -> ModelFamily:
    _ensure_builtin()
    if name not in _FAMILIES:
        raise KeyError(
            f"unknown model family {name!r}; known: "
            f"{sorted(set(f.name for f in _FAMILIES.values()))}"
        )
    return _FAMILIES[name]


_LOADED = False


def _ensure_builtin() -> None:
    global _LOADED
    if _LOADED:
        return
    from kubeai_tpu_torch.models import llama

    register_model_family(
        ModelFamily(
            "llama",
            config_from_hf=llama.LlamaConfig.from_hf_dict,
            tiny_config=llama.LlamaConfig.tiny,
            init_params=llama.init_params,
            prefill=llama.prefill,
            decode_step_paged=llama.decode_step_paged,
            decode_verify_paged=llama.decode_verify_paged,
            hf_architectures=("LlamaForCausalLM", "MistralForCausalLM"),
        )
    )
    # Qwen2 is the Llama computation plus q/k/v biases — one
    # implementation, config-driven (attention_bias=True).
    register_model_family(
        ModelFamily(
            "qwen",
            config_from_hf=llama.LlamaConfig.from_hf_dict,
            tiny_config=lambda: dataclasses.replace(
                llama.LlamaConfig.tiny(), attention_bias=True
            ),
            init_params=llama.init_params,
            prefill=llama.prefill,
            decode_step_paged=llama.decode_step_paged,
            decode_verify_paged=llama.decode_verify_paged,
            hf_architectures=("Qwen2ForCausalLM",),
        )
    )
    _LOADED = True
