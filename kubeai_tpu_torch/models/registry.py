"""Model-family registry: maps engine model ids and HF `architectures` to
implementations. Counterpart of kubeai_tpu/models/registry.py, with the
families this port serves: `llama` (also Mistral), `qwen` (the llama
computation with q/k/v biases), `gemma` (Gemma 1 and 2), `mixtral`
(Llama attention with a dense top-k mixture of experts) and `whisper`
(the SpeechToText feature: served by engine/whisper_server.py, not by
the slot engine, so it has no engine functions). Every family of the JAX
package's registry is here.
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
    # Logical sharding axes of each parameter (parallel/sharding.py); None
    # = the engine refuses the family under a mesh.
    param_specs: Callable | None = None
    # The slot engine's forwards (None for a family the engine does not
    # serve, as whisper).
    prefill: Callable | None = None
    # One decode step against the slot cache (engine/kvcache.py): the
    # engine's slot mode and a draft model's proposals.
    decode_step: Callable | None = None
    decode_step_paged: Callable | None = None
    # Multi-position verify forward for speculative decoding (None =
    # speculation unsupported for this family).
    decode_verify_paged: Callable | None = None
    # One staged chunk of prefill (None = chunked prefill and the prefix
    # cache unsupported for this family).
    prefill_chunk: Callable | None = None
    hf_architectures: tuple[str, ...] = ()
    # LoRA adapter buffers (None = the family takes no adapters; the
    # engine refuses them), the whole (in, out) of each target, and the
    # rank's part of an adapter under a mesh.
    init_lora_buffers: Callable | None = None
    lora_dims: Callable | None = None
    lora_shard: Callable | None = None
    # Whether whole-prompt prefill attends through flash_causal_prefill
    # (B2) for a config: the engine checks B2's head dims on the card then.
    prefill_uses_flash: Callable = lambda cfg: True
    # Mean-pooled embeddings (None = /v1/embeddings answers 400).
    hidden_states: Callable | None = None
    # Whether the family's forwards read int8 weight leaves
    # (EngineConfig.quantization="int8"); the engine refuses int8 weights
    # for any other (ROADMAP fault C15).
    int8_weights: bool = False
    # The catalog feature the family serves: "TextGeneration" (the slot
    # engine, plus TextEmbedding through hidden_states) or "SpeechToText".
    feature: str = "TextGeneration"


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
    from kubeai_tpu_torch.models import gemma, llama, mixtral, whisper

    register_model_family(
        ModelFamily(
            "llama",
            config_from_hf=llama.LlamaConfig.from_hf_dict,
            tiny_config=llama.LlamaConfig.tiny,
            init_params=llama.init_params,
            param_specs=llama.param_specs,
            prefill=llama.prefill,
            decode_step=llama.decode_step,
            decode_step_paged=llama.decode_step_paged,
            decode_verify_paged=llama.decode_verify_paged,
            prefill_chunk=llama.prefill_chunk,
            hf_architectures=("LlamaForCausalLM", "MistralForCausalLM"),
            init_lora_buffers=llama.init_lora_buffers,
            lora_dims=llama.lora_dims,
            lora_shard=llama.lora_shard,
            hidden_states=llama.hidden_states,
            int8_weights=True,
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
            param_specs=llama.param_specs,
            prefill=llama.prefill,
            decode_step=llama.decode_step,
            decode_step_paged=llama.decode_step_paged,
            decode_verify_paged=llama.decode_verify_paged,
            # The chunk carries the q/k/v biases too.
            prefill_chunk=llama.prefill_chunk,
            hf_architectures=("Qwen2ForCausalLM",),
            init_lora_buffers=llama.init_lora_buffers,
            lora_dims=llama.lora_dims,
            lora_shard=llama.lora_shard,
            hidden_states=llama.hidden_states,
            int8_weights=True,
        )
    )
    # No verify forward, as in the JAX package: speculate > 0 runs vanilla
    # decode and a draft model is refused. No adapters (ROADMAP fault C10)
    # and no int8 weights (ROADMAP fault C15).
    register_model_family(
        ModelFamily(
            "gemma",
            config_from_hf=gemma.GemmaConfig.from_hf_dict,
            tiny_config=gemma.GemmaConfig.tiny,
            init_params=gemma.init_params,
            param_specs=gemma.param_specs,
            prefill=gemma.prefill,
            decode_step=gemma.decode_step,
            decode_step_paged=gemma.decode_step_paged,
            prefill_chunk=gemma.prefill_chunk,
            hf_architectures=("GemmaForCausalLM", "Gemma2ForCausalLM"),
            prefill_uses_flash=gemma.prefill_uses_flash,
        )
    )
    # Llama attention and a dense top-k MoE. As gemma: no verify forward,
    # no adapters (C10), no int8 weights (C15), and no embedding forward.
    register_model_family(
        ModelFamily(
            "mixtral",
            config_from_hf=mixtral.MixtralConfig.from_hf_dict,
            tiny_config=mixtral.MixtralConfig.tiny,
            init_params=mixtral.init_params,
            param_specs=mixtral.param_specs,
            prefill=mixtral.prefill,
            decode_step=mixtral.decode_step,
            decode_step_paged=mixtral.decode_step_paged,
            prefill_chunk=mixtral.prefill_chunk,
            hf_architectures=("MixtralForCausalLM",),
        )
    )
    register_model_family(
        ModelFamily(
            "whisper",
            config_from_hf=whisper.WhisperConfig.from_hf_dict,
            tiny_config=whisper.WhisperConfig.tiny,
            init_params=whisper.init_params,
            hf_architectures=("WhisperForConditionalGeneration",),
            feature="SpeechToText",
        )
    )
    _LOADED = True
