"""Rotary position embeddings (RoPE), including Llama-3 frequency scaling.
Counterpart of kubeai_tpu/ops/rope.py.

The frequency code is numpy and is copied from the JAX package unchanged
(`rope_frequencies`, `rope_attention_scaling`); `apply_rope` is PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    theta: float = 500000.0,
    scaling: dict | None = None,
    max_position_embeddings: int | None = None,
) -> np.ndarray:
    """Per-pair inverse frequencies with optional context-extension
    scaling. `scaling` mirrors HF `rope_scaling`; supported rope_type:

      llama3  — banded rescale (Llama 3.1+)
      linear  — uniform position interpolation (inv_freq / factor)
      dynamic — NTK-aware theta rescale at the serving context length
      yarn    — banded NTK-by-parts (Qwen/DeepSeek long-context); its
                attention temperature rides `rope_attention_scaling`

    `max_position_embeddings` is the model config's context length — HF
    reads the pre-extension length from there when rope_scaling omits
    original_max_position_embeddings (dynamic/yarn). HF's "dynamic"
    grows with the running sequence; a serving engine compiles static
    shapes, so it is applied once at the extended context
    (original * factor) — exact for sequences that reach it,
    conservative below.
    """
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    rope_type = (scaling or {}).get(
        "rope_type", (scaling or {}).get("type", "")
    )
    if rope_type == "llama3":
        factor = scaling["factor"]
        low = scaling["low_freq_factor"]
        high = scaling["high_freq_factor"]
        orig = scaling["original_max_position_embeddings"]
        wavelen = 2 * np.pi / inv_freq
        smooth = (orig / wavelen - low) / (high - low)
        mid = (1 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(
            wavelen > orig / low,  # low-frequency band: fully rescaled
            inv_freq / factor,
            np.where(wavelen < orig / high, inv_freq, mid),
        )
    elif rope_type == "linear":
        inv_freq = inv_freq / scaling["factor"]
    elif rope_type == "dynamic":
        factor = scaling["factor"]
        orig = scaling.get(
            "original_max_position_embeddings", max_position_embeddings
        )
        if orig is None:
            raise ValueError(
                "dynamic rope_scaling needs original_max_position_embeddings "
                "or the model's max_position_embeddings"
            )
        max_pos = scaling.get("max_position_embeddings") or int(orig * factor)
        if max_pos > orig:
            # NTK-aware base rescale at the target length (HF dynamic
            # formula with seq_len = serving context).
            base = theta * (
                factor * max_pos / orig - (factor - 1)
            ) ** (head_dim / (head_dim - 2))
            inv_freq = 1.0 / (
                base
                ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
            )
    elif rope_type == "yarn":
        factor = scaling["factor"]
        orig = scaling.get(
            "original_max_position_embeddings", max_position_embeddings
        )
        if orig is None:
            raise ValueError(
                "yarn rope_scaling needs original_max_position_embeddings "
                "or the model's max_position_embeddings"
            )
        beta_fast = scaling.get("beta_fast", 32.0)
        beta_slow = scaling.get("beta_slow", 1.0)

        def find_dim(num_rot):
            return (
                head_dim
                * np.log(orig / (num_rot * 2 * np.pi))
            ) / (2 * np.log(theta))

        low = max(np.floor(find_dim(beta_fast)), 0)
        high = min(np.ceil(find_dim(beta_slow)), head_dim - 1)
        dims = np.arange(0, head_dim, 2, dtype=np.float64) / 2
        ramp = np.clip((dims - low) / max(high - low, 1e-3), 0, 1)
        extrap = 1 - ramp  # 1 = keep original freq (fast dims)
        inv_freq = inv_freq / factor * (1 - extrap) + inv_freq * extrap
    elif rope_type and rope_type != "default":
        # "default" is HF's explicit no-scaling marker.
        raise ValueError(f"unsupported rope_scaling type {rope_type!r}")
    return inv_freq.astype(np.float32)


def rope_attention_scaling(scaling: dict | None) -> float:
    """YaRN attention temperature: cos/sin are scaled by this factor
    (HF convention — logits end up scaled by its square). 1.0 for every
    other rope type. Mirrors transformers' _compute_yarn_parameters:
    explicit attention_factor wins; DeepSeek-style mscale/mscale_all_dim
    use get_mscale(factor, m)/get_mscale(factor, m_all); otherwise
    0.1*ln(factor)+1, with factor <= 1 clamped to 1.0."""
    rope_type = (scaling or {}).get(
        "rope_type", (scaling or {}).get("type", "")
    )
    if rope_type != "yarn":
        return 1.0
    if scaling.get("attention_factor") is not None:
        return float(scaling["attention_factor"])
    factor = float(scaling["factor"])

    def get_mscale(scale: float, m: float = 1.0) -> float:
        if scale <= 1.0:
            return 1.0
        return 0.1 * m * np.log(scale) + 1.0

    mscale = scaling.get("mscale")
    if mscale is not None:
        return float(
            get_mscale(factor, float(mscale))
            / get_mscale(factor, float(scaling.get("mscale_all_dim", 0.0)))
        )
    return float(get_mscale(factor))


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    mscale: float = 1.0,  # YaRN attention scaling (rope_attention_scaling)
) -> torch.Tensor:
    """Rotate q or k. x: [..., seq, heads, head_dim]; positions: [..., seq];
    inv_freq: [head_dim // 2] float32 on x's device."""
    angles = positions[..., :, None].float() * inv_freq  # [..., S, D/2]
    cos = torch.cos(angles)[..., :, None, :] * mscale  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., :, None, :] * mscale
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
