"""Llama-family decoder (Llama 2/3/3.1, Mistral, Qwen2 with q/k/v biases).
Counterpart of kubeai_tpu/models/llama.py: the whole-prompt `prefill`,
`prefill_chunk` (one staged chunk of a long or prefix-cached prompt),
`decode_step_paged` in both layouts ("per_layer" and "fused") and the
speculative verify forward `decode_verify_paged`.

Parameters are a plain dict with the JAX package's layout, so the tests
can hand the same weights to both packages (kubeai_tpu_torch.parity):

    {"embed": [V, E], "final_norm": [E], "lm_head": [V, E],
     "layers": {"input_norm": [NL, E], "wq": [NL, E, H*D], ...}}

Layers are stacked on a leading [NL] axis and walked with a Python loop
(the JAX version scans). Weights are bf16 (or f32 for the parity tests);
int8 weights, LoRA, ring-attention prefill and pipeline parallelism are
not ported and raise.

Prefill attention goes through ops.flash_attention.flash_causal_prefill
for every bucket (the CUDA kernel on the card); a staged chunk attends
through the plain ops.attention.chunked_prefill_attention, as the JAX
version's chunk does (plain jnp there, no Pallas kernel). Decode attention goes
through ops.paged_attention, once per layer per step:
paged_decode_attention ("per_layer"), paged_decode_attention_fused
("fused"), or paged_verify_attention for a speculative window. The
per_layer decode also takes int8 pools (ops/kv_quant.py): the new token
is quantized as it is scattered, before the attention reads it back, and
paged_decode_attention sends the pool to B1's int8 read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kubeai_tpu_torch.device import resolve_device
from kubeai_tpu_torch.ops.attention import chunked_prefill_attention
from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
from kubeai_tpu_torch.ops.kv_quant import QuantizedPool
from kubeai_tpu_torch.ops.norms import rms_norm
from kubeai_tpu_torch.ops.paged_attention import (
    batched_scatter_sequence,
    paged_decode_attention,
    paged_decode_attention_fused,
    paged_verify_attention,
    resolve_decode_kernel,
    scatter_decode_token,
    token_page_coords,
)
from kubeai_tpu_torch.ops.rope import (
    apply_rope,
    rope_attention_scaling,
    rope_frequencies,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int | None = None
    rope_theta: float = 500000.0
    rope_scaling: dict | None = None
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style q/k/v biases
    dtype: Any = torch.bfloat16

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @staticmethod
    def from_hf_dict(d: dict) -> "LlamaConfig":
        """Build from a HuggingFace config.json dict (architectures Llama*)."""
        return LlamaConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=d.get("head_dim"),
            rope_theta=d.get("rope_theta", 10000.0),
            rope_scaling=d.get("rope_scaling"),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            # Qwen2 always uses qkv biases; HF exposes attention_bias on
            # both configs (Qwen2 defaults true, Llama false).
            attention_bias=d.get(
                "attention_bias",
                d.get("model_type") == "qwen2",
            ),
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "LlamaConfig":
        """A test-sized config (runs in ms on CPU)."""
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            rope_theta=10000.0,
            max_position_embeddings=1024,
        )


def init_params(
    cfg: LlamaConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random init (for tests and benchmarks). Draws from `generator`,
    which must live on the target device (default: a generator on that
    device seeded with 0). The target device defaults to cuda."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    E, H, KVH, D, M, V, NL = (
        cfg.hidden_size,
        cfg.num_heads,
        cfg.num_kv_heads,
        cfg.head_size,
        cfg.intermediate_size,
        cfg.vocab_size,
        cfg.num_layers,
    )
    dt = cfg.dtype

    def rnd(shape, stacked: bool = False):
        # Stacked weights are drawn one layer at a time, so the f32 draw
        # never holds a whole [NL, ...] tensor.
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out if stacked else [out]):
            part.copy_(
                torch.randn(part.shape, generator=generator, device=dev) * 0.02
            )
        return out

    layers = {
        "input_norm": torch.ones((NL, E), dtype=dt, device=dev),
        "wq": rnd((NL, E, H * D), True),
        "wk": rnd((NL, E, KVH * D), True),
        "wv": rnd((NL, E, KVH * D), True),
        "wo": rnd((NL, H * D, E), True),
        "post_attn_norm": torch.ones((NL, E), dtype=dt, device=dev),
        "w_gate": rnd((NL, E, M), True),
        "w_up": rnd((NL, E, M), True),
        "w_down": rnd((NL, M, E), True),
    }
    if cfg.attention_bias:
        layers["bq"] = rnd((NL, H * D), True)
        layers["bk"] = torch.zeros((NL, KVH * D), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((NL, KVH * D), dtype=dt, device=dev)
    params = {
        "embed": rnd((V, E)),
        "layers": layers,
        "final_norm": torch.ones((E,), dtype=dt, device=dev),
        "lm_head": rnd((V, E)),
    }
    if cfg.tie_word_embeddings:
        params["lm_head"] = params["embed"]
    return params


_INV_FREQ: dict[tuple, torch.Tensor] = {}


def _rope_tables(cfg: LlamaConfig, device: torch.device) -> tuple[torch.Tensor, float]:
    """(inv_freq on `device`, YaRN mscale), cached per config and device."""
    key = (
        cfg.head_size, cfg.rope_theta, repr(cfg.rope_scaling),
        cfg.max_position_embeddings, str(device),
    )
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = torch.from_numpy(
            rope_frequencies(
                cfg.head_size, cfg.rope_theta, cfg.rope_scaling,
                cfg.max_position_embeddings,
            )
        ).to(device)
        _INV_FREQ[key] = inv
    return inv, rope_attention_scaling(cfg.rope_scaling)


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


def _refuse_unported(lora=None, lora_idx=None, mesh=None) -> None:
    if lora is not None or lora_idx is not None:
        raise NotImplementedError("LoRA is not ported yet (ROADMAP A11)")
    if mesh is not None:
        raise NotImplementedError(
            "ring-attention prefill over a mesh is not ported yet "
            "(ROADMAP A14)"
        )


def _check_weights(params: dict) -> None:
    if isinstance(params["layers"]["wq"], dict):
        raise NotImplementedError(
            "int8 weights are not ported yet (ROADMAP A12)"
        )


def _mlp(x, gate, up, down):
    return torch.matmul(F.silu(torch.matmul(x, gate)) * torch.matmul(x, up), down)


def _logits(x: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """[B, E] x [V, E] -> f32 [B, V]. On bf16 weights the product runs in
    bf16 and keeps its f32 accumulator as the output, as the JAX
    version's preferred_element_type=float32 does: on the card the GEMM
    writes f32 itself (torch.mm out_dtype); on the CPU the operands are
    upcast."""
    if x.dtype == torch.float32:
        return torch.matmul(x, lm_head.t())
    if x.is_cuda:
        return torch.mm(x, lm_head.t(), out_dtype=torch.float32)
    return torch.matmul(x.float(), lm_head.t().float())


def prefill(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] right-padded token ids
    lengths: torch.Tensor,  # [B] true prompt lengths
    lora: dict | None = None,
    lora_idx: torch.Tensor | None = None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt forward. Returns (last_token_logits f32 [B, V],
    k_all [NL, B, S, KVH, D], v_all [NL, B, S, KVH, D])."""
    _refuse_unported(lora, lora_idx, mesh)
    _check_weights(params)
    B, S = tokens.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    x = params["embed"][tokens]  # [B, S, E]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)

        def proj(h, w, bias=None):
            out = torch.matmul(h, w)
            return out if bias is None else out + bias

        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q = proj(h, lp["wq"], lp.get("bq")).reshape(B, S, H, D)
        k = proj(h, lp["wk"], lp.get("bk")).reshape(B, S, KVH, D)
        v = proj(h, lp["wv"], lp.get("bv")).reshape(B, S, KVH, D)
        q = apply_rope(q, positions, inv_freq, msc)
        k = apply_rope(k, positions, inv_freq, msc)
        attn = flash_causal_prefill(q, k, v.contiguous())
        x = x + proj(attn.reshape(B, S, H * D), lp["wo"])
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"])
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    # Logits only for each sequence's final real token.
    idx = torch.clamp(lengths.to(dev).long() - 1, 0, S - 1)
    last = x[torch.arange(B, device=dev), idx]  # [B, E]
    return _logits(last, params["lm_head"]), torch.stack(ks), torch.stack(vs)


def prefill_chunk(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [1, C] one chunk (right-padded on the last chunk)
    start: torch.Tensor,  # scalar: absolute position of tokens[:, 0]
    length: torch.Tensor,  # scalar: true total prompt length
    k_slot: torch.Tensor,  # [NL, L, KVH, D] one slot's staging cache
    v_slot: torch.Tensor,
    want_logits: bool = False,
    lora: dict | None = None,
    lora_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """One chunk of incremental prefill against one slot's cache. Every
    chunk of every prompt length has the same shapes, so one CUDA graph
    serves them all. Each layer writes the chunk's K/V at `start`, in
    place (like the JAX version's dynamic_update_slice, the write start
    is clamped so the chunk fits), then attends over the whole cache;
    stale entries past the causal frontier are masked by position.
    Returns (f32 [1, V] logits at position `length - 1` when want_logits,
    else None; k_slot; v_slot)."""
    _refuse_unported(lora, lora_idx)
    _check_weights(params)
    B, C = tokens.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    start = torch.as_tensor(start, device=dev).long().reshape(())
    length = torch.as_tensor(length, device=dev).long().reshape(())
    offs = torch.arange(C, device=dev)
    positions = (start + offs)[None, :]  # [1, C]
    rows = start.clamp(0, k_slot.shape[1] - C) + offs
    x = params["embed"][tokens]  # [1, C, E]
    for i in range(cfg.num_layers):
        lp = _layer(params, i)

        def proj(h, w, bias=None):
            out = torch.matmul(h, w)
            return out if bias is None else out + bias

        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q = proj(h, lp["wq"], lp.get("bq")).reshape(B, C, H, D)
        k = proj(h, lp["wk"], lp.get("bk")).reshape(B, C, KVH, D)
        v = proj(h, lp["wv"], lp.get("bv")).reshape(B, C, KVH, D)
        q = apply_rope(q, positions, inv_freq, msc)
        k = apply_rope(k, positions, inv_freq, msc)
        kc, vc = k_slot[i], v_slot[i]  # [L, KVH, D]
        kc.index_copy_(0, rows, k[0].to(kc.dtype))
        vc.index_copy_(0, rows, v[0].to(vc.dtype))
        attn = chunked_prefill_attention(q, kc[None], vc[None], start[None])
        x = x + proj(attn.reshape(B, C, H * D), lp["wo"])
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"])
    if not want_logits:
        return None, k_slot, v_slot
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    idx = torch.clamp(length - 1 - start, 0, C - 1)
    last = x.index_select(1, idx.reshape(1))[:, 0]  # [1, E]
    return _logits(last, params["lm_head"]), k_slot, v_slot


def _decode_layer_qkv(x, lp, cfg, inv_freq, msc, pos1):
    """Decode-layer front half: norm, QKV projection (+bias), rope.
    Returns (q [B, H, D], k [B, KVH, D], v [B, KVH, D], proj)."""
    B = x.shape[0]
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size

    def proj(h, w, bias=None):
        out = torch.matmul(h, w)
        return out if bias is None else out + bias

    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = proj(h, lp["wq"], lp.get("bq")).reshape(B, 1, H, D)
    k = proj(h, lp["wk"], lp.get("bk")).reshape(B, 1, KVH, D)
    v = proj(h, lp["wv"], lp.get("bv")).reshape(B, 1, KVH, D)
    q = apply_rope(q, pos1, inv_freq, msc)[:, 0]  # [B, H, D]
    k = apply_rope(k, pos1, inv_freq, msc)[:, 0]  # [B, KVH, D]
    return q, k, v[:, 0], proj


def _decode_layer_finish(x, attn, lp, proj, cfg):
    """Decode-layer back half: output projection, residual, MLP."""
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_size
    x = x + proj(attn.reshape(B, H * D), lp["wo"])
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"])


def _paged_decode_layer(
    x, lp, kp, vp, cfg, inv_freq, msc, positions, lengths,
    page_ids, offsets, block_tables,
):
    """One decode layer against this layer's page pools: project, rope,
    scatter the new token's K/V through the block tables (in place),
    attend over resident pages, MLP."""
    q, k, v, proj = _decode_layer_qkv(
        x, lp, cfg, inv_freq, msc, positions[:, None]
    )
    scatter_decode_token(kp, vp, k, v, page_ids, offsets)
    attn = paged_decode_attention(q.contiguous(), kp, vp, block_tables, lengths)
    return _decode_layer_finish(x, attn, lp, proj, cfg)


def decode_step_paged(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] one token per slot
    positions: torch.Tensor,  # [B] absolute position of each token
    k_pages: torch.Tensor | QuantizedPool,  # [NL, P, page, KVH, D] page pools
    v_pages: torch.Tensor | QuantizedPool,
    block_tables: torch.Tensor,  # [B, MP] int32 page ids per slot (-1 = free)
    lora: dict | None = None,
    lora_idx: torch.Tensor | None = None,
    *,
    attn_kernel: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step against the paged cache. Two layouts, selected by
    `attn_kernel` (None = $KUBEAI_TPU_DECODE_KERNEL, default "per_layer"):

    "per_layer" — each layer scatters its new token's K/V into its pool,
    then attends through paged_decode_attention. The only layout for an
    int8 pool: the token is quantized on its way in and read back
    dequantized, as in the JAX version.

    "fused" — each layer attends through paged_decode_attention_fused,
    which reads the layer's pages out of the stacked pool in place and
    takes the new token's K/V as an extra column; the new K/V of every
    layer are then written in one scatter after the layer loop.

    The pools are updated in place and returned (the JAX version returns
    new arrays)."""
    _refuse_unported(lora, lora_idx)
    _check_weights(params)
    attn_kernel = resolve_decode_kernel(attn_kernel)
    if isinstance(k_pages, QuantizedPool) and attn_kernel != "per_layer":
        raise ValueError(
            "quantized KV pools require attn_kernel='per_layer' (the "
            "fused kernel reads a raw bf16 pool)"
        )
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    page_size = k_pages.shape[2]
    x = params["embed"][tokens]  # [B, E]
    page_ids, offsets = token_page_coords(block_tables, positions, page_size)
    if attn_kernel == "per_layer":
        lengths = (positions + 1).to(torch.int32)
        for i in range(cfg.num_layers):
            x = _paged_decode_layer(
                x, _layer(params, i), k_pages[i], v_pages[i], cfg, inv_freq,
                msc, positions, lengths, page_ids, offsets, block_tables,
            )
    else:
        pos32 = positions.to(torch.int32)
        k_new, v_new = [], []
        for i in range(cfg.num_layers):
            lp = _layer(params, i)
            q, k, v, proj = _decode_layer_qkv(
                x, lp, cfg, inv_freq, msc, positions[:, None]
            )
            k, v = k.contiguous(), v.contiguous()
            attn = paged_decode_attention_fused(
                q.contiguous(), k_pages, v_pages, k, v, block_tables, pos32, i,
            )
            x = _decode_layer_finish(x, attn, lp, proj, cfg)
            k_new.append(k)
            v_new.append(v)
        # One write for every layer's new token ([NL, B, 1, KVH, D]).
        batched_scatter_sequence(
            k_pages, v_pages, torch.stack(k_new)[:, :, None],
            torch.stack(v_new)[:, :, None], page_ids[:, None], offsets[:, None],
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(x, params["lm_head"]), k_pages, v_pages


def _verify_page_coords(block_tables, positions, K, page_size):
    """Page coords of all K window positions per slot: ([B, K], [B, K])."""
    ids, offs = zip(*(
        token_page_coords(block_tables, positions + k, page_size)
        for k in range(K)
    ))
    return torch.stack(ids, 1), torch.stack(offs, 1)


def _paged_verify_layer(
    x, lp, kp, vp, cfg, inv_freq, msc, pos_k, page_ids, offsets,
    block_tables, positions,
):
    """One verify layer over a [B, K, E] window against this layer's page
    pools: project, rope, write the window's K/V through the block tables
    (in place), attend through paged_verify_attention, MLP."""
    B, K, _ = x.shape
    H, KVH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_size

    def proj(h, w, bias=None):
        out = torch.matmul(h, w)
        return out if bias is None else out + bias

    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = proj(h, lp["wq"], lp.get("bq")).reshape(B, K, H, D)
    k = proj(h, lp["wk"], lp.get("bk")).reshape(B, K, KVH, D)
    v = proj(h, lp["wv"], lp.get("bv")).reshape(B, K, KVH, D)
    q = apply_rope(q, pos_k, inv_freq, msc)
    k = apply_rope(k, pos_k, inv_freq, msc)
    kp[page_ids, offsets] = k.to(kp.dtype)
    vp[page_ids, offsets] = v.to(vp.dtype)
    attn = paged_verify_attention(q.contiguous(), kp, vp, block_tables, positions)
    x = x + proj(attn.reshape(B, K, H * D), lp["wo"])
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"])


def decode_verify_paged(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, K] last emitted token + K - 1 proposals
    positions: torch.Tensor,  # [B] absolute position of tokens[:, 0]
    k_pages: torch.Tensor,  # [NL, P, page, KVH, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MP] int32
    lora: dict | None = None,
    lora_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative verify: one forward over a K-token window per slot
    against the paged cache. Writes the window's K/V through the block
    tables (rejected tail positions hold K/V that the slot's position
    masks and later steps overwrite) and returns f32 logits for every
    window position, [B, K, V], so the engine can accept the longest
    matching proposal prefix. The pools are updated in place and
    returned."""
    _refuse_unported(lora, lora_idx)
    _check_weights(params)
    B, K = tokens.shape
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    page_size = k_pages.shape[2]
    pos_k = positions[:, None] + torch.arange(K, device=dev)[None, :]  # [B, K]
    x = params["embed"][tokens]  # [B, K, E]
    page_ids, offsets = _verify_page_coords(block_tables, positions, K, page_size)
    pos32 = positions.to(torch.int32)
    for i in range(cfg.num_layers):
        x = _paged_verify_layer(
            x, _layer(params, i), k_pages[i], v_pages[i], cfg, inv_freq, msc,
            pos_k, page_ids, offsets, block_tables, pos32,
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _logits(x.reshape(B * K, -1), params["lm_head"])
    return logits.reshape(B, K, -1), k_pages, v_pages
