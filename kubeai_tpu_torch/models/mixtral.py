"""Mixtral-family decoder: Llama attention and a dense top-k mixture of
experts. Counterpart of kubeai_tpu/models/mixtral.py: the whole-prompt
`prefill`, `prefill_chunk` (one staged chunk of a long or prefix-cached
prompt), `decode_step` against the slot cache and `decode_step_paged` in
both layouts ("per_layer" and "fused", and per_layer on int8 pools).

The feed-forward block is the JAX version's dense dispatch (`_moe_ffn`):
every expert runs on every token, and the top-k softmax weights, rounded
to the activation dtype, zero the experts a token did not choose. Shapes
stay static, so the MoE runs inside the captured decode and staged-chunk
graphs: no `.nonzero()`, no host sync. The router's top-k is a stable
descending sort, so a tie picks the lower expert index first, as
`jax.lax.top_k` does (`torch.topk` promises no order for ties).

Parameters are a plain dict with the JAX package's keys:

    {"embed": [V, E], "final_norm": [E], "lm_head": [V, E],
     "layers": {"input_norm": [NL, E], "wq": [NL, E, H*D], "wk", "wv",
                "wo": [NL, H*D, E], "post_attn_norm": [NL, E],
                "router": [NL, E, X],
                "w_gate": [NL, E, X, M], "w_up": [NL, E, X, M],
                "w_down": [NL, X, M, E]}}

The gate and up stacks are expert-minor ([E, X, M] a layer, where the
JAX version stores [X, E, M]): a layer's gate product is then one GEMM
of the [T, E] tokens against the [E, X*M] view of the stack, and the
down product one `bmm` over X against [X, M, E]. No product permutes or
copies a weight (an einsum over the JAX layout would copy the 940 MB
stack at Mixtral-8x7B's width on every call). kubeai_tpu_torch.parity
and engine/weights.py's loader build this layout.

Attention is llama's: whole-prompt prefill through
ops.flash_attention.flash_causal_prefill (B2 on the card), a staged
chunk through the plain ops.attention.chunked_prefill_attention, the
slot-cache step through the plain decode_attention (as the JAX version's
jnp), paged decode through paged_decode_attention (B1, or B1-int8 on an
int8 pool) or paged_decode_attention_fused (B4).

Expert parallelism, as the JAX version shards it (`param_specs`: the
expert axis on the tp mesh dim; attention and the router as in llama):
`prefill`, `prefill_chunk` and `decode_step_paged` take `tp` (a
parallel.collectives.TensorParallel) with the rank's shard of the params.
Attention runs at the rank's heads with an all_reduce after `wo`, the
router stays whole, and each rank combines its E / tp experts' outputs
with their top-k weights before one all_reduce. The expert cut of the
expert-minor gate and up stacks is along their axis 2, made contiguous
once at load (parallel.sharding.shard_params).

Not here, as in the JAX package: a verify forward (speculation falls back
to vanilla decode and a draft model is refused), LoRA (the JAX family
takes adapters and ignores them; the port's engine refuses them, ROADMAP
fault C10), int8 weights (the JAX forward reads no quantized leaf; the
port's engine refuses them, fault C15) and an embedding forward.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kubeai_tpu_torch.device import resolve_device
from kubeai_tpu_torch.models.gemma import _inv_freq
from kubeai_tpu_torch.models.llama import _heads, _layer, _logits
from kubeai_tpu_torch.ops.attention import chunked_prefill_attention, decode_attention
from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
from kubeai_tpu_torch.ops.kv_quant import QuantizedPool
from kubeai_tpu_torch.ops.norms import rms_norm
from kubeai_tpu_torch.ops.paged_attention import (
    batched_scatter_sequence,
    paged_decode_attention,
    paged_decode_attention_fused,
    resolve_decode_kernel,
    scatter_decode_token,
    token_page_coords,
)
from kubeai_tpu_torch.ops.rope import apply_rope
from kubeai_tpu_torch.parallel import sharding as sh
from kubeai_tpu_torch.parallel.collectives import all_reduce, embed


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    num_experts: int = 8
    num_experts_per_tok: int = 2
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 32768
    dtype: Any = torch.bfloat16

    @property
    def head_size(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def from_hf_dict(d: dict) -> "MixtralConfig":
        """Build from a HuggingFace config.json dict (MixtralForCausalLM)."""
        return MixtralConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", 8),
            num_experts=d.get("num_local_experts", 8),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            rope_theta=d.get("rope_theta", 1e6),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            max_position_embeddings=d.get("max_position_embeddings", 32768),
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "MixtralConfig":
        """A test-sized config (runs in ms on CPU)."""
        return MixtralConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=96,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            num_experts=4,
            num_experts_per_tok=2,
            rope_theta=10000.0,
        )


def param_specs(cfg: MixtralConfig) -> dict:
    """Logical sharding axes per parameter: the JAX version's table, with
    the gate and up stacks' expert and embed axes swapped as the port
    stores them (expert-minor)."""
    L = None
    return {
        "embed": (sh.VOCAB, sh.EMBED),
        "layers": {
            "input_norm": (L, sh.EMBED),
            "wq": (L, sh.EMBED, sh.HEADS),
            "wk": (L, sh.EMBED, sh.KV_HEADS),
            "wv": (L, sh.EMBED, sh.KV_HEADS),
            "wo": (L, sh.HEADS, sh.EMBED),
            "post_attn_norm": (L, sh.EMBED),
            "router": (L, sh.EMBED, None),
            # Expert axis sharded over the mesh (EP = tp axis reuse).
            "w_gate": (L, sh.EMBED, sh.EXPERT, None),
            "w_up": (L, sh.EMBED, sh.EXPERT, None),
            "w_down": (L, sh.EXPERT, None, sh.EMBED),
        },
        "final_norm": (sh.EMBED,),
        "lm_head": (sh.VOCAB, sh.EMBED),
    }


def init_params(
    cfg: MixtralConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random init (for tests and benchmarks), N(0, 0.02) weights and norms
    at 1. Draws from `generator`, which must live on the target device
    (default: a generator on that device seeded with 0). The target
    device defaults to cuda."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    E, H, KVH, D, M, V, NL, X = (
        cfg.hidden_size,
        cfg.num_heads,
        cfg.num_kv_heads,
        cfg.head_size,
        cfg.intermediate_size,
        cfg.vocab_size,
        cfg.num_layers,
        cfg.num_experts,
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

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    return {
        "embed": rnd((V, E)),
        "layers": {
            "input_norm": ones(NL, E),
            "wq": rnd((NL, E, H * D), True),
            "wk": rnd((NL, E, KVH * D), True),
            "wv": rnd((NL, E, KVH * D), True),
            "wo": rnd((NL, H * D, E), True),
            "post_attn_norm": ones(NL, E),
            "router": rnd((NL, E, X), True),
            "w_gate": rnd((NL, E, X, M), True),
            "w_up": rnd((NL, E, X, M), True),
            "w_down": rnd((NL, X, M, E), True),
        },
        "final_norm": ones(E),
        "lm_head": rnd((V, E)),
    }


def top_k_stable(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, the
    lower index first among equal values (jax.lax.top_k's order), on
    every device."""
    values, indices = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _moe_ffn(x: torch.Tensor, lp: dict, cfg: MixtralConfig, tp=None) -> torch.Tensor:
    """x: [..., E] -> [..., E]. Dense top-k MoE: the router's logits in
    f32 (a product in the activation dtype, then cast), a softmax over
    the selected experts' logits, scattered into a dense [T, X] weight
    map; every expert's SwiGLU FFN on every token; the combine weighted by
    that map in the activation dtype. Under tp the rank runs its own
    experts (the stacks' X is E / tp), combines them with their columns
    of the map, and the ranks' combines are summed."""
    lead, E = x.shape[:-1], x.shape[-1]
    X, M = lp["w_down"].shape[0], cfg.intermediate_size
    h = x.reshape(-1, E)  # [T, E]
    router_logits = torch.matmul(h, lp["router"]).float()  # [T, experts]
    topv, topi = top_k_stable(router_logits, cfg.num_experts_per_tok)
    probs = torch.softmax(topv, dim=-1)  # normalized over the selected only
    weights = torch.zeros_like(router_logits).scatter_(-1, topi, probs)
    if tp is not None:
        weights = weights[:, tp.rank * X:(tp.rank + 1) * X]
    # One GEMM a stack over the [E, X*M] view, then one bmm over X.
    g = F.silu(torch.matmul(h, lp["w_gate"].reshape(E, X * M)))
    u = torch.matmul(h, lp["w_up"].reshape(E, X * M))
    gu = (g * u).reshape(-1, X, M).transpose(0, 1)  # [X, T, M]
    y = torch.bmm(gu, lp["w_down"])  # [X, T, E]
    out = torch.bmm(weights.to(y.dtype)[:, None], y.transpose(0, 1))[:, 0]  # [T, E]
    return all_reduce(out, tp).reshape(*lead, E)


def _qkv(x, lp, cfg, positions, inv_freq, tp=None):
    """Norm, projections and rope of [..., S, E] activations: (q [..., S,
    H, D], k [..., S, KVH, D], v [..., S, KVH, D]) at the rank's heads."""
    lead = x.shape[:-1]
    H, KVH, D = _heads(cfg, tp)
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = torch.matmul(h, lp["wq"]).reshape(*lead, H, D)
    k = torch.matmul(h, lp["wk"]).reshape(*lead, KVH, D)
    v = torch.matmul(h, lp["wv"]).reshape(*lead, KVH, D)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _finish(x, attn, lp, cfg, tp=None):
    """Output projection, the residual, the MoE FFN. attn: [..., H, D]."""
    x = x + all_reduce(torch.matmul(attn.reshape(*attn.shape[:-2], -1), lp["wo"]), tp)
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _moe_ffn(h2, lp, cfg, tp)


def _final_logits(x, params, cfg, tp=None):
    """[B, E] -> f32 [B, V]: the final norm, the head with f32 output."""
    return _logits(rms_norm(x, params["final_norm"], cfg.rms_norm_eps), params["lm_head"], tp)


def prefill(
    params: dict,
    cfg: MixtralConfig,
    tokens: torch.Tensor,  # [B, S] right-padded token ids
    lengths: torch.Tensor,  # [B] true prompt lengths
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt forward. Returns (last_token_logits f32 [B, V],
    k_all [NL, B, S, KVH, D], v_all [NL, B, S, KVH, D])."""
    B, S = tokens.shape
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    x = embed(params["embed"], tokens, tp)  # [B, S, E]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(x, lp, cfg, positions, inv_freq, tp)
        attn = flash_causal_prefill(q, k, v.contiguous())
        x = _finish(x, attn, lp, cfg, tp)
        ks.append(k)
        vs.append(v)
    idx = torch.clamp(lengths.to(dev).long() - 1, 0, S - 1)
    last = x[torch.arange(B, device=dev), idx]  # [B, E]
    return _final_logits(last, params, cfg, tp), torch.stack(ks), torch.stack(vs)


def prefill_chunk(
    params: dict,
    cfg: MixtralConfig,
    tokens: torch.Tensor,  # [1, C] one chunk (right-padded on the last chunk)
    start: torch.Tensor,  # scalar: absolute position of tokens[:, 0]
    length: torch.Tensor,  # scalar: true total prompt length
    k_slot: torch.Tensor,  # [NL, L, KVH, D] one slot's staging cache
    v_slot: torch.Tensor,
    want_logits: bool = False,
    tp=None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """One chunk of incremental prefill against one slot's cache, as
    llama.prefill_chunk (the chunk's K/V written at `start` in place, the
    write start clamped so the chunk fits; attention over the whole
    cache, masked by position), with the MoE FFN. Returns (f32 [1, V]
    logits at position `length - 1` when want_logits, else None; k_slot;
    v_slot)."""
    B, C = tokens.shape
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    start = torch.as_tensor(start, device=dev).long().reshape(())
    length = torch.as_tensor(length, device=dev).long().reshape(())
    offs = torch.arange(C, device=dev)
    positions = (start + offs)[None, :]  # [1, C]
    rows = start.clamp(0, k_slot.shape[1] - C) + offs
    x = embed(params["embed"], tokens, tp)  # [1, C, E]
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(x, lp, cfg, positions, inv_freq, tp)
        kc, vc = k_slot[i], v_slot[i]  # [L, KVH, D]
        kc.index_copy_(0, rows, k[0].to(kc.dtype))
        vc.index_copy_(0, rows, v[0].to(vc.dtype))
        attn = chunked_prefill_attention(q, kc[None], vc[None], start[None])
        x = _finish(x, attn, lp, cfg, tp)
    if not want_logits:
        return None, k_slot, v_slot
    idx = torch.clamp(length - 1 - start, 0, C - 1)
    last = x.index_select(1, idx.reshape(1))[:, 0]  # [1, E]
    return _final_logits(last, params, cfg, tp), k_slot, v_slot


def decode_step(
    params: dict,
    cfg: MixtralConfig,
    tokens: torch.Tensor,  # [B] one token per slot
    positions: torch.Tensor,  # [B] absolute position of each token
    k_cache: torch.Tensor,  # [NL, B, L, KVH, D] slot cache (engine/kvcache.py)
    v_cache: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for every slot against the slot cache, as
    llama.decode_step (the new token's K/V written into its slot row in
    place, then the plain decode_attention over the row), with the MoE
    FFN. Returns (f32 logits [B, V], k_cache, v_cache)."""
    B = tokens.shape[0]
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    x = params["embed"][tokens]  # [B, E]
    lengths = positions + 1
    slot_idx = torch.arange(B, device=dev)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(x[:, None], lp, cfg, positions[:, None], inv_freq)
        kc, vc = k_cache[i], v_cache[i]  # [B, L, KVH, D]
        kc[slot_idx, positions] = k[:, 0].to(kc.dtype)
        vc[slot_idx, positions] = v[:, 0].to(vc.dtype)
        attn = decode_attention(q[:, 0], kc, vc, lengths)
        x = _finish(x, attn, lp, cfg)
    return _final_logits(x, params, cfg), k_cache, v_cache


def decode_step_paged(
    params: dict,
    cfg: MixtralConfig,
    tokens: torch.Tensor,  # [B] one token per slot
    positions: torch.Tensor,  # [B] absolute position of each token
    k_pages: torch.Tensor | QuantizedPool,  # [NL, P, page, KVH, D] page pools
    v_pages: torch.Tensor | QuantizedPool,
    block_tables: torch.Tensor,  # [B, MP] int32 page ids per slot (-1 = free)
    *,
    attn_kernel: str | None = None,
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode step against the paged cache, in llama.decode_step_paged's
    two layouts: "per_layer" scatters each layer's new token, then
    attends through paged_decode_attention (the only layout for an int8
    pool); "fused" attends through paged_decode_attention_fused and
    writes every layer's new token in one scatter after the layer loop.
    The MoE FFN follows the attention in both. The pools are updated in
    place and returned."""
    attn_kernel = resolve_decode_kernel(attn_kernel)
    if isinstance(k_pages, QuantizedPool) and attn_kernel != "per_layer":
        raise ValueError(
            "quantized KV pools require attn_kernel='per_layer' (the "
            "fused kernel reads a raw bf16 pool)"
        )
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    x = embed(params["embed"], tokens, tp)  # [B, E]
    pos1 = positions[:, None]
    page_ids, offsets = token_page_coords(block_tables, positions, k_pages.shape[2])
    fused = attn_kernel == "fused"
    lengths = (positions + 1).to(torch.int32)
    pos32 = positions.to(torch.int32)
    k_new, v_new = [], []
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v = _qkv(x[:, None], lp, cfg, pos1, inv_freq, tp)
        q, k, v = q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous()
        if fused:
            attn = paged_decode_attention_fused(
                q, k_pages, v_pages, k, v, block_tables, pos32, i,
            )
            k_new.append(k)
            v_new.append(v)
        else:
            kp, vp = k_pages[i], v_pages[i]
            scatter_decode_token(kp, vp, k, v, page_ids, offsets)
            attn = paged_decode_attention(q, kp, vp, block_tables, lengths)
        x = _finish(x, attn, lp, cfg, tp)
    if fused:
        # One write for every layer's new token ([NL, B, 1, KVH, D]).
        batched_scatter_sequence(
            k_pages, v_pages, torch.stack(k_new)[:, :, None],
            torch.stack(v_new)[:, :, None], page_ids[:, None], offsets[:, None],
        )
    return _final_logits(x, params, cfg, tp), k_pages, v_pages
