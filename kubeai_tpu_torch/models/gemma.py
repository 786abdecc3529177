"""Gemma-family decoder (Gemma 1 and 2). Counterpart of
kubeai_tpu/models/gemma.py: the whole-prompt `prefill`, `prefill_chunk`
(one staged chunk of a long or prefix-cached prompt), `decode_step`
against the slot cache (the engine's slot mode) and `decode_step_paged`
in both layouts ("per_layer" and "fused").

What differs from llama, all from the config:
  - the embedding is scaled by sqrt(hidden_size), in f32, then cast back
    to the embedding's dtype (the JAX version's order, not HF's bf16
    normalizer);
  - RMSNorm weights are zero-centred: the scale is 1 + w;
  - a GeGLU MLP (tanh-approximate gelu on the gate);
  - a head_dim of its own (256 in every Gemma of the catalog);
  - logits tied to the embedding;
  - Gemma-2: norms before and after both attention and the MLP
    (`sandwich_norms`), tanh softcaps on the attention logits and on the
    final logits, a query scale from `query_pre_attn_scalar`, and a
    sliding window on alternate layers (`layer_windows`).

Parameters are a plain dict with the JAX package's layout, so the tests
hand the same weights to both packages (kubeai_tpu_torch.parity):

    {"embed": [V, E], "final_norm": [E],
     "layers": {"input_norm": [NL, E], "wq": [NL, E, H*D], ...,
                "pre_mlp_norm": [NL, E],
                Gemma-2: "post_attn_norm", "post_mlp_norm": [NL, E]}}

Attention: Gemma-1's prefill goes through ops.flash_attention
.flash_causal_prefill (B2, which has a head_dim-256 build on the card).
Gemma-2's prefill and every staged chunk attend through the plain
ops.attention functions, which carry the softcap and the window, as the
JAX version branches, and so does the slot-cache `decode_step` (the
plain decode_attention, as the JAX version's jnp). Paged decode
attention goes through paged_decode_attention (B1, "per_layer") or
paged_decode_attention_fused (B4, "fused") with the layer's softcap and
window: the layer loop is Python, so each layer passes its window as
the int the wrappers take and a captured graph bakes it in. Int8 pools run per_layer only, as in the
JAX version.

Tensor parallelism: `param_specs` gives each leaf's logical axes (the
JAX version's table), and `prefill`, `prefill_chunk` and both layouts of
`decode_step_paged` take `tp` (a parallel.collectives.TensorParallel)
with the rank's shard of the params, as llama's do: the layer runs at
the rank's heads and KV heads (one KV head, the one its q heads read,
where tp exceeds the KV heads), its MLP columns and its vocabulary block
of the tied embedding, which serves as the embedding table (an
all_reduce, then the sqrt(E) scale) and as the lm_head block (its
logits all gathered, then the final softcap). The all_reduce after `wo`
and after `w_down` comes before Gemma-2's post norms: they normalize the
whole product, not a rank's partial sum. The query scale, the windows
and the softcaps do not change with tp. The slot-cache `decode_step`
takes no `tp`: the engine refuses the slot cache under a mesh.

Not here: a verify forward (the JAX family has none: speculation falls
back to vanilla decode, and a draft model is refused) and LoRA (the JAX
family takes adapters and ignores them; the port's engine refuses them,
ROADMAP fault C10) and int8 weights (the JAX engine quantizes gemma's
layer weights, and its forwards then fail on the first admission: they
read no quantized leaf; the port's engine refuses quantization="int8" for
this family at construction, models/registry.py's `int8_weights`, ROADMAP
fault C15).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from kubeai_tpu_torch.device import resolve_device
from kubeai_tpu_torch.models.llama import _heads, _logits
from kubeai_tpu_torch.ops.attention import (
    causal_prefill_attention,
    chunked_prefill_attention,
    decode_attention,
)
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
from kubeai_tpu_torch.ops.rope import apply_rope, rope_frequencies
from kubeai_tpu_torch.parallel import sharding as sh
from kubeai_tpu_torch.parallel.collectives import all_reduce, embed


@dataclasses.dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256000
    hidden_size: int = 2048
    intermediate_size: int = 16384
    num_layers: int = 18
    num_heads: int = 8
    num_kv_heads: int = 1
    head_dim: int = 256
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 8192
    # Gemma-2 extras
    sandwich_norms: bool = False  # pre+post norms (gemma2)
    final_logit_softcapping: float | None = None
    attn_logit_softcapping: float | None = None
    query_pre_attn_scalar: float | None = None
    # Gemma-2 alternates sliding-window (even layers) and global (odd
    # layers) attention; None = all-global (Gemma 1). `layer_types`
    # ("sliding_attention" / "full_attention" per layer, as HF writes it)
    # overrides the alternation.
    sliding_window: int | None = None
    layer_types: tuple[str, ...] | None = None
    dtype: Any = torch.bfloat16

    def layer_windows(self) -> list[int]:
        """Each layer's window as a Python int, 0 = global (the attention
        functions and kernels take a window <= 0 as none)."""
        if self.sliding_window is None:
            return [0] * self.num_layers
        if self.layer_types is not None:
            sliding = [t == "sliding_attention" for t in self.layer_types]
        else:
            sliding = [i % 2 == 0 for i in range(self.num_layers)]
        return [self.sliding_window if s else 0 for s in sliding]

    @property
    def head_size(self) -> int:
        return self.head_dim

    @staticmethod
    def from_hf_dict(d: dict) -> "GemmaConfig":
        """Build from a HuggingFace config.json dict (GemmaForCausalLM or
        Gemma2ForCausalLM)."""
        is_g2 = d.get("model_type") == "gemma2" or "Gemma2" in str(
            d.get("architectures")
        )
        return GemmaConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", 1),
            head_dim=d.get("head_dim", 256),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            max_position_embeddings=d.get("max_position_embeddings", 8192),
            sandwich_norms=is_g2,
            final_logit_softcapping=d.get("final_logit_softcapping"),
            attn_logit_softcapping=d.get("attn_logit_softcapping"),
            query_pre_attn_scalar=d.get("query_pre_attn_scalar"),
            sliding_window=d.get("sliding_window") if is_g2 else None,
            layer_types=tuple(d["layer_types"]) if d.get("layer_types") else None,
        )

    @staticmethod
    def tiny(vocab_size: int = 512) -> "GemmaConfig":
        """A test-sized Gemma-1 config (runs in ms on CPU)."""
        return GemmaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
        )


def param_specs(cfg: GemmaConfig) -> dict:
    """Logical sharding axes per parameter, the JAX version's table: the
    stacked-layer axis is never sharded, and the tied embedding is cut
    over the vocabulary."""
    L = None
    layers = {
        "input_norm": (L, sh.EMBED),
        "wq": (L, sh.EMBED, sh.HEADS),
        "wk": (L, sh.EMBED, sh.KV_HEADS),
        "wv": (L, sh.EMBED, sh.KV_HEADS),
        "wo": (L, sh.HEADS, sh.EMBED),
        "pre_mlp_norm": (L, sh.EMBED),
        "w_gate": (L, sh.EMBED, sh.MLP),
        "w_up": (L, sh.EMBED, sh.MLP),
        "w_down": (L, sh.MLP, sh.EMBED),
    }
    if cfg.sandwich_norms:
        layers["post_attn_norm"] = (L, sh.EMBED)
        layers["post_mlp_norm"] = (L, sh.EMBED)
    return {
        "embed": (sh.VOCAB, sh.EMBED),
        "layers": layers,
        "final_norm": (sh.EMBED,),
    }


def init_params(
    cfg: GemmaConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random init (for tests and benchmarks), norms at zero (a scale of
    1). Draws from `generator`, which must live on the target device
    (default: a generator on that device seeded with 0). The target
    device defaults to cuda."""
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

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    layers = {
        "input_norm": zeros(NL, E),
        "wq": rnd((NL, E, H * D), True),
        "wk": rnd((NL, E, KVH * D), True),
        "wv": rnd((NL, E, KVH * D), True),
        "wo": rnd((NL, H * D, E), True),
        "pre_mlp_norm": zeros(NL, E),
        "w_gate": rnd((NL, E, M), True),
        "w_up": rnd((NL, E, M), True),
        "w_down": rnd((NL, M, E), True),
    }
    if cfg.sandwich_norms:
        layers["post_attn_norm"] = zeros(NL, E)
        layers["post_mlp_norm"] = zeros(NL, E)
    return {"embed": rnd((V, E)), "layers": layers, "final_norm": zeros(E)}


def prefill_uses_flash(cfg: GemmaConfig) -> bool:
    """Whether whole-prompt prefill attends through flash_causal_prefill
    (B2): Gemma-1. A softcap or a window takes the plain path, which
    carries both."""
    return cfg.attn_logit_softcapping is None and not cfg.sliding_window


_INV_FREQ: dict[tuple, torch.Tensor] = {}


def _inv_freq(cfg: GemmaConfig, device: torch.device) -> torch.Tensor:
    key = (cfg.head_size, cfg.rope_theta, str(device))
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = torch.from_numpy(rope_frequencies(cfg.head_size, cfg.rope_theta)).to(device)
        _INV_FREQ[key] = inv
    return inv


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


def _norm(x, w, eps):
    # Gemma stores zero-centred norm weights: scale = 1 + w.
    return rms_norm(x, 1.0 + w.float(), eps)


def _softcap(x, cap):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def _mlp(x, gate, up, down, tp=None):
    g = F.gelu(torch.matmul(x, gate), approximate="tanh")
    return all_reduce(torch.matmul(g * torch.matmul(x, up), down), tp)


def _q_scale(cfg: GemmaConfig) -> float:
    if cfg.query_pre_attn_scalar is not None:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.head_size ** -0.5


def _embed(params: dict, cfg: GemmaConfig, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """The scaled embedding: the rows (under tp, summed from the ranks'
    vocabulary blocks), the product in f32, then the embedding's dtype."""
    x = embed(params["embed"], tokens, tp).float() * (cfg.hidden_size ** 0.5)
    return x.to(params["embed"].dtype)


def _qkv(x, lp, cfg, positions, inv_freq, tp=None):
    """Norm, projections and rope of [..., S, E] activations at the rank's
    heads; q carries the query scale (the attention's own D^-0.5 then
    gives _q_scale)."""
    lead = x.shape[:-1]
    H, KVH, D = _heads(cfg, tp)
    h = _norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = torch.matmul(h, lp["wq"]).reshape(*lead, H, D)
    k = torch.matmul(h, lp["wk"]).reshape(*lead, KVH, D)
    v = torch.matmul(h, lp["wv"]).reshape(*lead, KVH, D)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    return q * (_q_scale(cfg) * D ** 0.5), k, v


def _finish(x, attn, lp, cfg, tp=None):
    """Output projection, the residual, the MLP, with Gemma-2's post
    norms. attn: [..., H, D]. Under tp the row-parallel products are
    summed over the ranks before the post norms see them."""
    a_out = all_reduce(torch.matmul(attn.reshape(*attn.shape[:-2], -1), lp["wo"]), tp)
    if cfg.sandwich_norms:
        a_out = _norm(a_out, lp["post_attn_norm"], cfg.rms_norm_eps)
    x = x + a_out
    h2 = _norm(x, lp["pre_mlp_norm"], cfg.rms_norm_eps)
    m_out = _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"], tp)
    if cfg.sandwich_norms:
        m_out = _norm(m_out, lp["post_mlp_norm"], cfg.rms_norm_eps)
    return x + m_out


def _final_logits(x, params, cfg, tp=None):
    """[B, E] -> f32 [B, V]: the final norm, the tied product with f32
    accumulation (under tp the rank's vocabulary block, all gathered), the
    final softcap."""
    x = _norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _softcap(_logits(x, params["embed"], tp), cfg.final_logit_softcapping)


def prefill(
    params: dict,
    cfg: GemmaConfig,
    tokens: torch.Tensor,  # [B, S] right-padded token ids
    lengths: torch.Tensor,  # [B] true prompt lengths
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt forward. Returns (last_token_logits f32 [B, V],
    k_all [NL, B, S, KVH, D], v_all [NL, B, S, KVH, D]); under tp the
    K/V are the rank's KV heads."""
    B, S = tokens.shape
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    x = _embed(params, cfg, tokens, tp)  # [B, S, E]
    flash = prefill_uses_flash(cfg)
    ks, vs = [], []
    for i, win in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(x, lp, cfg, positions, inv_freq, tp)
        if flash:
            attn = flash_causal_prefill(q, k, v.contiguous())
        else:
            attn = causal_prefill_attention(
                q, k, v, logit_softcap=cfg.attn_logit_softcapping,
                window=win,
            )
        x = _finish(x, attn, lp, cfg, tp)
        ks.append(k)
        vs.append(v)
    idx = torch.clamp(lengths.to(dev).long() - 1, 0, S - 1)
    last = x[torch.arange(B, device=dev), idx]  # [B, E]
    return _final_logits(last, params, cfg, tp), torch.stack(ks), torch.stack(vs)


def prefill_chunk(
    params: dict,
    cfg: GemmaConfig,
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
    cache, masked by position), with each layer's softcap and window;
    under tp the staging cache holds the rank's KV heads.
    Returns (f32 [1, V] logits at position `length - 1` when want_logits,
    else None; k_slot; v_slot)."""
    B, C = tokens.shape
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    start = torch.as_tensor(start, device=dev).long().reshape(())
    length = torch.as_tensor(length, device=dev).long().reshape(())
    offs = torch.arange(C, device=dev)
    positions = (start + offs)[None, :]  # [1, C]
    rows = start.clamp(0, k_slot.shape[1] - C) + offs
    x = _embed(params, cfg, tokens, tp)  # [1, C, E]
    for i, win in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(x, lp, cfg, positions, inv_freq, tp)
        kc, vc = k_slot[i], v_slot[i]  # [L, KVH, D]
        kc.index_copy_(0, rows, k[0].to(kc.dtype))
        vc.index_copy_(0, rows, v[0].to(vc.dtype))
        attn = chunked_prefill_attention(
            q, kc[None], vc[None], start[None],
            logit_softcap=cfg.attn_logit_softcapping, window=win,
        )
        x = _finish(x, attn, lp, cfg, tp)
    if not want_logits:
        return None, k_slot, v_slot
    idx = torch.clamp(length - 1 - start, 0, C - 1)
    last = x.index_select(1, idx.reshape(1))[:, 0]  # [1, E]
    return _final_logits(last, params, cfg, tp), k_slot, v_slot


def decode_step(
    params: dict,
    cfg: GemmaConfig,
    tokens: torch.Tensor,  # [B] one token per slot
    positions: torch.Tensor,  # [B] absolute position of each token
    k_cache: torch.Tensor,  # [NL, B, L, KVH, D] slot cache (engine/kvcache.py)
    v_cache: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for every slot against the slot cache, as
    llama.decode_step (the new token's K/V written into its slot row in
    place, then the plain ops.attention.decode_attention over the row),
    with each layer's softcap and window. Returns (f32 logits [B, V],
    k_cache, v_cache)."""
    B = tokens.shape[0]
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    x = _embed(params, cfg, tokens)  # [B, E]
    lengths = positions + 1
    slot_idx = torch.arange(B, device=dev)
    for i, win in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(x[:, None], lp, cfg, positions[:, None], inv_freq)
        kc, vc = k_cache[i], v_cache[i]  # [B, L, KVH, D]
        kc[slot_idx, positions] = k[:, 0].to(kc.dtype)
        vc[slot_idx, positions] = v[:, 0].to(vc.dtype)
        attn = decode_attention(
            q[:, 0], kc, vc, lengths,
            logit_softcap=cfg.attn_logit_softcapping,
            window=win if cfg.sliding_window else None,
        )
        x = _finish(x, attn, lp, cfg)
    return _final_logits(x, params, cfg), k_cache, v_cache


def decode_step_paged(
    params: dict,
    cfg: GemmaConfig,
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
    Each layer passes its softcap and window. The pools (under tp, of the
    rank's KV heads) are updated in place and returned."""
    attn_kernel = resolve_decode_kernel(attn_kernel)
    if isinstance(k_pages, QuantizedPool) and attn_kernel != "per_layer":
        raise ValueError(
            "quantized KV pools require attn_kernel='per_layer' (the "
            "fused kernel reads a raw bf16 pool)"
        )
    dev = tokens.device
    inv_freq = _inv_freq(cfg, dev)
    cap = cfg.attn_logit_softcapping
    x = _embed(params, cfg, tokens, tp)  # [B, E]
    pos1 = positions[:, None]
    page_ids, offsets = token_page_coords(block_tables, positions, k_pages.shape[2])
    fused = attn_kernel == "fused"
    lengths = (positions + 1).to(torch.int32)
    pos32 = positions.to(torch.int32)
    k_new, v_new = [], []
    for i, win in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(x[:, None], lp, cfg, pos1, inv_freq, tp)
        q, k, v = q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous()
        if fused:
            attn = paged_decode_attention_fused(
                q, k_pages, v_pages, k, v, block_tables, pos32, i,
                logit_softcap=cap, window=win,
            )
            k_new.append(k)
            v_new.append(v)
        else:
            kp, vp = k_pages[i], v_pages[i]
            scatter_decode_token(kp, vp, k, v, page_ids, offsets)
            attn = paged_decode_attention(
                q, kp, vp, block_tables, lengths,
                logit_softcap=cap, window=win,
            )
        x = _finish(x, attn, lp, cfg, tp)
    if fused:
        # One write for every layer's new token ([NL, B, 1, KVH, D]).
        batched_scatter_sequence(
            k_pages, v_pages, torch.stack(k_new)[:, :, None],
            torch.stack(v_new)[:, :, None], page_ids[:, None], offsets[:, None],
        )
    return _final_logits(x, params, cfg, tp), k_pages, v_pages
