"""Llama-family decoder (Llama 2/3/3.1, Mistral, Qwen2 with q/k/v biases).
Counterpart of kubeai_tpu/models/llama.py: the whole-prompt `prefill`,
`prefill_chunk` (one staged chunk of a long or prefix-cached prompt),
`decode_step` against the slot cache (engine/kvcache.py: the engine's
slot mode and the draft model's proposals), `decode_step_paged` in both
layouts ("per_layer" and "fused"), the
speculative verify forward `decode_verify_paged`, and the embedding
forward `hidden_states` (`_trunk` over `trunk_layer`: mean-pooled,
L2-normalized final hidden states, the TextEmbedding feature).

Parameters are a plain dict with the JAX package's layout, so the tests
can hand the same weights to both packages (kubeai_tpu_torch.parity):

    {"embed": [V, E], "final_norm": [E], "lm_head": [V, E],
     "layers": {"input_norm": [NL, E], "wq": [NL, E, H*D], ...}}

Layers are stacked on a leading [NL] axis and walked with a Python loop
(the JAX version scans). Weights are bf16 (or f32 for the parity tests).

Tensor parallelism: `param_specs` gives each leaf's logical axes (the
JAX version's table), and `prefill`, `prefill_chunk`, both layouts of
`decode_step_paged`, `decode_verify_paged` and the trunk take `tp` (a
parallel.collectives.TensorParallel) with the rank's shard of the params
(parallel.sharding.shard_params): the layer runs at the rank's heads and
KV heads (H / tp, KV heads as `TensorParallel.local_kv_heads`), its MLP
columns and its vocabulary block, with one all_reduce after `wo`, one
after `w_down` and one in the embedding lookup, and the logits all
gathered. Qwen2's q/k/v biases shard with their heads. Ring-attention
prefill (an sp mesh dim) is not ported and raises.

Int8 weights (EngineConfig.quantization="int8"): a layer weight may be a
quantized leaf {"w8", "scale"} (engine/quantization.py). Every base
product goes through `_matmul`, which sends such a leaf to
ops.int8_matmul.int8_linear (the W8A16 kernel on the card, the plain
dequantize-then-matmul on the CPU), as the JAX version's `_w` does on
every path: prefill, the trunk, `prefill_chunk`, both decode steps and
the verify forward. `embed` and `lm_head` stay bf16.

LoRA: every forward takes `lora` (the stacked adapter buffers of
`init_lora_buffers`) and `lora_idx` ([B] adapter index per row, 0 = the
all-zero "no adapter" row). Each of `LORA_TARGETS`' projections adds
`_lora_delta` after its base product and bias, so one batch serves a mix
of adapters. The delta is two small batched products per projection
(torch.bmm on the gathered slices), as the JAX version computes it with
jnp.einsum outside any Pallas kernel. Under a mesh the buffers are the
rank's (`init_lora_buffers(..., tp=)`, `lora_shard`): wq/wk/wv's B
columns of the rank's heads (of the one KV head it keeps where tp
exceeds the KV heads) and wo's A rows of its heads, so wo's delta is a
partial sum that joins the base product before the all_reduce that
follows wo; no collective is added.

Prefill and trunk attention go through ops.flash_attention.flash_causal_prefill
for every bucket (the CUDA kernel on the card); a staged chunk attends
through the plain ops.attention.chunked_prefill_attention, as the JAX
version's chunk does (plain jnp there, no Pallas kernel), and so does
the slot-cache `decode_step` (plain ops.attention.decode_attention).
Paged decode attention goes through ops.paged_attention, once per layer
per step:
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
from kubeai_tpu_torch.ops.attention import chunked_prefill_attention, decode_attention
from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
from kubeai_tpu_torch.ops.int8_matmul import int8_linear
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
from kubeai_tpu_torch.parallel import sharding as sh
from kubeai_tpu_torch.parallel.collectives import all_reduce, embed, gather_vocab
from kubeai_tpu_torch.parallel.mesh import AXIS_SEQ, axis_size


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


def param_specs(cfg: LlamaConfig) -> dict:
    """Logical sharding axes per parameter (leading axis = stacked layers,
    sharded over the pp mesh dim when it exists, replicated otherwise)."""
    L = sh.LAYERS
    layers = {
        "input_norm": (L, sh.EMBED),
        "wq": (L, sh.EMBED, sh.HEADS),
        "wk": (L, sh.EMBED, sh.KV_HEADS),
        "wv": (L, sh.EMBED, sh.KV_HEADS),
        "wo": (L, sh.HEADS, sh.EMBED),
        "post_attn_norm": (L, sh.EMBED),
        "w_gate": (L, sh.EMBED, sh.MLP),
        "w_up": (L, sh.EMBED, sh.MLP),
        "w_down": (L, sh.MLP, sh.EMBED),
    }
    if cfg.attention_bias:
        layers["bq"] = (L, sh.HEADS)
        layers["bk"] = (L, sh.KV_HEADS)
        layers["bv"] = (L, sh.KV_HEADS)
    return {
        "embed": (sh.VOCAB, sh.EMBED),
        "layers": layers,
        "final_norm": (sh.EMBED,),
        "lm_head": (sh.VOCAB, sh.EMBED),
    }


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
    """Layer i's weights (a quantized leaf's w8 and scale both indexed)."""
    return {
        name: {k: v[i] for k, v in w.items()} if isinstance(w, dict) else w[i]
        for name, w in params["layers"].items()
    }


def _matmul(h, w):
    """The base product h @ w: the W8A16 kernel for a quantized leaf."""
    return int8_linear(h, w) if isinstance(w, dict) else torch.matmul(h, w)


# ---- LoRA (hot-swappable, batched) ------------------------------------------
#
# Adapter weights live in fixed-shape stacked buffers, so loading or
# unloading an adapter writes a slice in place and never changes a shape
# or an address (the captured CUDA graphs keep reading the same tensors):
#
#   A[target]: [NL, n_adapters, in, r_max]   B[target]: [NL, n_adapters, r_max, out]
#
# Layer-major, so each layer's [n, in, r] slice is contiguous (the JAX
# buffers are adapter-major, [n, NL, ...]; kubeai_tpu_torch.parity carries
# them across). Adapter index 0 stays all zeros ("no adapter"); selecting
# a row's adapter is a gather over the adapter axis.

LORA_TARGETS = ("wq", "wk", "wv", "wo")


def lora_dims(cfg: LlamaConfig, tp=None) -> dict[str, tuple[int, int]]:
    """(in, out) of each LoRA target's projection: the whole model's, or
    the rank's under `tp` (its heads' q/k/v columns, its heads' wo rows)."""
    E, H, KVH, D = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    if tp is not None:
        H, KVH = tp.local_heads(H), tp.local_kv_heads(KVH)
    return {"wq": (E, H * D), "wk": (E, KVH * D), "wv": (E, KVH * D), "wo": (H * D, E)}


def lora_shard(cfg: LlamaConfig, tp, target: str, A: torch.Tensor, B: torch.Tensor):
    """The rank's part of one adapter target, A [NL, in, r] and B [NL, r,
    out] whole: cut as the projection is cut (parallel/sharding.py and
    Engine._shard). wq, wk, wv keep A and the B columns of the rank's
    heads (wk/wv of the one KV head its q heads read where tp exceeds the
    KV heads); wo keeps the A rows of its heads and B whole."""
    D = cfg.head_size
    if target == "wo":
        h = tp.local_heads(cfg.num_heads) * D
        return A.narrow(-2, tp.rank * h, h), B
    if target == "wq":
        h = tp.local_heads(cfg.num_heads) * D
        return A, B.narrow(-1, tp.rank * h, h)
    kvh = cfg.num_kv_heads
    if tp.kv_replicated(kvh):
        return A, B.narrow(-1, tp.kv_head(kvh) * D, D)
    h = tp.local_kv_heads(kvh) * D
    return A, B.narrow(-1, tp.rank * h, h)


def init_lora_buffers(
    cfg: LlamaConfig,
    n_adapters: int,
    max_rank: int,
    dtype=None,
    device: str | torch.device | None = None,
    tp=None,
) -> dict:
    """All-zero adapter buffers {target: {"A": [NL, n, in, r], "B": [NL, n,
    r, out]}} in `dtype` (default: the model's) on `device` (default:
    cuda), at the rank's dims under `tp`."""
    dtype = dtype or cfg.dtype
    dev = resolve_device(device)
    NL = cfg.num_layers
    return {
        t: {
            "A": torch.zeros((NL, n_adapters, i, max_rank), dtype=dtype, device=dev),
            "B": torch.zeros((NL, n_adapters, max_rank, o), dtype=dtype, device=dev),
        }
        for t, (i, o) in lora_dims(cfg, tp).items()
    }


def _layer_lora(lora: dict | None, i: int) -> dict | None:
    """Layer i's adapter slices {target: (A [n, in, r], B [n, r, out])}."""
    if lora is None:
        return None
    return {t: (ab["A"][i], ab["B"][i]) for t, ab in lora.items()}


def _lora_delta(x, A, B, idx):
    """x: [B, S, in] (or [B, in]); A: [n, in, r], B: [n, r, out] for ONE
    layer; idx: [B] adapter index per row. Returns the low-rank delta,
    [B, S, out] (or [B, out])."""
    Ag = A.index_select(0, idx)  # [B, in, r]
    Bg = B.index_select(0, idx)  # [B, r, out]
    if x.dim() == 2:
        return torch.bmm(torch.bmm(x[:, None], Ag), Bg)[:, 0]
    return torch.bmm(torch.bmm(x, Ag), Bg)


def _projector(lor: dict | None, lora_idx):
    """proj(h, w, target, bias=None): the base product, then the bias,
    then the row's adapter delta (the JAX version's order, which f32
    parity depends on)."""

    def proj(h, w, target, bias=None):
        out = _matmul(h, w)
        if bias is not None:
            out = out + bias
        if lor is not None:
            A, B = lor[target]
            out = out + _lora_delta(h, A, B, lora_idx)
        return out

    return proj


def _lora_rows(lora, lora_idx, B: int, device) -> torch.Tensor | None:
    """The [B] adapter index of each row (zeros when not given), or None
    without adapters."""
    if lora is None:
        return None
    if lora_idx is None:
        return torch.zeros(B, dtype=torch.long, device=device)
    return lora_idx.to(device).reshape(B)


def _refuse_unported(mesh=None) -> None:
    if axis_size(mesh, AXIS_SEQ) > 1:
        raise NotImplementedError(
            "ring-attention prefill over an sp mesh dim is not ported yet "
            "(ROADMAP A item 11c)"
        )


def _heads(cfg: LlamaConfig, tp) -> tuple[int, int, int]:
    """(q heads, KV heads, head dim) of one rank's layer."""
    if tp is None:
        return cfg.num_heads, cfg.num_kv_heads, cfg.head_size
    return tp.local_heads(cfg.num_heads), tp.local_kv_heads(cfg.num_kv_heads), cfg.head_size


def _mlp(x, gate, up, down, tp=None):
    return all_reduce(_matmul(F.silu(_matmul(x, gate)) * _matmul(x, up), down), tp)


def _logits(x: torch.Tensor, lm_head: torch.Tensor, tp=None) -> torch.Tensor:
    """[B, E] x [V, E] -> f32 [B, V]. On bf16 weights the product runs in
    bf16 and keeps its f32 accumulator as the output, as the JAX
    version's preferred_element_type=float32 does: on the card the GEMM
    writes f32 itself (torch.mm out_dtype); on the CPU the operands are
    upcast. Under tp, `lm_head` is the rank's vocabulary block and the
    blocks' logits are all gathered."""
    if x.dtype == torch.float32:
        out = torch.matmul(x, lm_head.t())
    elif x.is_cuda:
        out = torch.mm(x, lm_head.t(), out_dtype=torch.float32)
    else:
        out = torch.matmul(x.float(), lm_head.t().float())
    return gather_vocab(out, tp)


def _prefill_layer(x, lp, proj, cfg, inv_freq, msc, positions, tp=None):
    """One layer over whole [B, S, E] sequences from position 0: project
    (proj: the base product, bias and adapter delta), rope, causal
    attention through flash_causal_prefill (B2 on the card), MLP.
    Returns (x, k [B, S, KVH, D], v [B, S, KVH, D])."""
    B, S, _ = x.shape
    H, KVH, D = _heads(cfg, tp)
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = proj(h, lp["wq"], "wq", lp.get("bq")).reshape(B, S, H, D)
    k = proj(h, lp["wk"], "wk", lp.get("bk")).reshape(B, S, KVH, D)
    v = proj(h, lp["wv"], "wv", lp.get("bv")).reshape(B, S, KVH, D)
    q = apply_rope(q, positions, inv_freq, msc)
    k = apply_rope(k, positions, inv_freq, msc)
    attn = flash_causal_prefill(q, k, v.contiguous())
    x = x + all_reduce(proj(attn.reshape(B, S, H * D), lp["wo"], "wo"), tp)
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"], tp), k, v


def prefill(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] right-padded token ids
    lengths: torch.Tensor,  # [B] true prompt lengths
    lora: dict | None = None,
    lora_idx: torch.Tensor | None = None,
    mesh=None,
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-prompt forward. Returns (last_token_logits f32 [B, V],
    k_all [NL, B, S, KVH, D], v_all [NL, B, S, KVH, D]); under tp the
    K/V are the rank's KV heads."""
    _refuse_unported(mesh)
    B, S = tokens.shape
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    lora_idx = _lora_rows(lora, lora_idx, B, dev)
    x = embed(params["embed"], tokens, tp)  # [B, S, E]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        proj = _projector(_layer_lora(lora, i), lora_idx)
        x, k, v = _prefill_layer(x, _layer(params, i), proj, cfg, inv_freq, msc,
                                 positions, tp)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    # Logits only for each sequence's final real token.
    idx = torch.clamp(lengths.to(dev).long() - 1, 0, S - 1)
    last = x[torch.arange(B, device=dev), idx]  # [B, E]
    return _logits(last, params["lm_head"], tp), torch.stack(ks), torch.stack(vs)


def trunk_layer(x: torch.Tensor, lp: dict, cfg: LlamaConfig, tp=None) -> torch.Tensor:
    """One trunk layer [B, S, E] -> [B, S, E] (per-layer params `lp`, the
    rank's under tp): the prefill layer without adapters, its K/V
    dropped."""
    B, S, _ = x.shape
    inv_freq, msc = _rope_tables(cfg, x.device)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    return _prefill_layer(x, lp, _projector(None, None), cfg, inv_freq, msc, positions,
                          tp)[0]


def _trunk(params: dict, cfg: LlamaConfig, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Transformer trunk: [B, S] tokens -> [B, S, E] final hidden states
    (whole on every rank under tp)."""
    x = embed(params["embed"], tokens, tp)
    for i in range(cfg.num_layers):
        x = trunk_layer(x, _layer(params, i), cfg, tp)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def hidden_states(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B, S] right-padded
    lengths: torch.Tensor,  # [B]
    tp=None,
) -> torch.Tensor:
    """Mean-pooled, L2-normalized embeddings, f32 [B, E]: the mean of each
    row's first `lengths` final hidden states in f32, over its norm
    floored at 1e-9. Causal attention keeps the right padding out of the
    valid rows, so the padded rows are computed and then masked. Under tp
    every rank runs its shard and returns the same vectors."""
    x = _trunk(params, cfg, tokens, tp)  # [B, S, E]
    S = tokens.shape[1]
    lengths = lengths.to(tokens.device)
    mask = (torch.arange(S, device=tokens.device)[None, :] < lengths[:, None]).float()
    summed = torch.einsum("bse,bs->be", x.float(), mask)
    pooled = summed / torch.clamp(lengths[:, None].float(), min=1.0)
    return pooled / torch.clamp(torch.linalg.norm(pooled, dim=-1, keepdim=True), min=1e-9)


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
    tp=None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """One chunk of incremental prefill against one slot's cache. Every
    chunk of every prompt length has the same shapes, so one CUDA graph
    serves them all. Each layer writes the chunk's K/V at `start`, in
    place (like the JAX version's dynamic_update_slice, the write start
    is clamped so the chunk fits), then attends over the whole cache;
    stale entries past the causal frontier are masked by position.
    Returns (f32 [1, V] logits at position `length - 1` when want_logits,
    else None; k_slot; v_slot)."""
    B, C = tokens.shape
    H, KVH, D = _heads(cfg, tp)
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    start = torch.as_tensor(start, device=dev).long().reshape(())
    length = torch.as_tensor(length, device=dev).long().reshape(())
    offs = torch.arange(C, device=dev)
    positions = (start + offs)[None, :]  # [1, C]
    rows = start.clamp(0, k_slot.shape[1] - C) + offs
    lora_idx = _lora_rows(lora, lora_idx, B, dev)
    x = embed(params["embed"], tokens, tp)  # [1, C, E]
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        proj = _projector(_layer_lora(lora, i), lora_idx)
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q = proj(h, lp["wq"], "wq", lp.get("bq")).reshape(B, C, H, D)
        k = proj(h, lp["wk"], "wk", lp.get("bk")).reshape(B, C, KVH, D)
        v = proj(h, lp["wv"], "wv", lp.get("bv")).reshape(B, C, KVH, D)
        q = apply_rope(q, positions, inv_freq, msc)
        k = apply_rope(k, positions, inv_freq, msc)
        kc, vc = k_slot[i], v_slot[i]  # [L, KVH, D]
        kc.index_copy_(0, rows, k[0].to(kc.dtype))
        vc.index_copy_(0, rows, v[0].to(vc.dtype))
        attn = chunked_prefill_attention(q, kc[None], vc[None], start[None])
        x = x + all_reduce(proj(attn.reshape(B, C, H * D), lp["wo"], "wo"), tp)
        h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        x = x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"], tp)
    if not want_logits:
        return None, k_slot, v_slot
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    idx = torch.clamp(length - 1 - start, 0, C - 1)
    last = x.index_select(1, idx.reshape(1))[:, 0]  # [1, E]
    return _logits(last, params["lm_head"], tp), k_slot, v_slot


def _decode_layer_qkv(x, lp, lor, cfg, inv_freq, msc, pos1, lora_idx, tp=None):
    """Decode-layer front half: norm, QKV projection (+bias, +LoRA),
    rope. One body for both decode layouts, so the projection and LoRA
    math cannot drift between them. Returns (q [B, H, D], k [B, KVH, D],
    v [B, KVH, D], proj); proj is reused for the output projection."""
    B = x.shape[0]
    H, KVH, D = _heads(cfg, tp)
    proj = _projector(lor, lora_idx)
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = proj(h, lp["wq"], "wq", lp.get("bq")).reshape(B, 1, H, D)
    k = proj(h, lp["wk"], "wk", lp.get("bk")).reshape(B, 1, KVH, D)
    v = proj(h, lp["wv"], "wv", lp.get("bv")).reshape(B, 1, KVH, D)
    q = apply_rope(q, pos1, inv_freq, msc)[:, 0]  # [B, H, D]
    k = apply_rope(k, pos1, inv_freq, msc)[:, 0]  # [B, KVH, D]
    return q, k, v[:, 0], proj


def _decode_layer_finish(x, attn, lp, proj, cfg, tp=None):
    """Decode-layer back half: output projection, residual, MLP."""
    x = x + all_reduce(proj(attn.reshape(x.shape[0], -1), lp["wo"], "wo"), tp)
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"], tp)


def decode_step(
    params: dict,
    cfg: LlamaConfig,
    tokens: torch.Tensor,  # [B] one token per slot
    positions: torch.Tensor,  # [B] absolute position of each token
    k_cache: torch.Tensor,  # [NL, B, L, KVH, D] slot cache (engine/kvcache.py)
    v_cache: torch.Tensor,
    lora: dict | None = None,
    lora_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for every slot against the slot cache: each
    layer writes the new token's K/V into its slot row at its position
    (in place), then attends over the row through the plain
    ops.attention.decode_attention, as the JAX version's jnp does (it
    reaches no Pallas kernel). The engine's slot mode and the draft
    model's proposals run here. Returns (f32 logits [B, V], k_cache,
    v_cache)."""
    B = tokens.shape[0]
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    lora_idx = _lora_rows(lora, lora_idx, B, dev)
    x = params["embed"][tokens]  # [B, E]
    lengths = positions + 1  # the valid length, the new token included
    slot_idx = torch.arange(B, device=dev)
    for i in range(cfg.num_layers):
        lp = _layer(params, i)
        q, k, v, proj = _decode_layer_qkv(
            x, lp, _layer_lora(lora, i), cfg, inv_freq, msc,
            positions[:, None], lora_idx,
        )
        kc, vc = k_cache[i], v_cache[i]  # [B, L, KVH, D]
        kc[slot_idx, positions] = k.to(kc.dtype)
        vc[slot_idx, positions] = v.to(vc.dtype)
        attn = decode_attention(q, kc, vc, lengths)
        x = _decode_layer_finish(x, attn, lp, proj, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(x, params["lm_head"]), k_cache, v_cache


def _paged_decode_layer(
    x, lp, lor, kp, vp, cfg, inv_freq, msc, positions, lengths,
    page_ids, offsets, block_tables, lora_idx, tp=None,
):
    """One decode layer against this layer's page pools: project, rope,
    scatter the new token's K/V through the block tables (in place),
    attend over resident pages, MLP."""
    q, k, v, proj = _decode_layer_qkv(
        x, lp, lor, cfg, inv_freq, msc, positions[:, None], lora_idx, tp
    )
    scatter_decode_token(kp, vp, k, v, page_ids, offsets)
    attn = paged_decode_attention(q.contiguous(), kp, vp, block_tables, lengths)
    return _decode_layer_finish(x, attn, lp, proj, cfg, tp)


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
    tp=None,
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
    attn_kernel = resolve_decode_kernel(attn_kernel)
    if isinstance(k_pages, QuantizedPool) and attn_kernel != "per_layer":
        raise ValueError(
            "quantized KV pools require attn_kernel='per_layer' (the "
            "fused kernel reads a raw bf16 pool)"
        )
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    page_size = k_pages.shape[2]
    lora_idx = _lora_rows(lora, lora_idx, tokens.shape[0], dev)
    x = embed(params["embed"], tokens, tp)  # [B, E]
    page_ids, offsets = token_page_coords(block_tables, positions, page_size)
    if attn_kernel == "per_layer":
        lengths = (positions + 1).to(torch.int32)
        for i in range(cfg.num_layers):
            x = _paged_decode_layer(
                x, _layer(params, i), _layer_lora(lora, i), k_pages[i],
                v_pages[i], cfg, inv_freq, msc, positions, lengths, page_ids,
                offsets, block_tables, lora_idx, tp,
            )
    else:
        pos32 = positions.to(torch.int32)
        k_new, v_new = [], []
        for i in range(cfg.num_layers):
            lp = _layer(params, i)
            q, k, v, proj = _decode_layer_qkv(
                x, lp, _layer_lora(lora, i), cfg, inv_freq, msc,
                positions[:, None], lora_idx, tp,
            )
            k, v = k.contiguous(), v.contiguous()
            attn = paged_decode_attention_fused(
                q.contiguous(), k_pages, v_pages, k, v, block_tables, pos32, i,
            )
            x = _decode_layer_finish(x, attn, lp, proj, cfg, tp)
            k_new.append(k)
            v_new.append(v)
        # One write for every layer's new token ([NL, B, 1, KVH, D]).
        batched_scatter_sequence(
            k_pages, v_pages, torch.stack(k_new)[:, :, None],
            torch.stack(v_new)[:, :, None], page_ids[:, None], offsets[:, None],
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return _logits(x, params["lm_head"], tp), k_pages, v_pages


def _verify_page_coords(block_tables, positions, K, page_size):
    """Page coords of all K window positions per slot: ([B, K], [B, K])."""
    ids, offs = zip(*(
        token_page_coords(block_tables, positions + k, page_size)
        for k in range(K)
    ))
    return torch.stack(ids, 1), torch.stack(offs, 1)


def _paged_verify_layer(
    x, lp, lor, kp, vp, cfg, inv_freq, msc, pos_k, page_ids, offsets,
    block_tables, positions, lora_idx, tp=None,
):
    """One verify layer over a [B, K, E] window against this layer's page
    pools: project (+LoRA), rope, write the window's K/V through the
    block tables (in place), attend through paged_verify_attention,
    MLP."""
    B, K, _ = x.shape
    H, KVH, D = _heads(cfg, tp)
    proj = _projector(lor, lora_idx)
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = proj(h, lp["wq"], "wq", lp.get("bq")).reshape(B, K, H, D)
    k = proj(h, lp["wk"], "wk", lp.get("bk")).reshape(B, K, KVH, D)
    v = proj(h, lp["wv"], "wv", lp.get("bv")).reshape(B, K, KVH, D)
    q = apply_rope(q, pos_k, inv_freq, msc)
    k = apply_rope(k, pos_k, inv_freq, msc)
    kp[page_ids, offsets] = k.to(kp.dtype)
    vp[page_ids, offsets] = v.to(vp.dtype)
    attn = paged_verify_attention(q.contiguous(), kp, vp, block_tables, positions)
    x = x + all_reduce(proj(attn.reshape(B, K, H * D), lp["wo"], "wo"), tp)
    h2 = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    return x + _mlp(h2, lp["w_gate"], lp["w_up"], lp["w_down"], tp)


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
    tp=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative verify: one forward over a K-token window per slot
    against the paged cache. Writes the window's K/V through the block
    tables (rejected tail positions hold K/V that the slot's position
    masks and later steps overwrite) and returns f32 logits for every
    window position, [B, K, V], so the engine can accept the longest
    matching proposal prefix. The pools are updated in place and
    returned."""
    B, K = tokens.shape
    dev = tokens.device
    inv_freq, msc = _rope_tables(cfg, dev)
    page_size = k_pages.shape[2]
    pos_k = positions[:, None] + torch.arange(K, device=dev)[None, :]  # [B, K]
    x = embed(params["embed"], tokens, tp)  # [B, K, E]
    page_ids, offsets = _verify_page_coords(block_tables, positions, K, page_size)
    pos32 = positions.to(torch.int32)
    lora_idx = _lora_rows(lora, lora_idx, B, dev)
    for i in range(cfg.num_layers):
        x = _paged_verify_layer(
            x, _layer(params, i), _layer_lora(lora, i), k_pages[i],
            v_pages[i], cfg, inv_freq, msc, pos_k, page_ids, offsets,
            block_tables, pos32, lora_idx, tp,
        )
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _logits(x.reshape(B * K, -1), params["lm_head"], tp)
    return logits.reshape(B, K, -1), k_pages, v_pages
