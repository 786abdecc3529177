"""Weight-only int8 quantization for serving.
Counterpart of kubeai_tpu/engine/quantization.py.

Decode is bounded by streaming the layer weights from device memory each
step; int8 storage halves that traffic. Symmetric per-output-channel
scales, as in the JAX package:

    w ~ w8 * scale,   w8 = round(w / scale) in [-127, 127]

A quantized leaf is a dict {"w8": int8 [..., in, out], "scale": f32 [...,
1, out]} with the JAX leaf's shapes and values, so the same forward code
serves both precisions (models/llama.py dispatches on the leaf's type)
and the tests hand JAX's quantized tree to the port unchanged
(parity.params_from_numpy). The KV cache, activations, `embed` and
`lm_head` stay bf16.

On the card the product runs in ops/int8_matmul.py's hand-written W8A16
GEMM, which reads the int8 weights in its main loop and never writes a
bf16 copy. It reads w8 N-major: `quantize_tensor` (and `pack_n_major` for
a leaf from elsewhere) stores each [in, out] slice as the transposed view
of a contiguous [out, in] tensor. Shapes and values are the JAX leaf's;
only the memory order differs, and it is resident once.

The engine applies this at construction (EngineConfig.quantization="int8")
to the target's params; a draft model stays unquantized, as in the JAX
engine. `quantized_specs` (the sharding-spec mirror) waits for meshes
(ROADMAP A item 11).
"""

from __future__ import annotations

import torch

# Stacked-weight leaves eligible for quantization. Last axis = output
# channels (per-channel scales).
QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "w8" in leaf and "scale" in leaf


def _n_major(shape, device) -> torch.Tensor:
    """An int8 [..., in, out] view of a contiguous [..., out, in] tensor."""
    *lead, k, n = shape
    return torch.empty((*lead, n, k), dtype=torch.int8, device=device).transpose(-1, -2)


def quantize_tensor(w: torch.Tensor) -> dict:
    """[..., in, out] -> {"w8": int8 [..., in, out] (N-major), "scale": f32
    [..., 1, out]}, on w's device, bit-equal to the JAX numpy version: the
    f32 amax over the input axis / 127, floored at 1e-8, then w32 / scale
    rounded half to even and clipped to +-127. Works one [in, out] slice
    at a time, so the f32 temporary is one layer's, not the stack's."""
    *lead, k, n = w.shape
    slices = w.reshape(-1, k, n)
    base = torch.empty((slices.shape[0], n, k), dtype=torch.int8, device=w.device)
    scale = torch.empty((slices.shape[0], 1, n), dtype=torch.float32, device=w.device)
    for src, q, s in zip(slices, base, scale):
        w32 = src.float()
        s.copy_(torch.clamp_min(w32.abs().amax(dim=0, keepdim=True) / 127.0, 1e-8))
        q.t().copy_(torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8))
    return {"w8": base.reshape(*lead, n, k).transpose(-1, -2),
            "scale": scale.reshape(*lead, 1, n)}


def pack_n_major(leaf: dict) -> dict:
    """The leaf with w8 stored N-major (the kernel's layout) and a
    contiguous f32 scale; returned as is when it already is."""
    w8, scale = leaf["w8"], leaf["scale"]
    if w8.dtype != torch.int8:
        raise TypeError(f"w8 must be int8, got {w8.dtype}")
    if not w8.transpose(-1, -2).is_contiguous():
        packed = _n_major(w8.shape, w8.device)
        packed.copy_(w8)
        w8 = packed
    return {"w8": w8, "scale": scale.float().contiguous()}


def dequantize(leaf):
    """bf16(w8) * bf16(scale), formed in bf16 as the JAX version does; a
    plain tensor is returned as is."""
    if is_quantized(leaf):
        return leaf["w8"].to(torch.bfloat16) * leaf["scale"].to(torch.bfloat16)
    return leaf


def quantize_params(params: dict, targets=QUANTIZABLE) -> dict:
    """Quantize the named layer weights of a stacked-layer param tree (a
    new dict; `params` is left as it is). A leaf that is already quantized
    is only packed N-major."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in targets:
        if name in layers:
            leaf = layers[name]
            layers[name] = pack_n_major(leaf) if is_quantized(leaf) else quantize_tensor(leaf)
    out["layers"] = layers
    return out


def quantized_specs(specs: dict, layers_params: dict) -> dict:
    """Mirror the sharding-spec tree onto the quantized structure: the w8
    leaf keeps the weight's axes; scales shard like the output axis."""
    out = dict(specs)
    lspecs = dict(specs["layers"])
    for name, leaf in layers_params.items():
        if is_quantized(leaf) and name in lspecs:
            axes = lspecs[name]
            # scale shape [..., 1, out]: the singleton input axis must be
            # replicated; the output axis shards like the weight's.
            scale_axes = tuple(axes[:-2]) + (None,) + (axes[-1],)
            lspecs[name] = {"w8": axes, "scale": scale_axes}
    out["layers"] = lspecs
    return out


def weight_bytes(params: dict) -> int:
    """Resident bytes of a parameter tree (quantized leaves count their
    int8 values and f32 scales; a tied lm_head counts once)."""
    seen, total = set(), 0

    def walk(leaf):
        nonlocal total
        if isinstance(leaf, dict):
            for v in leaf.values():
                walk(v)
        elif isinstance(leaf, torch.Tensor):
            key = (leaf.data_ptr(), leaf.numel())
            if key not in seen:
                seen.add(key)
                total += leaf.numel() * leaf.element_size()

    walk(params)
    return total
