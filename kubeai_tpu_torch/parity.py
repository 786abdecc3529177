"""Carry a parameter tree of the JAX package into the port.

`params_from_numpy` takes the JAX `llama.init_params`,
`gemma.init_params` or `mixtral.init_params` dict after it was turned
into numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and returns
the port's parameter dict: the same keys, the stacked [NL, ...] layer
dict with whatever stacks it holds (q/k/v biases, Gemma-2's three norm
stacks, mixtral's router and expert stacks; a mixtral tree's gate and up
stacks go from the JAX [NL, X, E, M] to the port's [NL, E, X, M],
contiguous, `MIXTRAL_EXPERT_MINOR`), and a tied
`lm_head` when the tree shares one array with `embed` or has none (gemma
ties its logits to `embed` and never reads it). The tests use it so that
both packages compute with the same weights. bf16 arrays (numpy's
ml_dtypes bfloat16) are taken bit for bit. A quantized layer leaf
(`quantize_params`' {"w8": int8, "scale": f32}) is carried as a dict of
the same two arrays, int8 and f32, outside the `dtype` cast.

`lora_from_numpy` does the same for the JAX `llama.init_lora_buffers`
tree: adapter-major [n, NL, ...] buffers become the port's layer-major
[NL, n, ...] ones.

`slot_cache_from_numpy` turns the K and V arrays of a JAX
`kvcache.KVCache` ([NL, slots, max_len, KVH, D]) into the port's
engine/kvcache.KVCache; a draft model's parameters go through
`params_from_numpy` like any other.

`whisper_params_from_numpy` carries the JAX `whisper.init_params` (or
`load_whisper_params`) tree across: the same nested dicts, with the
encoder and decoder layers as lists of layer dicts.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


# Mixtral's stacks that the port keeps expert-minor (models/mixtral.py):
# the JAX [NL, X, E, M] with the X and E axes swapped.
MIXTRAL_EXPERT_MINOR = ("w_gate", "w_up")


def _leaf(w, device, dtype):
    """A layer leaf; a quantized {"w8", "scale"} leaf keeps int8 and f32
    and takes no `dtype` cast."""
    if isinstance(w, dict):
        return {k: _tensor(v, device, None) for k, v in w.items()}
    return _tensor(w, device, dtype)


def params_from_numpy(
    tree: dict,
    device: str | torch.device = "cpu",
    dtype: torch.dtype | None = None,
) -> dict:
    """numpy parameter tree -> torch parameter dict on `device`, cast to
    `dtype` when given."""
    layers = dict(tree["layers"])
    if "router" in layers:  # mixtral
        for name in MIXTRAL_EXPERT_MINOR:
            layers[name] = np.ascontiguousarray(np.swapaxes(np.asarray(layers[name]), 1, 2))
    out = {
        "embed": _tensor(tree["embed"], device, dtype),
        "final_norm": _tensor(tree["final_norm"], device, dtype),
        "layers": {name: _leaf(w, device, dtype) for name, w in layers.items()},
    }
    head = tree.get("lm_head")
    if head is None or head is tree["embed"]:
        out["lm_head"] = out["embed"]
    else:
        out["lm_head"] = _tensor(head, device, dtype)
    return out


def lora_from_numpy(
    tree: dict,
    device: str | torch.device = "cpu",
    dtype: torch.dtype | None = None,
) -> dict:
    """numpy LoRA buffers {target: {"A": [n, NL, in, r], "B": [n, NL, r,
    out]}} -> the port's {target: {"A": [NL, n, in, r], "B": [NL, n, r,
    out]}} on `device`, contiguous, cast to `dtype` when given."""
    return {
        target: {
            name: _tensor(np.moveaxis(np.asarray(buf), 1, 0), device, dtype).contiguous()
            for name, buf in ab.items()
        }
        for target, ab in tree.items()
    }


def whisper_params_from_numpy(
    tree,
    device: str | torch.device = "cpu",
    dtype: torch.dtype | None = None,
):
    """numpy whisper tree (nested dicts and lists of layer dicts) -> the
    same structure of torch tensors on `device`, cast to `dtype` when
    given."""
    if isinstance(tree, dict):
        return {k: whisper_params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [whisper_params_from_numpy(v, device, dtype) for v in tree]
    return _tensor(tree, device, dtype)


def slot_cache_from_numpy(
    k,
    v,
    device: str | torch.device = "cpu",
    dtype: torch.dtype | None = None,
):
    """numpy K and V slot-cache arrays [NL, slots, max_len, KVH, D] ->
    the port's KVCache on `device`, cast to `dtype` when given."""
    from kubeai_tpu_torch.engine.kvcache import KVCache

    return KVCache(k=_tensor(k, device, dtype).contiguous(),
                   v=_tensor(v, device, dtype).contiguous())
