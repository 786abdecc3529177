"""Carry a parameter tree of the JAX package into the port.

`params_from_numpy` takes the JAX `llama.init_params` dict after it was
turned into numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and
returns the port's parameter dict: the same keys, the stacked [NL, ...]
layer dict, optional q/k/v biases, and a tied `lm_head` when the tree
shares one array with `embed` (or has no `lm_head`). The tests use it so
that both packages compute with the same weights. bf16 arrays (numpy's
ml_dtypes bfloat16) are taken bit for bit.
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


def params_from_numpy(
    tree: dict,
    device: str | torch.device = "cpu",
    dtype: torch.dtype | None = None,
) -> dict:
    """numpy parameter tree -> torch parameter dict on `device`, cast to
    `dtype` when given."""
    out = {
        "embed": _tensor(tree["embed"], device, dtype),
        "final_norm": _tensor(tree["final_norm"], device, dtype),
        "layers": {
            name: _tensor(w, device, dtype) for name, w in tree["layers"].items()
        },
    }
    head = tree.get("lm_head")
    if head is None or head is tree["embed"]:
        out["lm_head"] = out["embed"]
    else:
        out["lm_head"] = _tensor(head, device, dtype)
    return out
