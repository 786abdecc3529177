"""Normalization ops. Counterpart of kubeai_tpu/ops/norms.py.

RMSNorm accumulates in float32 and casts back to the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(dtype)
