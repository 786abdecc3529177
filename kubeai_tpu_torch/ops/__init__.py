"""Core ops: norms, rotary embeddings, attention, and the wrappers of the
CUDA kernels. Counterpart of kubeai_tpu/ops."""

from kubeai_tpu_torch.ops.norms import rms_norm
from kubeai_tpu_torch.ops.rope import apply_rope, rope_frequencies
from kubeai_tpu_torch.ops.attention import (
    causal_prefill_attention,
    decode_attention,
)
