"""Core ops: norms, rotary embeddings, attention, and the wrappers of the
CUDA kernels. Counterpart of kubeai_tpu/ops."""

from kubeai_tpu_torch.ops.norms import rms_norm
from kubeai_tpu_torch.ops.rope import apply_rope, rope_frequencies
from kubeai_tpu_torch.ops.attention import (
    causal_prefill_attention,
    decode_attention,
)
from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
from kubeai_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_fused,
    paged_verify_attention,
)

# Every wrapper of a CUDA kernel, by name. Each counts its own launches in
# its `launches` attribute; the device programs (engine/graphs.py) and the
# chip smoke read this one registry, so a new kernel is counted there too.
COUNTED_KERNELS = {
    fn.__name__: fn
    for fn in (
        paged_decode_attention,
        flash_causal_prefill,
        paged_verify_attention,
        paged_decode_attention_fused,
    )
}
