"""PyTorch/CUDA port of the kubeai_tpu serving engine, for one NVIDIA H100.

The JAX package `kubeai_tpu` is the reference; this package mirrors its
layout (`ops/`, `models/`, `engine/`, `scheduling/`) so each module sits
at the path of its counterpart. It imports `torch` and nothing of JAX or
of `kubeai_tpu`.

The two TPU kernels on the serving path are CUDA C++ written for Hopper
(`csrc/`): paged decode attention (`ops/paged_attention.py`) and flash
prefill attention (`ops/flash_attention.py`). They are compiled with
`nvcc` on first use (`ops/_build.py`). Each has a plain PyTorch version
beside it, used for CPU tensors and by the tests.

Entry points (`Engine`, `EngineServer`, `init_params`) run on `cuda`
unless the caller passes `device="cpu"`; without a GPU and without an
explicit device they raise (see `device.resolve_device`).
"""

from kubeai_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
