"""The product of bf16 activations with int8 weights (W8A16).
Counterpart of the dequantize-into-dot of the JAX package's llama forward
(`_w` at kubeai_tpu/models/llama.py:39, kubeai_tpu/engine/quantization.py):
XLA fuses `convert(int8 -> bf16) * scale` into the dot's operand read. It
is not a pallas_call.

`int8_linear(x, leaf)` computes x [..., K] @ dequantize(leaf) [K, N] for
a quantized leaf {"w8": int8 [K, N], "scale": f32 [1, N]}
(engine/quantization.py). CPU tensors take the plain version,
torch.matmul(x, dequantize_as(leaf, x.dtype)); CUDA tensors launch the
kernel in csrc/w8a16_gemm.cu or raise, whatever the dtype or shape.

The kernel forms each weight as exactly the bf16 value the plain version
forms, bf16(bf16(w8) * bf16(scale)), in registers, and feeds it to the
tensor cores with f32 accumulation and a bf16 output, as torch.matmul
gives on bf16: the two differ only in the order of the sums. It reads w8
N-major (the transposed view of a contiguous [N, K] tensor, the layout
quantization.quantize_tensor stores) and takes K a multiple of 64 and N
a multiple of 16. `check_weight` refuses any other shape when the engine
is built. Up to 64 rows (decode steps, verify windows) a skinny kernel
streams the weights, bound by their bytes; above it a tiled mma.sync
kernel, with K split `gemm_splits` ways into f32 scratch that this
wrapper allocates, so a CUDA graph captures every launch.
"""

from __future__ import annotations

import torch

from kubeai_tpu_torch.ops import _build

# The kernel's granularity: K in chunks of 64, N in tiles of 16 rows.
K_MULTIPLE = 64
N_MULTIPLE = 16
# csrc/w8a16_gemm.cu's constants: the skinny kernel takes M up to 64; the
# tiled one 128 channels by 64 or 128 rows a CTA, two 64-row CTAs an SM
# of the H100 SXM's 132.
SKINNY_MAX_M = 64
TILE_N = 128
SMS = 132
MAX_SPLITS = 8
MIN_SPLIT_CHUNKS = 8


def gemm_splits(m: int, n: int, k: int) -> int:
    """How many ways the tiled kernel splits K (from the shapes only, so
    a CUDA graph replays the same split): 1 for the skinny kernel and
    where the (N, M) tiles fill two waves, else as many as bring the
    64-row tiles to two CTAs an SM, at most MAX_SPLITS and at least
    MIN_SPLIT_CHUNKS chunks of 64 a split. The partial sums go through f32
    scratch and a fixed-order reduce."""
    if m <= SKINNY_MAX_M:
        return 1
    tiles_n = -(-n // TILE_N)
    if tiles_n * -(-m // 128) >= 2 * SMS:
        return 1
    tiles = tiles_n * -(-m // 64)
    return max(1, min(2 * SMS // tiles, MAX_SPLITS, k // K_MULTIPLE // MIN_SPLIT_CHUNKS))


def dequantize_as(leaf: dict, dtype: torch.dtype) -> torch.Tensor:
    """The weight the plain version multiplies by: w8 * bf16(scale) formed
    in `dtype`. In bf16 that is quantization.dequantize's value, bit for
    bit (the product of an int8 and a bf16 value is exact in f32 and
    rounds once). In f32 the product stays unrounded, as in the JAX
    package's jitted forward: XLA folds the bf16 product into the f32 dot
    (it allows excess precision), so rounding it here would move f32
    logits ~1e-3 off JAX's."""
    return leaf["w8"].to(dtype) * leaf["scale"].to(torch.bfloat16).to(dtype)


def check_weight(leaf: dict, name: str = "weight") -> None:
    """Raise ValueError, naming the shape, for a quantized [.., K, N]
    leaf the kernel does not take."""
    k, n = leaf["w8"].shape[-2:]
    if k % K_MULTIPLE or n % N_MULTIPLE:
        raise ValueError(
            f"int8 {name} of shape [{k}, {n}]: the W8A16 kernel takes K a "
            f"multiple of {K_MULTIPLE} and N a multiple of {N_MULTIPLE}"
        )


def _check_args(x, w8, scale) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the W8A16 kernel takes bf16 activations, got {x.dtype}")
    if w8.dtype != torch.int8 or w8.dim() != 2:
        raise TypeError(f"w8 must be int8 [K, N], got {w8.dtype} {tuple(w8.shape)}")
    for name, t in (("w8", w8), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    k, n = w8.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match w8 {tuple(w8.shape)}")
    if not w8.t().is_contiguous():
        raise ValueError(
            "the W8A16 kernel reads w8 N-major (quantization.pack_n_major)"
        )
    if scale.dtype != torch.float32 or scale.numel() != n or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous f32 [1, {n}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    check_weight({"w8": w8})


def int8_linear(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """x [..., K] @ dequantize(leaf) [K, N] -> [..., N]. CUDA tensors
    launch the W8A16 kernel (bf16 x and out) or raise; CPU tensors take
    the plain version."""
    w8, scale = leaf["w8"], leaf["scale"]
    if x.device.type == "cpu":
        return torch.matmul(x, dequantize_as(leaf, x.dtype))
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear has no path for {x.device}")
    _check_args(x, w8, scale)
    k, n = w8.shape
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    if m:
        splits = gemm_splits(m, n, k)
        scratch = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        status = _build.load().kubeai_w8a16_gemm(
            x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), m, n, k, splits,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
        _build.check(status, "int8_linear")
        int8_linear.launches += 1
    return out.reshape(*x.shape[:-1], n)


# Kernel launches since the count was last set to 0.
int8_linear.launches = 0
