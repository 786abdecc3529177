"""The product of bf16 activations with int8 weights (W8A16).
Counterpart of the dequantize-into-dot of the JAX package's llama forward
(`_w` at kubeai_tpu/models/llama.py:39, kubeai_tpu/engine/quantization.py):
XLA fuses `convert(int8 -> bf16) * scale` into the dot's operand read. It
is not a pallas_call.

`int8_linear(x, leaf)` computes x [..., K] @ dequantize(leaf) [K, N] for
a quantized leaf {"w8": int8 [K, N], "scale": f32 [1, N]}
(engine/quantization.py). CPU tensors take the plain version,
torch.matmul(x, dequantize_as(leaf, x.dtype)); CUDA tensors launch one of
the two kernels of csrc/w8a16_gemm.cu or raise, whatever the dtype or
shape.

The kernels form each weight as exactly the bf16 value the plain version
forms, bf16(bf16(w8) * bf16(scale)), in registers, and feed it to the
tensor cores with f32 accumulation and a bf16 output, as torch.matmul
gives on bf16: the two differ only in the order of the sums. They read w8
N-major (the transposed view of a contiguous [N, K] tensor, the layout
quantization.quantize_tensor stores) and take K a multiple of 64 and N a
multiple of 16. `check_weight` refuses any other shape when the engine
is built. `route` chooses the kernel from M alone: up to SKINNY_MAX_M
rows (decode steps) the skinny kernel streams the weights, bound by their
bytes; above it (verify windows, prefill) the warp-specialised wgmma
kernel, with the rows a CTA and K splits `gemm_plan` chooses, into f32
scratch that this wrapper allocates, so a CUDA graph captures every
launch. Each kernel's launcher checks its arguments and counts its own
launches (`w8a16_skinny.launches`, `w8a16_wgmma.launches`).
"""

from __future__ import annotations

import torch

from kubeai_tpu_torch.ops import _build

# The kernel's granularity: K in chunks of 64, N in tiles of 16 rows.
K_MULTIPLE = 64
N_MULTIPLE = 16
# kubeai_w8a16_gemm's kernels.
SKINNY, WGMMA = 0, 1
# The crossover, measured on the card (csrc/w8a16_gemm.cu's kSkinnyMaxM):
# M up to it (the decode step) runs the skinny kernel, which is built for
# one 8-row tile; M above it the wgmma kernel, 128 channels by BM rows a
# CTA (BM one of WGMMA_ROWS, wgmma's N), one CTA an SM of the H100 SXM's
# 132.
SKINNY_MAX_M = 8
TILE_N = 128
WGMMA_ROWS = (16, 32, 48, 64, 96, 128, 256)
SMS = 132
# K splits the wgmma kernel takes, each split at least MIN_SPLIT_CHUNKS
# chunks of 64.
SPLITS = (1, 2, 4, 8)
MIN_SPLIT_CHUNKS = 8
# gemm_plan's cost of a wgmma plan, fitted to the time of every plan at
# Llama-3-8B's and Qwen2.5-0.5B's weight shapes on an H100
# (chip_smoke.report_w8a16_tiles, PERF.md section 6): a CTA's chunk costs
# as much as CHUNK_ROWS + BM rows would (the weight tile's loads and
# conversion are the fixed part), and PARTIAL_BYTES bytes of split K's f32
# partials and their reduce as much as one such row.
CHUNK_ROWS = 256
PARTIAL_BYTES = 5500


def gemm_plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(rows a CTA, K splits) of the wgmma kernel for m rows of a [k, n]
    weight, from the shapes alone, so a CUDA graph replays the same plan:
    of the builds up to the smallest of WGMMA_ROWS that holds m (256
    above) and the SPLITS that leave MIN_SPLIT_CHUNKS chunks a split, the
    one of least cost: the waves of CTAs (one an SM) times the chunks a
    CTA walks times CHUNK_ROWS + BM, plus the partials' bytes (f32, written
    and read back, and the bf16 out) over PARTIAL_BYTES. Small grids thus
    take smaller tiles or more splits until they fill the card."""
    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    chunks = k // K_MULTIPLE
    top = next((bm for bm in WGMMA_ROWS if bm >= m), WGMMA_ROWS[-1])

    def cost(plan: tuple[int, int]) -> float:
        bm, z = plan
        waves = cdiv(cdiv(n, TILE_N) * cdiv(m, bm) * z, SMS)
        partials = (8 * z + 2) * m * n if z > 1 else 0
        return waves * cdiv(chunks, z) * (CHUNK_ROWS + bm) + partials / PARTIAL_BYTES

    return min(((bm, z) for bm in WGMMA_ROWS if bm <= top for z in SPLITS
                if z == 1 or chunks // z >= MIN_SPLIT_CHUNKS), key=cost)


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
    if not w8.t().is_contiguous() or w8.data_ptr() % 16:
        raise ValueError(
            "the W8A16 kernel reads w8 N-major (quantization.pack_n_major), "
            "from a 16-byte-aligned base"
        )
    if scale.dtype != torch.float32 or scale.numel() != n or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous f32 [1, {n}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    check_weight({"w8": w8})


def _launch(kernel: int, x2: torch.Tensor, leaf: dict, bm: int, splits: int) -> torch.Tensor:
    """kubeai_w8a16_gemm on [M, K] rows x2 by `kernel` with `bm` rows a
    CTA and `splits` K splits, after the checks that keep a wrong operand
    from being read as another: ValueError or TypeError, never a launch."""
    w8, scale = leaf["w8"], leaf["scale"]
    _check_args(x2, w8, scale)
    if x2.dim() != 2 or not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("the W8A16 kernels read x as contiguous [M, K] rows from a "
                         "16-byte-aligned base")
    if x2.device.type != "cuda":
        raise ValueError(f"the W8A16 kernels have no path for {x2.device}")
    (m, k), n = x2.shape, w8.shape[1]
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    scratch = (torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
               if splits > 1 else None)
    status = _build.load().kubeai_w8a16_gemm(
        x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), m, n, k, kernel, bm, splits,
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check(status, "int8_linear")
    return out


def w8a16_skinny(x2: torch.Tensor, leaf: dict) -> torch.Tensor:
    """[M, K] @ dequantize(leaf) by the skinny kernel (M <= SKINNY_MAX_M)
    on CUDA tensors; the plain version on CPU tensors."""
    if x2.device.type == "cpu":
        return torch.matmul(x2, dequantize_as(leaf, x2.dtype))
    if x2.shape[0] > SKINNY_MAX_M:
        raise ValueError(f"the skinny W8A16 kernel takes at most {SKINNY_MAX_M} rows, "
                         f"got {x2.shape[0]}")
    out = _launch(SKINNY, x2, leaf, 1, 1)
    w8a16_skinny.launches += 1
    return out


def w8a16_wgmma(x2: torch.Tensor, leaf: dict) -> torch.Tensor:
    """[M, K] @ dequantize(leaf) by the wgmma kernel on CUDA tensors, with
    gemm_plan's rows a CTA and K splits; the plain version on CPU
    tensors."""
    if x2.device.type == "cpu":
        return torch.matmul(x2, dequantize_as(leaf, x2.dtype))
    m, k = x2.shape[0], x2.shape[-1]
    out = _launch(WGMMA, x2, leaf, *gemm_plan(m, leaf["w8"].shape[-1], k))
    w8a16_wgmma.launches += 1
    return out


def route(m: int):
    """The launcher int8_linear sends m rows to: the skinny kernel up to
    SKINNY_MAX_M rows, the wgmma kernel above."""
    return w8a16_skinny if m <= SKINNY_MAX_M else w8a16_wgmma


def int8_linear(x: torch.Tensor, leaf: dict) -> torch.Tensor:
    """x [..., K] @ dequantize(leaf) [K, N] -> [..., N]. CUDA tensors
    launch the kernel `route` chooses (bf16 x and out) or raise; CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return torch.matmul(x, dequantize_as(leaf, x.dtype))
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear has no path for {x.device}")
    n = leaf["w8"].shape[-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.data_ptr() % 16:  # the kernels read x in 16-byte vectors and boxes
        x2 = x2.clone()
    m = x2.shape[0]
    if not m:
        return torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=x.device)
    return route(m)(x2, leaf).reshape(*x.shape[:-1], n)


# Kernel launches since each count was last set to 0.
w8a16_skinny.launches = 0
w8a16_wgmma.launches = 0
