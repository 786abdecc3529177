"""Structural rules of the PyTorch/CUDA port: it imports neither JAX (nor
its ml_dtypes) nor the JAX package, its entry points never fall back to the CPU silently,
and the kernel wrappers launch nothing for CPU tensors."""

import ast
import ctypes
import pathlib

import pytest
import torch

import kubeai_tpu_torch
from kubeai_tpu_torch import device as tdevice
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
from kubeai_tpu_torch.ops.int8_matmul import int8_linear, w8a16_skinny, w8a16_wgmma
from kubeai_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_fused,
    paged_verify_attention,
)

WRAPPERS = (paged_decode_attention, paged_verify_attention,
            paged_decode_attention_fused, flash_causal_prefill, w8a16_skinny, w8a16_wgmma)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(kubeai_tpu_torch.__file__).resolve().parent
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.append(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    # ml_dtypes is JAX's dtype package: the port carries bf16 without it.
    return top in ("jax", "jaxlib", "kubeai_tpu", "ml_dtypes")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_kubeai_tpu_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("kubeai_tpu.engine")
    assert _forbidden("ml_dtypes")
    assert not _forbidden("kubeai_tpu_torch.engine") and not _forbidden("torch")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = tl.LlamaConfig.tiny()
    with pytest.raises(tdevice.NoCudaDevice):
        tdevice.resolve_device()
    with pytest.raises(tdevice.NoCudaDevice):
        tdevice.resolve_device("cuda")
    with pytest.raises(tdevice.NoCudaDevice):
        tl.init_params(cfg)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(tdevice.NoCudaDevice):
        Engine("llama", cfg, params)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw", [
    {}, dict(speculate=3, spec_adaptive=False), dict(decode_kernel="fused"),
    dict(quantization="int8"),
], ids=["per_layer", "speculate", "fused", "int8"])
def test_cpu_engine_launches_no_kernel(kw):
    for fn in WRAPPERS:
        fn.launches = 0
    cfg = tl.LlamaConfig.tiny()
    params = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine("llama", cfg, params, cfg=EngineConfig(**kw), device="cpu")
    out = eng.generate([[1, 2, 3], list(range(1, 40))],
                       SamplingParams(temperature=0.0, max_tokens=5))
    assert [len(o) for o in out] == [5, 5]
    assert [fn.launches for fn in WRAPPERS] == [0] * len(WRAPPERS)


def test_wrappers_refuse_devices_without_a_path():
    meta = dict(device="meta")
    q = torch.empty(2, 4, 64, dtype=torch.bfloat16, **meta)
    pool = torch.empty(3, 8, 2, 64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="no path"):
        paged_decode_attention(
            q, pool, pool, torch.zeros(2, 1, dtype=torch.int32, **meta),
            torch.ones(2, dtype=torch.int32, **meta))
    qs = torch.empty(1, 8, 4, 64, dtype=torch.bfloat16, **meta)
    kv = torch.empty(1, 8, 2, 64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="no path"):
        flash_causal_prefill(qs, kv, kv)
    bt = torch.zeros(2, 1, dtype=torch.int32, **meta)
    pos = torch.ones(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no path"):
        paged_verify_attention(
            torch.empty(2, 3, 4, 64, dtype=torch.bfloat16, **meta), pool, pool, bt, pos)
    stacked = torch.empty(2, 3, 8, 2, 64, dtype=torch.bfloat16, **meta)
    new = torch.empty(2, 2, 64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="no path"):
        paged_decode_attention_fused(q, stacked, stacked, new, new, bt, pos, 1)
    leaf = {"w8": torch.empty(64, 32, dtype=torch.int8, **meta),
            "scale": torch.empty(1, 32, **meta)}
    x = torch.empty(3, 64, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError, match="no path"):
        int8_linear(x, leaf)
    # The kernels' own launchers check their operands before the device: a
    # wrong dtype or layout raises, never reaches the kernel as other bytes.
    packed = {"w8": torch.empty(32, 64, dtype=torch.int8, **meta).t(),
              "scale": torch.empty(1, 32, **meta)}
    for launcher in (w8a16_skinny, w8a16_wgmma):
        with pytest.raises(ValueError, match="no path"):
            launcher(x, packed)
        with pytest.raises(TypeError, match="bf16 activations"):
            launcher(x.float(), packed)
        with pytest.raises(ValueError, match="N-major"):
            launcher(x, leaf)
        with pytest.raises(ValueError, match="contiguous"):
            launcher(x.reshape(1, 3, 64), packed)
    with pytest.raises(ValueError, match="at most 8 rows"):
        w8a16_skinny(torch.empty(9, 64, dtype=torch.bfloat16, **meta), packed)
    assert w8a16_skinny.launches == w8a16_wgmma.launches == 0


def test_kernel_sources_and_bindings():
    names = [p.name for p in _build.sources()]
    assert names == ["flash_prefill.cu", "paged_decode.cu",
                     "paged_decode_fused.cu", "paged_verify.cu", "w8a16_gemm.cu"]
    head = {p.name: p.read_text()[:600] for p in _build.sources()}
    assert "kubeai_tpu/ops/pallas_attention.py" in head["flash_prefill.cu"]
    # The W8A16 GEMM stands for no pallas_call: XLA's dequantize-into-dot.
    assert "kubeai_tpu/engine/quantization.py" in head["w8a16_gemm.cu"]
    for name, tpu_kernel in (("paged_decode.cu", "_paged_kernel"),
                             ("paged_verify.cu", "_paged_verify_kernel"),
                             ("paged_decode_fused.cu", "_paged_fused_kernel")):
        assert "kubeai_tpu/ops/paged_attention.py" in head[name]
        assert tpu_kernel in head[name]
    # Every entry point is defined in exactly one source.
    for fn in _build.SIGNATURES:
        assert sum(f'extern "C" int {fn}(' in p.read_text() for p in _build.sources()) == 1
    for p in _build.sources():
        src = p.read_text()
        for name in _build.SIGNATURES:
            if name in src:
                assert f'extern "C" int {name}(' in src
    # Pointers and the stream are c_void_p, never a 32-bit int.
    assert _build.SIGNATURES["kubeai_paged_decode_bf16"][:7] == (ctypes.c_void_p,) * 7
    assert _build.SIGNATURES["kubeai_paged_decode_bf16"][-1] is ctypes.c_void_p
    assert _build.SIGNATURES["kubeai_flash_prefill_bf16"][:4] == (ctypes.c_void_p,) * 4
    assert _build.SIGNATURES["kubeai_flash_prefill_bf16"][-1] is ctypes.c_void_p
    assert _build.SIGNATURES["kubeai_paged_verify_bf16"][:6] == (ctypes.c_void_p,) * 6
    assert _build.SIGNATURES["kubeai_paged_verify_bf16"][-1] is ctypes.c_void_p
    assert _build.SIGNATURES["kubeai_paged_decode_fused_bf16"][:8] == (ctypes.c_void_p,) * 8
    assert _build.SIGNATURES["kubeai_paged_decode_fused_bf16"][-1] is ctypes.c_void_p
    assert _build.SIGNATURES["kubeai_w8a16_gemm"][:4] == (ctypes.c_void_p,) * 4
    assert _build.SIGNATURES["kubeai_w8a16_gemm"][-1] is ctypes.c_void_p
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.build_dir().parent == ROOT / "build" / "kernels"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "kernels")
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.build()
