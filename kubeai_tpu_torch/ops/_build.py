"""Build and load the port's CUDA kernels.

On first use the `.cu` sources under `kubeai_tpu_torch/csrc/` are
compiled by `nvcc` for Hopper (`sm_90a`) into one shared library with a
plain C interface, which is loaded with `ctypes`. The build goes under
`build/kernels/<hash>/` at the root of the checkout (listed in
`.gitignore`), keyed by a hash of the sources and flags, so an unchanged
tree reuses its library and a changed one rebuilds.

Each source compiles to its own object file, all at once, and one link
makes the library. Nothing here includes PyTorch's headers: that keeps a
build to seconds. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libkubeai_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points of csrc/*.cu: name -> argtypes. Every pointer and the
# stream are c_void_p so ctypes never truncates them to 32 bits.
SIGNATURES = {
    # q, k_pages, v_pages, block_tables, lengths, out, scratch,
    # B, H, KVH, D, page_size, max_pages, num_splits, pages_per_split,
    # scale, softcap, window, stream
    "kubeai_paged_decode_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
        _I, _P,
    ),
    # q, k, v, out, B, S, H, KVH, D, scale, stream
    "kubeai_flash_prefill_bf16": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
    ),
    # q, k_pages, v_pages, block_tables, positions, out, scratch,
    # B, K, H, KVH, D, page_size, max_pages, num_splits, pages_per_split,
    # scale, softcap, window, stream
    "kubeai_paged_verify_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
        _I, _P,
    ),
    # q, k_pages, v_pages, k_new, v_new, block_tables, positions, out,
    # scratch, B, H, KVH, D, num_pages, page_size, max_pages, layer,
    # num_splits, pages_per_split, scale, softcap, window, stream
    "kubeai_paged_decode_fused_bf16": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _F, _F, _I, _P,
    ),
}


class KernelCompileError(RuntimeError):
    """nvcc is missing or refused a source."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds the last compile and link took in this process (0.0: none ran).
last_build_seconds = 0.0


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelCompileError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA kernels are built on the machine with the card"
    )


def build_dir() -> Path:
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists.
    Returns its path; the compiler's log is written beside it."""
    global last_build_seconds
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log = []
    failed = []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        (out_dir / "build.log").write_text("\n".join(log))
        raise KernelCompileError(
            f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(log)
        )
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    log.append(f"== link\n{link.stdout}")
    (out_dir / "build.log").write_text("\n".join(log))
    if link.returncode != 0:
        raise KernelCompileError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    last_build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with every argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(status: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status}")
