"""Checkpoint loading: Hugging Face-format directories to the port's
parameter dict. Counterpart of kubeai_tpu/engine/weights.py (the llama,
qwen, gemma, mixtral and whisper loaders, `resolve_model_dir` and
`load_params`).

Tensors are read lazily, as in the JAX package: safetensors headers are
parsed once, and each tensor is seek-read from its shard only when its
slot is filled. The JAX loader widens each tensor to f32 on the host and
stacks each layer into a host bf16 buffer; here every leaf is a
`torch.bfloat16` tensor preallocated on the target device and filled one
tensor at a time: the tensor goes to the device as stored, where it is
cast (round to nearest even, as ml_dtypes casts) and transposed into its
slot. Peak host memory is one tensor as stored (1.05 GB for an 8B
model's bf16 embedding), not a host copy of the model. The loaded dict
is bit-equal to the JAX loader's tree.

Sources: local directories, `pvc://` (the operator mounts the PVC at
/model), `hf://` (through huggingface_hub) and the object stores
(`gs://`, `s3://`, `oss://`, `file://`; kubeai_tpu_torch/objstore.py),
downloaded into the same `$KUBEAI_WEIGHTS_CACHE` directory the JAX
package uses, so a node's replicas of either package share it.
Mixtral's expert stacks are filled expert by expert into their slots on
the device, where the JAX loader builds a host buffer of each whole
[NL, X, in, out] stack (30 GB each, 90 GB for the three, at
Mixtral-8x7B's full depth).
Whisper's loader keeps the JAX package's nested tree in f32 (the JAX
entry point passes `load_params`' bf16 default to it, which its model
cannot run: ROADMAP fault C13).

Under a mesh each rank loads only its shard (`load_params(shard=
ShardPlan(...))`): the cuts `Engine._shard` makes of the full tree (the
family's `param_specs` over the tp dim, wk/wv cut to one KV head where
tp exceeds the KV heads), read as slices of each checkpoint tensor, so
no rank holds the full tree on the host or the card. With int8 weights
(`ShardPlan(quantize=True)`) every layer weight is quantized as the
engine quantizes the full tree: a row-parallel weight (wo, w_down), whose
per-output-column scale spans the whole input dim, is read whole one
layer at a time, quantized, then cut; the others are cut first, which
gives the same bits.

`save_safetensors` writes a checkpoint in the same format; tests and
`chip_smoke.py` use it to make checkpoints from random weights.
`save_native_checkpoint` / `load_native_checkpoint` keep the tree the
engine is built from (after conversion and quantization) in the port's
own format, where the JAX package uses orbax: a boot snapshot
(engine/coldstart.py) restores it without converting again.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from kubeai_tpu_torch import objstore
from kubeai_tpu_torch.device import resolve_device
from kubeai_tpu_torch.engine.quantization import QUANTIZABLE, quantize_tensor, quantized_specs
from kubeai_tpu_torch.parallel import sharding as psh
from kubeai_tpu_torch.parallel.collectives import TpLayout

logger = logging.getLogger(__name__)


class WeightLoadError(RuntimeError):
    pass


def load_hf_config(model_dir: str) -> dict:
    path = os.path.join(model_dir, "config.json")
    if not os.path.exists(path):
        raise WeightLoadError(f"no config.json under {model_dir}")
    with open(path) as f:
        return json.load(f)


_ST_DTYPES = {
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I8": torch.int8,
    "U8": torch.uint8,
}


def _decode_raw(raw: np.ndarray, dtype_s: str, shape, name: str) -> torch.Tensor:
    """A tensor of the stored dtype and shape over the raw little-endian
    bytes `raw` (uint8), without a copy."""
    dtype = _ST_DTYPES.get(dtype_s)
    if dtype is None:
        raise WeightLoadError(f"unsupported dtype {dtype_s} for {name}")
    return torch.from_numpy(raw).view(dtype).reshape(shape)


# Bytes of rows a column slice reads at a time (LazyTensors.stored_slice).
SLICE_BLOCK = 32 << 20


class LazyTensors:
    """Lazy tensor mapping over a checkpoint directory.

    safetensors: headers parsed up front, tensor data seek-read on
    demand: nothing resident until requested, nothing cached after.
    pytorch_model*.bin: loaded eagerly with torch.load(weights_only=True)
    (torch pickles do not support random access)."""

    def __init__(self, model_dir: str):
        self._index: dict[str, tuple[str, str, list, int, int]] = {}
        self._eager: dict[str, torch.Tensor] | None = None
        st_files = sorted(
            f for f in os.listdir(model_dir) if f.endswith(".safetensors")
        )
        if st_files:
            for fname in st_files:
                fpath = os.path.join(model_dir, fname)
                with open(fpath, "rb") as f:
                    header_len = int.from_bytes(f.read(8), "little")
                    header = json.loads(f.read(header_len))
                    base = 8 + header_len
                for name, meta in header.items():
                    if name == "__metadata__":
                        continue
                    start, end = meta["data_offsets"]
                    self._index[name] = (
                        fpath, meta["dtype"], meta["shape"],
                        base + start, end - start,
                    )
            return
        bin_files = sorted(
            f for f in os.listdir(model_dir)
            if f.endswith(".bin") and f.startswith("pytorch_model")
        )
        if not bin_files:
            raise WeightLoadError(
                f"no safetensors or pytorch_model*.bin in {model_dir}"
            )
        self._eager = {}
        for fname in bin_files:
            self._eager.update(torch.load(
                os.path.join(model_dir, fname), map_location="cpu",
                weights_only=True,
            ))

    def __contains__(self, name: str) -> bool:
        if self._eager is not None:
            return name in self._eager
        return name in self._index

    def keys(self):
        return (self._eager or self._index).keys()

    def stored(self, name: str) -> torch.Tensor:
        """One tensor as the checkpoint stores it (dtype and shape), on the
        CPU, freshly read: copy it into its target and drop it."""
        if self._eager is not None:
            return self._eager[name]
        if name not in self._index:
            raise KeyError(name)
        fpath, dtype_s, shape, offset, nbytes = self._index[name]
        raw = np.empty(nbytes, np.uint8)
        with open(fpath, "rb") as f:
            f.seek(offset)
            if f.readinto(memoryview(raw)) != nbytes:
                raise WeightLoadError(f"{fpath}: short read of {name}")
        return _decode_raw(raw, dtype_s, shape, name)

    def __getitem__(self, name: str) -> torch.Tensor:
        """f32 CPU tensor of one tensor, freshly read."""
        return self.stored(name).to(torch.float32)

    def stored_slice(self, name: str, axis: int, start: int, length: int) -> torch.Tensor:
        """`stored(name).narrow(axis, start, length)`, holding no more of
        the tensor on the host than the slice and one block of rows: a cut
        of axis 0 is one read; a cut of a matrix's columns reads its rows
        SLICE_BLOCK bytes at a time and keeps the slice's columns."""
        if self._eager is not None:
            return self._eager[name].narrow(axis, start, length).contiguous()
        fpath, dtype_s, shape, offset, nbytes = self._index[name]
        if dtype_s not in _ST_DTYPES:
            raise WeightLoadError(f"unsupported dtype {dtype_s} for {name}")
        size = _ST_DTYPES[dtype_s].itemsize
        cut = list(shape)
        cut[axis] = length
        out = np.empty(int(np.prod(cut)) * size, np.uint8)
        with open(fpath, "rb") as f:
            if axis == 0:
                f.seek(offset + start * (nbytes // shape[0]))
                got = f.readinto(memoryview(out))
            elif axis == 1 and len(shape) == 2:
                width = shape[1] * size
                cols = slice(start * size, (start + length) * size)
                dst = out.reshape(shape[0], length * size)
                per = max(1, SLICE_BLOCK // width)
                got = out.size
                for r in range(0, shape[0], per):
                    block = np.empty((min(per, shape[0] - r), width), np.uint8)
                    f.seek(offset + r * width)
                    if f.readinto(memoryview(block).cast("B")) != block.size:
                        got = -1
                    dst[r:r + len(block)] = block[:, cols]
            else:
                raise WeightLoadError(f"{name}: no slice of axis {axis} of shape {shape}")
        if got != out.size:
            raise WeightLoadError(f"{fpath}: short read of {name}")
        return _decode_raw(out, dtype_s, cut, name)


class ShardPlan:
    """This rank's cut of each leaf of a family's tree under a mesh, the
    one owner of the rules: `param_specs` through the sharding rules over
    the mesh (`sharding.leaf_cuts`), and where tp exceeds the KV heads,
    wk/wv and their biases kept whole by the rules, then cut to the KV
    head this rank's q heads read. The loaders read each leaf's cut from
    the checkpoint (`load_params(shard=)`); `Engine` cuts a full tree in
    memory with `shard`. `quantize`: the loaded layer weights come
    quantized to int8, as the engine's EngineConfig(quantization="int8")
    would make them."""

    def __init__(self, family, model_cfg, mesh, quantize: bool = False):
        if family.param_specs is None:
            raise WeightLoadError(f"the {family.name} family has no sharding specs")
        self.mesh = mesh
        self.quantize = quantize
        self.specs = family.param_specs(model_cfg)
        tp = TpLayout.of(mesh)
        tp.local_heads(model_cfg.num_heads)
        kvh = model_cfg.num_kv_heads
        self.rules = psh.DEFAULT_RULES
        self.kv_cut = None
        if tp.kv_replicated(kvh):
            self.rules = self.rules.replicating(psh.KV_HEADS)
            d = model_cfg.head_size
            self.kv_cut = (tp.kv_head(kvh) * d, d)

    def _kv_cuts(self, name: str, ndim: int) -> list[tuple[int, int, int]]:
        """The cut to this rank's KV head of a leaf of layer weight `name`
        (its last axis), where tp exceeds the KV heads."""
        if self.kv_cut is not None and name in ("wk", "wv", "bk", "bv"):
            return [(ndim - 1, *self.kv_cut)]
        return []

    def cut(self, path: str, shape) -> tuple[int, int, int] | None:
        """(axis, start, length) of the rank's block of the leaf at `path`
        ("embed", "layers.wq", ...) of full shape `shape`, or None when
        the rank keeps it whole: what a loader reads of the tensor."""
        axes = self.specs
        for key in path.split("."):
            axes = axes[key]
        try:
            cuts = psh.leaf_cuts(shape, self.rules.spec(axes), self.mesh)
        except ValueError as e:
            raise WeightLoadError(f"{path}: {e}") from None
        cuts += self._kv_cuts(path.split(".")[-1], len(shape))
        if len(cuts) > 1:
            raise WeightLoadError(f"{path}: a rank-local load reads one cut a tensor, not {cuts}")
        return cuts[0] if cuts else None

    def shard(self, params: dict) -> dict:
        """The rank's shard of a full in-memory tree (`sharding.shard_params`
        under the plan's rules, quantized leaves too, then the KV-head
        cut)."""
        specs = quantized_specs(self.specs, params["layers"])
        if "lm_head" in params and "lm_head" not in specs:
            # A tree that carries gemma's tied head beside `embed`
            # (parity.params_from_numpy): the same tensor, the same cut.
            specs = {**specs, "lm_head": specs["embed"]}
        shard = psh.shard_params(params, specs, self.mesh, self.rules)
        layers = shard["layers"]
        for name in ("wk", "wv", "bk", "bv"):
            leaf = layers.get(name)
            if isinstance(leaf, dict):  # quantized: w8 and its scale
                layers[name] = {k: psh.narrow(v, self._kv_cuts(name, v.dim()))
                                for k, v in leaf.items()}
            elif leaf is not None:
                layers[name] = psh.narrow(leaf, self._kv_cuts(name, leaf.dim()))
        return shard


def _stream_helpers(model_dir: str, NL: int, dtype, device: torch.device,
                    shard: ShardPlan | None = None):
    """(tensors, stack, leaf): the streamed-assembly kit. `leaf` and
    `stack` fill tensors preallocated in `dtype` on `device`, one
    checkpoint tensor at a time, copied as stored; the cast runs on the
    device. With a `shard`, each takes the port path of the leaf it
    fills and keeps the rank's block of it (see ShardPlan), and `stack`
    returns a quantized leaf for a layer weight when the plan quantizes."""
    t = LazyTensors(model_dir)

    def shape_of(name: str) -> list:
        if name not in t:
            raise WeightLoadError(f"missing tensor {name}")
        return list(t.stored(name).shape) if t._eager is not None else list(t._index[name][2])

    def get(name: str, cut=None) -> torch.Tensor:
        if name not in t:
            raise WeightLoadError(f"missing tensor {name}")
        if cut is None:
            return t.stored(name).to(device)
        return t.stored_slice(name, *cut).to(device)

    def leaf(name: str, path: str = "") -> torch.Tensor:
        cut = shard.cut(path, shape_of(name)) if shard is not None else None
        a = get(name, cut)
        out = torch.empty(a.shape, dtype=dtype, device=device)
        out.copy_(a)
        return out

    def stack(fmt: str, transpose: bool = True, path: str = ""):
        cut = None
        if shard is not None:
            layer = shape_of(fmt.format(i=0))
            full = [NL, *(layer[::-1] if transpose else layer)]
            cut = shard.cut(path, full)
        if cut is not None:
            # The axis within one stored (untransposed) layer tensor.
            axis = cut[0] - 1
            if transpose:
                axis = 1 - axis
            cut = (axis, cut[1], cut[2])
        if shard is not None and shard.quantize and path.split(".")[-1] in QUANTIZABLE:
            return _quantized_stack(get, fmt, NL, dtype, device, cut)
        buf = None
        for i in range(NL):
            a = get(fmt.format(i=i), cut)
            if transpose:
                a = a.T
            if buf is None:
                buf = torch.empty((NL, *a.shape), dtype=dtype, device=device)
            buf[i].copy_(a)  # casts to dtype in place
            del a
        return buf

    return t, stack, leaf


def _quantized_stack(get, fmt: str, NL: int, dtype, device, cut) -> dict:
    """A quantized [NL, in, out] leaf of the layer weights `fmt` (stored
    [out, in]) with the rank's cut `cut` of one stored layer (None: whole):
    each layer cast to `dtype` and quantized as quantize_tensor quantizes
    the engine's tree. A cut of the input axis (stored axis 1: a
    row-parallel weight) reads the layer whole, quantizes it over its
    whole rows, then keeps the rank's rows of w8 (the scales are per
    output column); any other cut is taken first, as the scales of the
    columns kept do not depend on the others."""
    rows_cut = cut is not None and cut[0] == 1
    w8 = scale = None
    for i in range(NL):
        a = get(fmt.format(i=i), None if rows_cut else cut)
        w = torch.empty(a.shape[::-1], dtype=dtype, device=device)
        w.copy_(a.T)
        del a
        q = quantize_tensor(w)
        if rows_cut:
            q["w8"] = q["w8"].narrow(0, cut[1], cut[2])
        if w8 is None:
            k, n = q["w8"].shape
            w8 = torch.empty((NL, n, k), dtype=torch.int8, device=device).transpose(-1, -2)
            scale = torch.empty((NL, 1, n), dtype=torch.float32, device=device)
        w8[i].copy_(q["w8"])
        scale[i].copy_(q["scale"])
    return {"w8": w8, "scale": scale}


def load_llama_params(
    model_dir: str, cfg, dtype=torch.bfloat16,
    device: str | torch.device | None = None, shard: ShardPlan | None = None,
) -> dict:
    """Map a HF LlamaForCausalLM (or Qwen2ForCausalLM) checkpoint onto
    the port's stacked-layer dict (kubeai_tpu_torch.models.llama).

    HF stores per-layer `model.layers.{i}.self_attn.q_proj.weight` with
    shape [out, in]; the port's layout stacks layers and keeps
    [in, out], as the JAX package's does. `device` defaults to cuda.
    `shard`: the rank's shard only (ShardPlan)."""
    dev = resolve_device(device)
    t, stack, leaf = _stream_helpers(model_dir, cfg.num_layers, dtype, dev, shard)

    def layer(hf: str, name: str, transpose: bool = True):
        return stack(f"model.layers.{{i}}.{hf}", transpose, f"layers.{name}")

    extra_layers = {}
    if getattr(cfg, "attention_bias", False):
        extra_layers = {
            b: layer(f"self_attn.{p}_proj.bias", b, transpose=False)
            for b, p in (("bq", "q"), ("bk", "k"), ("bv", "v"))
        }
    params = {
        "embed": leaf("model.embed_tokens.weight", "embed"),
        "layers": {
            "input_norm": layer("input_layernorm.weight", "input_norm", transpose=False),
            "wq": layer("self_attn.q_proj.weight", "wq"),
            "wk": layer("self_attn.k_proj.weight", "wk"),
            "wv": layer("self_attn.v_proj.weight", "wv"),
            "wo": layer("self_attn.o_proj.weight", "wo"),
            "post_attn_norm": layer(
                "post_attention_layernorm.weight", "post_attn_norm", transpose=False
            ),
            "w_gate": layer("mlp.gate_proj.weight", "w_gate"),
            "w_up": layer("mlp.up_proj.weight", "w_up"),
            "w_down": layer("mlp.down_proj.weight", "w_down"),
            **extra_layers,
        },
        "final_norm": leaf("model.norm.weight", "final_norm"),
    }
    if "lm_head.weight" in t:
        params["lm_head"] = leaf("lm_head.weight", "lm_head")
    else:  # tied embeddings
        params["lm_head"] = params["embed"]
    return params


def load_gemma_params(
    model_dir: str, cfg, dtype=torch.bfloat16,
    device: str | torch.device | None = None, shard: ShardPlan | None = None,
) -> dict:
    """Map a HF GemmaForCausalLM or Gemma2ForCausalLM checkpoint onto the
    port's stacked-layer dict (kubeai_tpu_torch.models.gemma). Gemma-1's
    `post_attention_layernorm` is its pre-MLP norm; Gemma-2 names the
    pre-MLP norm `pre_feedforward_layernorm` and adds the post-attention
    and post-MLP norms. Logits are tied to the embedding: no lm_head.
    `device` defaults to cuda. `shard`: the rank's shard only (ShardPlan);
    the embedding is read once, as the rank's vocabulary block, and
    serves as both the embedding and the lm_head block."""
    dev = resolve_device(device)
    _, stack, leaf = _stream_helpers(model_dir, cfg.num_layers, dtype, dev, shard)

    def layer(hf: str, name: str, transpose: bool = True):
        return stack(f"model.layers.{{i}}.{hf}.weight", transpose, f"layers.{name}")

    layers = {
        "input_norm": layer("input_layernorm", "input_norm", transpose=False),
        "wq": layer("self_attn.q_proj", "wq"),
        "wk": layer("self_attn.k_proj", "wk"),
        "wv": layer("self_attn.v_proj", "wv"),
        "wo": layer("self_attn.o_proj", "wo"),
        "w_gate": layer("mlp.gate_proj", "w_gate"),
        "w_up": layer("mlp.up_proj", "w_up"),
        "w_down": layer("mlp.down_proj", "w_down"),
    }
    if cfg.sandwich_norms:
        layers["post_attn_norm"] = layer("post_attention_layernorm", "post_attn_norm", False)
        layers["pre_mlp_norm"] = layer("pre_feedforward_layernorm", "pre_mlp_norm", False)
        layers["post_mlp_norm"] = layer("post_feedforward_layernorm", "post_mlp_norm", False)
    else:
        layers["pre_mlp_norm"] = layer("post_attention_layernorm", "pre_mlp_norm", False)
    return {
        "embed": leaf("model.embed_tokens.weight", "embed"),
        "layers": layers,
        "final_norm": leaf("model.norm.weight", "final_norm"),
    }


def load_mixtral_params(
    model_dir: str, cfg, dtype=torch.bfloat16,
    device: str | torch.device | None = None, shard: ShardPlan | None = None,
) -> dict:
    """Map a HF MixtralForCausalLM checkpoint onto the port's mixtral
    dict (kubeai_tpu_torch.models.mixtral): llama's attention leaves,
    `block_sparse_moe.gate` as the router [NL, E, X], and each expert's
    w1 (gate), w3 (up) and w2 (down), stored [out, in], as slots of the
    stacks `w_gate` / `w_up` [NL, E, X, M] and `w_down` [NL, X, M, E]. The
    values are the JAX loader's bit for bit; only the gate and up stacks'
    axis order differs (the JAX layout is [NL, X, E, M]). `device`
    defaults to cuda. `shard`: the rank's shard only (ShardPlan): the
    rank's experts are the only ones read."""
    dev = resolve_device(device)
    NL, X = cfg.num_layers, cfg.num_experts
    E, M = cfg.hidden_size, cfg.intermediate_size
    t, stack, leaf = _stream_helpers(model_dir, NL, dtype, dev, shard)
    first = 0
    if shard is not None:
        cut = shard.cut("layers.w_down", (NL, X, M, E))
        if cut is not None:
            if cut[0] != 1 or shard.cut("layers.w_gate", (NL, E, X, M))[0] != 2:
                raise WeightLoadError("mixtral's experts shard only over the expert axis")
            first, X = cut[1], cut[2]

    def expert(i: int, e: int, w: str) -> torch.Tensor:
        name = f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}.weight"
        if name not in t:
            raise WeightLoadError(f"missing tensor {name}")
        return t.stored(name).to(dev).T  # [in, out]

    w_gate = torch.empty((NL, E, X, M), dtype=dtype, device=dev)
    w_up = torch.empty((NL, E, X, M), dtype=dtype, device=dev)
    w_down = torch.empty((NL, X, M, E), dtype=dtype, device=dev)
    for i in range(NL):
        for e in range(X):
            w_gate[i, :, e].copy_(expert(i, first + e, "w1"))  # casts to dtype in place
            w_up[i, :, e].copy_(expert(i, first + e, "w3"))
            w_down[i, e].copy_(expert(i, first + e, "w2"))

    def layer(hf: str, name: str, transpose: bool = True):
        return stack(f"model.layers.{{i}}.{hf}", transpose, f"layers.{name}")

    return {
        "embed": leaf("model.embed_tokens.weight", "embed"),
        "layers": {
            "input_norm": layer("input_layernorm.weight", "input_norm", transpose=False),
            "wq": layer("self_attn.q_proj.weight", "wq"),
            "wk": layer("self_attn.k_proj.weight", "wk"),
            "wv": layer("self_attn.v_proj.weight", "wv"),
            "wo": layer("self_attn.o_proj.weight", "wo"),
            "post_attn_norm": layer(
                "post_attention_layernorm.weight", "post_attn_norm", transpose=False
            ),
            "router": layer("block_sparse_moe.gate.weight", "router"),
            "w_gate": w_gate,
            "w_up": w_up,
            "w_down": w_down,
        },
        "final_norm": leaf("model.norm.weight", "final_norm"),
        "lm_head": leaf("lm_head.weight", "lm_head"),
    }


def resolve_model_dir(model_url: str, model_dir: str = "") -> str:
    """Resolve a Model URL to a local directory.

    pvc://name/path -> /model/path (the operator mounts the PVC at
    /model); hf://repo -> a huggingface_hub snapshot; gs://, s3://,
    oss:// and file:// -> a download into the weights cache; plain paths
    pass through. `model_dir` (the cache dir) wins when set."""
    if model_dir:
        return model_dir
    if model_url.startswith("pvc://"):
        ref = model_url[len("pvc://"):]
        sub = ref.split("/", 1)[1] if "/" in ref else ""
        return os.path.join("/model", sub) if sub else "/model"
    if model_url.startswith("hf://"):
        repo = model_url[len("hf://"):].split("?")[0]
        try:
            from huggingface_hub import snapshot_download

            return snapshot_download(repo)
        except Exception as e:
            raise WeightLoadError(
                f"cannot download {repo} (offline?): {e}"
            ) from e
    if model_url.split("://")[0] in ("s3", "gs", "oss", "file"):
        return _download_to_cache(model_url)
    if os.path.isdir(model_url):
        return model_url
    raise WeightLoadError(f"unsupported model url {model_url!r}")


def _download_to_cache(model_url: str) -> str:
    """An object-store checkpoint's local copy: every object under the
    URL streamed to disk one at a time into
    `$KUBEAI_WEIGHTS_CACHE/<sha256(url)[:16]>`, as the JAX package's
    loader names it, with a `.kubeai-complete` marker. The download goes
    into a process-private staging directory that is renamed into place
    whole, so replicas sharing the cache (of either package) never read
    a half-written shard, and the loser of the rename race uses the
    winner's copy. A complete directory is reused without a request."""
    cache_root = os.environ.get("KUBEAI_WEIGHTS_CACHE", "/tmp/kubeai-weights")
    digest = hashlib.sha256(model_url.encode()).hexdigest()[:16]
    dest = os.path.join(cache_root, digest)
    done_marker = os.path.join(dest, ".kubeai-complete")
    if os.path.exists(done_marker):
        return dest
    os.makedirs(cache_root, exist_ok=True)
    staging = tempfile.mkdtemp(dir=cache_root, prefix=f".{digest}-")
    try:
        t0 = time.perf_counter()
        try:
            paths = objstore.download_prefix(model_url.split("?")[0], staging)
        except objstore.ObjStoreError as e:
            raise WeightLoadError(f"cannot download {model_url}: {e}") from e
        logger.info(
            "downloaded %d objects, %d bytes from %s in %.3f s", len(paths),
            sum(os.path.getsize(p) for p in paths), model_url,
            time.perf_counter() - t0,
        )
        with open(os.path.join(staging, ".kubeai-complete"), "w") as f:
            f.write(model_url)
        try:
            os.rename(staging, dest)
        except OSError:
            if not os.path.exists(done_marker):
                raise
    finally:
        if os.path.exists(staging):
            shutil.rmtree(staging, ignore_errors=True)
    return dest


def load_whisper_params(
    model_dir: str, cfg, dtype=torch.float32,
    device: str | torch.device | None = None,
) -> dict:
    """Map a HF WhisperForConditionalGeneration checkpoint onto the port's
    whisper tree (kubeai_tpu_torch.models.whisper): [out, in] projections
    become [in, out], the conv kernels [out, in, k] become [k, in, out].
    `device` defaults to cuda."""
    dev = resolve_device(device)
    t = LazyTensors(model_dir)

    def get(name: str, *perm: int) -> torch.Tensor:
        if name not in t:
            raise WeightLoadError(f"missing tensor {name}")
        a = t.stored(name).to(dev)
        return (a.permute(*perm) if perm else a).to(dtype).contiguous()

    def attn(prefix: str) -> dict:
        return {
            "wq": get(f"{prefix}.q_proj.weight", 1, 0),
            "bq": get(f"{prefix}.q_proj.bias"),
            "wk": get(f"{prefix}.k_proj.weight", 1, 0),
            "wv": get(f"{prefix}.v_proj.weight", 1, 0),
            "bv": get(f"{prefix}.v_proj.bias"),
            "wo": get(f"{prefix}.out_proj.weight", 1, 0),
            "bo": get(f"{prefix}.out_proj.bias"),
        }

    def ln(name: str) -> dict:
        return {"w": get(f"{name}.weight"), "b": get(f"{name}.bias")}

    def ffn(prefix: str) -> dict:
        return {
            "w1": get(f"{prefix}.fc1.weight", 1, 0), "b1": get(f"{prefix}.fc1.bias"),
            "w2": get(f"{prefix}.fc2.weight", 1, 0), "b2": get(f"{prefix}.fc2.bias"),
        }

    enc, dec = "model.encoder", "model.decoder"
    return {
        "conv1_w": get(f"{enc}.conv1.weight", 2, 1, 0),
        "conv1_b": get(f"{enc}.conv1.bias"),
        "conv2_w": get(f"{enc}.conv2.weight", 2, 1, 0),
        "conv2_b": get(f"{enc}.conv2.bias"),
        "enc_pos": get(f"{enc}.embed_positions.weight"),
        "enc_layers": [
            {
                "ln1": ln(f"{enc}.layers.{i}.self_attn_layer_norm"),
                "attn": attn(f"{enc}.layers.{i}.self_attn"),
                "ln2": ln(f"{enc}.layers.{i}.final_layer_norm"),
                "ffn": ffn(f"{enc}.layers.{i}"),
            }
            for i in range(cfg.encoder_layers)
        ],
        "enc_ln": ln(f"{enc}.layer_norm"),
        "dec_embed": get(f"{dec}.embed_tokens.weight"),
        "dec_pos": get(f"{dec}.embed_positions.weight"),
        "dec_layers": [
            {
                "ln1": ln(f"{dec}.layers.{i}.self_attn_layer_norm"),
                "self_attn": attn(f"{dec}.layers.{i}.self_attn"),
                "ln2": ln(f"{dec}.layers.{i}.encoder_attn_layer_norm"),
                "cross_attn": attn(f"{dec}.layers.{i}.encoder_attn"),
                "ln3": ln(f"{dec}.layers.{i}.final_layer_norm"),
                "ffn": ffn(f"{dec}.layers.{i}"),
            }
            for i in range(cfg.decoder_layers)
        ],
        "dec_ln": ln(f"{dec}.layer_norm"),
    }


def whisper_hf_tensors(params: dict, cfg) -> dict[str, torch.Tensor]:
    """The port's whisper tree under the HF WhisperForConditionalGeneration
    names and layouts (the inverse of `load_whisper_params`), for
    `save_safetensors`: tests and chip_smoke.py write checkpoints with it."""
    out: dict[str, torch.Tensor] = {}

    def put(name: str, a: torch.Tensor, *perm: int) -> None:
        out[name] = (a.permute(*perm) if perm else a).contiguous()

    def attn(prefix: str, p: dict) -> None:
        for w, b, hf in (("wq", "bq", "q_proj"), ("wk", None, "k_proj"),
                         ("wv", "bv", "v_proj"), ("wo", "bo", "out_proj")):
            put(f"{prefix}.{hf}.weight", p[w], 1, 0)
            if b is not None:
                put(f"{prefix}.{hf}.bias", p[b])

    def ln(name: str, p: dict) -> None:
        put(f"{name}.weight", p["w"])
        put(f"{name}.bias", p["b"])

    def ffn(prefix: str, p: dict) -> None:
        put(f"{prefix}.fc1.weight", p["w1"], 1, 0)
        put(f"{prefix}.fc1.bias", p["b1"])
        put(f"{prefix}.fc2.weight", p["w2"], 1, 0)
        put(f"{prefix}.fc2.bias", p["b2"])

    enc, dec = "model.encoder", "model.decoder"
    put(f"{enc}.conv1.weight", params["conv1_w"], 2, 1, 0)
    put(f"{enc}.conv1.bias", params["conv1_b"])
    put(f"{enc}.conv2.weight", params["conv2_w"], 2, 1, 0)
    put(f"{enc}.conv2.bias", params["conv2_b"])
    put(f"{enc}.embed_positions.weight", params["enc_pos"])
    for i, lp in enumerate(params["enc_layers"]):
        ln(f"{enc}.layers.{i}.self_attn_layer_norm", lp["ln1"])
        attn(f"{enc}.layers.{i}.self_attn", lp["attn"])
        ln(f"{enc}.layers.{i}.final_layer_norm", lp["ln2"])
        ffn(f"{enc}.layers.{i}", lp["ffn"])
    ln(f"{enc}.layer_norm", params["enc_ln"])
    put(f"{dec}.embed_tokens.weight", params["dec_embed"])
    put(f"{dec}.embed_positions.weight", params["dec_pos"])
    for i, lp in enumerate(params["dec_layers"]):
        ln(f"{dec}.layers.{i}.self_attn_layer_norm", lp["ln1"])
        attn(f"{dec}.layers.{i}.self_attn", lp["self_attn"])
        ln(f"{dec}.layers.{i}.encoder_attn_layer_norm", lp["ln2"])
        attn(f"{dec}.layers.{i}.encoder_attn", lp["cross_attn"])
        ln(f"{dec}.layers.{i}.final_layer_norm", lp["ln3"])
        ffn(f"{dec}.layers.{i}", lp["ffn"])
    ln(f"{dec}.layer_norm", params["dec_ln"])
    return out


_LOADERS = {
    "llama": load_llama_params,
    "qwen": load_llama_params,  # same layout + biases (attention_bias)
    "gemma": load_gemma_params,
    "mixtral": load_mixtral_params,
    "whisper": load_whisper_params,
}
# Architectures of the JAX package's families whose models are not
# ported yet, with their family: none since mixtral (ROADMAP A item 10d).
UNPORTED_ARCHITECTURES: dict[str, str] = {}


# The loaders that take a ShardPlan (the families with sharding specs).
_SHARDED_LOADERS = ("llama", "qwen", "gemma", "mixtral")


def load_params(
    family_name: str, model_dir: str, cfg, dtype=torch.bfloat16,
    device: str | torch.device | None = None, shard: ShardPlan | None = None,
) -> dict:
    """Family-dispatching checkpoint loader. `shard`: this rank's shard
    only, for an engine built with `presharded=True`."""
    if family_name in UNPORTED_ARCHITECTURES.values():
        raise WeightLoadError(
            f"the {family_name} family is not ported yet (ROADMAP A item 10)"
        )
    if family_name not in _LOADERS:
        raise WeightLoadError(f"no weight loader for family {family_name!r}")
    if shard is not None:
        if family_name not in _SHARDED_LOADERS:
            raise WeightLoadError(f"the {family_name} family loads no shard")
        return _LOADERS[family_name](model_dir, cfg, dtype, device, shard)
    return _LOADERS[family_name](model_dir, cfg, dtype, device)


_TORCH_ST_DTYPES = {
    torch.float32: "F32",
    torch.float16: "F16",
    torch.bfloat16: "BF16",
    torch.int64: "I64",
    torch.int32: "I32",
    torch.int8: "I8",
    torch.uint8: "U8",
}


def _write_safetensors(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """Write `tensors` as one safetensors file: an 8-byte little-endian
    header length, the JSON header padded with spaces to 8 bytes, then
    each tensor's raw little-endian bytes in order."""
    header: dict = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _TORCH_ST_DTYPES:
            raise WeightLoadError(f"unsupported dtype {t.dtype} for {name}")
        nbytes = t.numel() * t.element_size()
        header[name] = {
            "dtype": _TORCH_ST_DTYPES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())


def save_safetensors(
    model_dir: str, tensors: dict[str, torch.Tensor], config: dict
) -> None:
    """Write `tensors` as `model_dir/model.safetensors` and `config` as
    `model_dir/config.json`."""
    os.makedirs(model_dir, exist_ok=True)
    _write_safetensors(os.path.join(model_dir, "model.safetensors"), tensors)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


NATIVE_TREE = "tree.json"
NATIVE_TENSORS = "params.safetensors"


def save_native_checkpoint(path: str, params) -> None:
    """Write a param tree (nested dicts of tensors, int8 `{"w8",
    "scale"}` leaves included) as `path/params.safetensors`, one
    entry per tensor under its dotted path, and `path/tree.json`, the
    tree with each tensor replaced by its entry's name. No pickling. A
    tensor that appears twice in the tree (a tied `lm_head`) is written
    once and restored as one tensor. A tensor whose last two axes are
    stored transposed (the N-major int8 weights) is written in its memory
    order and listed under "transposed", so it comes back in that order."""
    tensors: dict[str, torch.Tensor] = {}
    names: dict[int, str] = {}
    transposed: list[str] = []

    def walk(node, name: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{name}.{k}" if name else str(k))
                    for k, v in node.items()}
        if not isinstance(node, torch.Tensor):
            raise WeightLoadError(f"{name}: not a tensor ({type(node).__name__})")
        if id(node) in names:
            return names[id(node)]
        names[id(node)] = name
        if (node.dim() >= 2 and not node.is_contiguous()
                and node.transpose(-1, -2).is_contiguous()):
            transposed.append(name)
            node = node.transpose(-1, -2)
        tensors[name] = node
        return name

    tree = walk(params, "")
    os.makedirs(path, exist_ok=True)
    _write_safetensors(os.path.join(path, NATIVE_TENSORS), tensors)
    with open(os.path.join(path, NATIVE_TREE), "w") as f:
        json.dump({"tree": tree, "transposed": transposed}, f)


def load_native_checkpoint(path: str, device: str | torch.device | None = None):
    """The tree `save_native_checkpoint` wrote, bit for bit, with every
    tensor on `device` (default cuda), in the layout it was saved in."""
    dev = resolve_device(device)
    with open(os.path.join(path, NATIVE_TREE)) as f:
        meta = json.load(f)
    stored = LazyTensors(path)
    transposed = set(meta["transposed"])
    loaded: dict[str, torch.Tensor] = {}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if node not in loaded:
            t = stored.stored(node).to(dev)
            loaded[node] = t.transpose(-1, -2) if node in transposed else t
        return loaded[node]

    params = build(meta["tree"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return params
