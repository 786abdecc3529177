"""Continuous-batching inference engine core: paged KV cache, overlapped
stepping. Counterpart of kubeai_tpu/engine/engine.py.

  add_request() ──► pending queue (RequestScheduler)
                         │ (free slot + pages?)
           batched prefill admission (same-bucket prompts, rows padded to
           a power of two) ─► page scatter ─► first-token sample
           or, one at a time, staged-chunk admission: a prompt longer
           than prefill_chunk, or one whose page-aligned prefix the
           prefix cache holds (adopted pages gathered, suffix prefilled)
                         │
        step(): one decode chunk over ALL slots (decode_chunk model steps,
                each followed by sample) ─► host-side stop checks
                or, with speculate > 0, one verify window per slot
                (prompt-lookup proposals, the longest accepted prefix)

Device state (page pools, block tables, per-slot decode state) lives in
torch tensors on the engine's device at fixed addresses and is updated
in place; the JAX version threads it through jitted functions. The
decode chunk and the verify window are device programs (engine/graphs.py):
on the card each is a CUDA graph captured once at construction and
replayed per call, the counterpart of the JAX engine's jitted
`lax.scan` and verify call; on the CPU they run eagerly through the same
buffers. So are the three staged-chunk calls of chunked and prefix-hit
admission (`_stage_mid`, `_stage_last`, `_stage_from_pages`); batched
prefill admission (`_prefill_admit`) runs eagerly.

With step_overlap on (the default, as in the JAX engine at pp = 1),
step() dispatches decode chunk N+1 before it reaps chunk N, so the host's
readback, stop checks and admission bookkeeping run under the device's
next chunk. Barriers reap the in-flight chunk first wherever overlap
could change tokens: admission, the sequence cap, cancel and drain;
speculation windows never overlap.

Two JAX behaviours are reproduced by hand:
  - jit scatters drop out-of-range writes: admission padding rows carry
    slot = num_slots, and their state writes are masked out here;
  - jnp gathers clamp out-of-range indices: positions past a slot's
    block table map to scratch page 0 (ops.paged_attention).

Disaggregated serving and the cluster KV-sharing tier move pages between
engines through the wire formats of disagg/handoff.py:
  export_handoff()  prefill one request synchronously, gather its pages
                    to the host in table order (a KVHandoff)
  import_handoff()  scatter a handoff's pages through a fresh block-table
                    row and set the slot's decode state; no prefill runs
  export_prefix_pages() / import_prefix_pages()
                    ship held prefix pages to a peer / seed fetched pages
                    unowned into the idle pool, for admission to adopt
  enable_kv_spill() snapshot each evicted idle page into a KVSpillStore
The imports write the pools, the slot state and the block tables in
place, at the addresses the captured device programs read.

Slot mode (cache_mode="slot"): one [max_seq_len] K/V row per slot
(engine/kvcache.py) instead of pages. Admission prefills one request a
call into its row (whole prompt, or chunk by chunk into the row in
place); the decode chunk runs the family's slot-cache `decode_step`. No
speculation, prefix cache, handoffs or int8 pools, as in the JAX engine.

Draft-model speculation (`draft=(cfg, params)`, paged mode, speculate >
0): a small model of the same family keeps its own slot cache. Each
window its greedy chain of gamma + 1 steps (the propose-chain program)
writes the proposals straight into the verify program's input; every
admission prefills the draft too (batched, chunked, prefix hit and
handoff import); a chunk-mode window under spec_adaptive is followed by
the catch-up program, which replays the chunk through the draft.

Families: llama, qwen, gemma and mixtral (models/registry.py). On a
CUDA device the engine refuses, at construction, a model whose head_dim
a kernel on its path has no build for (`refuse_kernel_head_dims`), and a
family with no adapter buffers refuses adapter loads (ROADMAP fault
C10).

Ported: paged and slot modes, synchronous and overlapped stepping,
preemption by recompute, the SLO scheduler, both decode layouts,
speculative decoding by prompt lookup or a draft model (adaptive or
always on), chunked prefill, the automatic
prefix cache, KV handoff export and import, prefix-page sharing and
spill, int8 KV pools (kv_dtype="int8", ops/kv_quant.py: quantized as
pages are written, read by B1's int8 kernel, shipped verbatim on every
wire), LoRA adapters (max_adapters > 0): per-request adapters
batched through every device program, loaded and unloaded by writes into
fixed buffers, so no program is captured again, and int8 weights
(quantization="int8", llama family: engine/quantization.py, the W8A16
kernel of ops/int8_matmul.py on every product of a layer weight).
Settings of the JAX engine that are not ported raise NotImplementedError
naming their ROADMAP item.

Tensor and expert parallelism (`mesh=`, a parallel.mesh.build_mesh
DeviceMesh with tp >= 1 and dp = pp = sp = 1): SPMD ranks, one per
device. Every rank of the initialised process group builds the engine
with the full parameter tree and keeps its shard (the family's
`param_specs`, after quantization as in the JAX engine), or with its
shard already cut (`presharded=True`: weights.load_params(shard=)); its
pools hold its KV heads, and the forwards call the tp group's collectives
(parallel/collectives.py). Every rank runs the same scheduler on the
same operations: given the same requests in the same order, their
streams are identical. The host decisions that read the clock agree
across ranks: rank 0's adaptive speculation choice and its base seed
for unseeded requests are broadcast. On NCCL the device programs are
captured with their collectives inside; over gloo (several ranks on one
card) they run eagerly. The llama family (llama, mistral, qwen), gemma
(Gemma 1 and 2: the tied embedding cut over the vocabulary, the
all_reduce before Gemma-2's post norms) and mixtral shard. Under a mesh
these still raise, naming their ROADMAP item: pp > 1, sp > 1, dp > 1, a
family without param_specs, a draft model, the slot cache, handoff and
prefix-page export and import, and KV spill. LoRA adapters run under a mesh: each
rank's buffers hold its heads' part (models/llama.py, `lora_shard`), and
`load_adapter` takes the whole adapter and cuts it. Requests reach every
rank through engine/multihost.py's lockstep broadcast.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from kubeai_tpu_torch.device import resolve_device
from kubeai_tpu_torch.disagg.handoff import (
    HandoffError,
    KVHandoff,
    KVPageExport,
    serialize_pages,
)
from kubeai_tpu_torch.engine.graphs import DeviceProgram, HostStaging
from kubeai_tpu_torch.engine.kvcache import KVCache, insert_sequence, insert_sequences
from kubeai_tpu_torch.engine.paged_cache import (
    OutOfPages,
    PageAllocator,
    PagedKVCache,
)
from kubeai_tpu_torch.engine.quantization import (
    is_quantized,
    quantize_params,
)
from kubeai_tpu_torch.engine.sampling import SamplingParams, sample
from kubeai_tpu_torch.engine.weights import ShardPlan
from kubeai_tpu_torch.fleet.profiler import StepProfiler
from kubeai_tpu_torch.models.registry import ModelFamily, get_model_family
from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
from kubeai_tpu_torch.ops.int8_matmul import check_weight
from kubeai_tpu_torch.ops.kv_quant import (
    QuantizedPool,
    dequantize_kv,
    kv_capacity_factor,
    resolve_kv_dtype,
)
from kubeai_tpu_torch.ops.paged_attention import (
    batched_scatter_sequence,
    batched_sequence_page_coords,
    paged_decode_attention,
    paged_decode_attention_fused,
    paged_decode_attention_int8,
    paged_verify_attention,
    resolve_decode_kernel,
    scatter_sequence_prequantized,
)
from kubeai_tpu_torch.parallel.collectives import TensorParallel
from kubeai_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_PIPELINE,
    AXIS_SEQ,
    axis_size,
)
from kubeai_tpu_torch.routing.prefixchain import page_hash_chain
from kubeai_tpu_torch.scheduling.scheduler import (
    CLASS_RANK,
    CLASS_STANDARD,
    RequestScheduler,
)


def _now() -> float:
    """Monotonic clock behind the engine's latency records."""
    return time.monotonic()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX engine's configuration. Fields this port does not serve
    yet keep their JAX defaults; setting them raises NotImplementedError
    (see Engine)."""

    num_slots: int = 8
    max_seq_len: int = 1024
    # "paged" (block tables over a shared page pool) or "slot" (one
    # [max_seq_len] row per slot, engine/kvcache.py; no speculation, no
    # prefix cache, no handoffs, no int8 pools).
    cache_mode: str = "paged"
    page_size: int = 64
    # Page-pool size. 0 = full reservation (num_slots * max_seq_len worth
    # of pages + the reserved scratch page). Smaller oversubscribes:
    # admission defers on pool exhaustion and decode preempts (recompute).
    num_pages: int = 0
    # Same-bucket prompts prefilled in one batched call; rows pad to the
    # next power of two.
    max_admit_batch: int = 8
    # Speculative decoding: propose this many tokens per step by prompt
    # lookup (an n-gram match against the request's own context) and
    # verify them all in one forward; accept the longest prefix the seeded
    # sampler agrees with. The stream equals vanilla decoding. 0 = off.
    speculate: int = 0
    # With speculate > 0: measure tokens/s of verify windows and of decode
    # chunks and run the faster, re-probing the other every
    # spec_probe_every decode calls. False = always speculate.
    spec_adaptive: bool = True
    spec_probe_every: int = 32
    prefill_buckets: tuple[int, ...] = ()  # default: powers of 2 up to max
    # Chunked prefill: prompts longer than this are prefilled in fixed
    # [1, prefill_chunk] steps staged in a one-slot buffer, one device
    # program for every prompt length; the final chunk scatters the
    # staged sequence into the slot's pages. 0 = whole-prompt bucketed
    # prefill only.
    prefill_chunk: int = 0
    # Automatic prefix caching (needs prefill_chunk > 0): full prompt
    # pages register under a content-hash chain (routing/prefixchain.py);
    # a later prompt with the same page-aligned prefix adopts those pages
    # read-only and prefills only its suffix. Pages nobody references
    # park in an LRU idle pool, evicted only when the free list is empty.
    prefix_cache: bool = False
    cache_dtype: Any = torch.bfloat16
    # KV pool dtype: "" or "bfloat16" (cache_dtype pages), or "int8": int8
    # pages with per-token-per-head f32 scales (ops/kv_quant.py), about
    # half the resident and wire bytes; per_layer decode only, no
    # speculation.
    kv_dtype: str = ""
    # Decode steps run per step() call; tokens past a request's stop point
    # within a chunk are discarded on the host.
    decode_chunk: int = 8
    # Weight-only quantization: "" (bf16) or "int8" (per-channel symmetric;
    # engine/quantization.py), applied to the target's params at
    # construction. The llama family only (ROADMAP fault C15).
    quantization: str = ""
    # Decode attention layout: "per_layer" | "fused"; "" = the
    # $KUBEAI_TPU_DECODE_KERNEL env var, default "per_layer".
    decode_kernel: str = ""
    # LoRA hot-swap: adapters loaded at once (0 disables LoRA) and the
    # highest adapter rank a buffer row holds.
    max_adapters: int = 0
    max_lora_rank: int = 16
    # Overlapped stepping: "auto" | "on" | "off" (or a bool). The port has
    # no pipeline parallelism, so "auto" resolves to on, as in the JAX
    # engine at pp = 1.
    step_overlap: str = "auto"

    def buckets(self) -> tuple[int, ...]:
        if self.prefill_buckets:
            return self.prefill_buckets
        b, out = 16, []
        while b < self.max_seq_len:
            out.append(b)
            b *= 2
        out.append(self.max_seq_len)
        return tuple(out)

    def effective_num_pages(self) -> int:
        if self.num_pages > 0:
            return self.num_pages
        per_slot = -(-self.max_seq_len // self.page_size)
        return 1 + self.num_slots * per_slot  # +1: reserved scratch page 0


class StepOverlapUnsupported(ValueError):
    """step_overlap='on' requested in a topology that cannot overlap
    (lockstep multihost): a second in-flight program would desynchronize
    the per-step cross-rank broadcast. 'auto' degrades to the synchronous
    loop instead of raising."""


class StepEvent(NamedTuple):
    """One emitted token. `finish_reason` is "" while the request is live,
    else "stop" | "length" | "cancelled" (OpenAI finish_reason semantics)."""

    rid: int
    token: int
    finished: bool
    finish_reason: str = ""


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: list[int]
    params: SamplingParams
    seed: int
    priority: str = CLASS_STANDARD
    client: str = ""
    adapter_idx: int = 0  # 0 = no adapter
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    position: int = 0  # absolute position of the next token to decode
    last_token: int = 0
    done: bool = False
    finish_reason: str = ""  # "stop" | "length" | "cancelled"
    stop_token_ids: tuple[int, ...] = ()
    # Incremental context buffer and n-gram last-occurrence index for the
    # prompt-lookup proposals (built on first use, appended per emitted
    # token: a lookup is O(gamma) per step, never an O(L) rescan).
    ctx: Any = None
    ctx_len: int = 0
    ngram_idx: Any = None  # {n: {ngram tuple -> last start index}}
    ngram_upto: Any = None  # {n: window starts indexed so far}
    # Enqueue time (_now() clock) for the queue_wait, ttft and e2e
    # records; zeroed once e2e is recorded. t_admit_start: when the
    # request first left the queue (a preempted request keeps it: its
    # re-prefill is recompute, not a second queue wait). t_prev_token:
    # when its last token was emitted, for the itl records.
    t_enqueue: float = 0.0
    t_admit_start: float = 0.0
    t_prev_token: float = 0.0
    # The prompt's page-hash chain, computed once: a head-of-line
    # admission deferred by OutOfPages would otherwise re-hash it every
    # step.
    apc_hashes: list | None = None


class EngineDraining(RuntimeError):
    """Raised by add_request once drain has begun."""


class EngineBusy(RuntimeError):
    """Raised by the synchronous disaggregation paths (export_handoff /
    import_handoff) when no slot or KV pages are free RIGHT NOW: unlike
    add_request there is no queue to park in, so the server sheds with
    429 and the router re-picks a less-loaded replica."""


# Host dtype of a pool dtype on the wire: bfloat16 travels as its raw
# 16-bit words (disagg/handoff.py), every other dtype as itself.
_HOST_DTYPES = {
    torch.bfloat16: np.dtype(np.uint16),
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
    torch.int8: np.dtype(np.int8),
}


def _pages_to_host(pages: torch.Tensor) -> np.ndarray:
    """Copy pool pages to the host in their wire dtype; bfloat16 by a view
    of its bits, never a cast."""
    if pages.dtype == torch.bfloat16:
        return pages.view(torch.int16).cpu().numpy().view(np.uint16)
    return pages.cpu().numpy()


def _pages_to_device(host: np.ndarray, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """The inverse of _pages_to_host: a host array in the wire dtype of
    `dtype` to a tensor of `dtype` on `device`, bfloat16 by a view."""
    if host.dtype != _HOST_DTYPES[dtype]:
        raise HandoffError(f"host pages of {host.dtype} for a {dtype} pool")
    host = np.ascontiguousarray(host)
    if not host.flags.writeable:  # a view of a received blob
        host = host.copy()
    if dtype == torch.bfloat16:
        return torch.from_numpy(host.view(np.int16)).to(device).view(torch.bfloat16)
    return torch.from_numpy(host).to(device)


def _host_tensor(a) -> torch.Tensor:
    """An adapter weight (a numpy array, f32 as jnp.asarray takes it, or
    a tensor) as a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return torch.from_numpy(np.array(a, np.float32))


def _resolve_overlap(cfg: EngineConfig) -> bool:
    """Whether step() overlaps: "auto" and "on" do, "off" does not."""
    overlap = cfg.step_overlap
    if isinstance(overlap, bool):
        overlap = "on" if overlap else "off"
    overlap = (overlap or "auto").strip().lower()
    if overlap not in ("auto", "on", "off"):
        raise ValueError(
            f"unknown step_overlap {cfg.step_overlap!r} "
            "(expected 'auto' | 'on' | 'off')"
        )
    return overlap != "off"


def _resolve_cache_mode(cfg: EngineConfig, family: ModelFamily) -> str:
    """The cache mode, as the JAX engine resolves it: paged needs the
    family's paged decode, else the slot cache."""
    if cfg.cache_mode == "paged" and family.decode_step_paged is None:
        return "slot"
    if cfg.cache_mode not in ("paged", "slot"):
        raise ValueError(f"unknown cache_mode {cfg.cache_mode!r}")
    return cfg.cache_mode


def _refuse_unported(cfg: EngineConfig, mesh, draft, decode_kernel: str,
                     cache_mode: str, family: ModelFamily) -> None:
    """Raise for every JAX engine setting this port does not serve, and
    for the settings the JAX engine refuses, in its words."""
    if resolve_kv_dtype(cfg.kv_dtype) == "int8":
        if cache_mode != "paged":
            raise ValueError(
                "kv_dtype='int8' requires cache_mode='paged' (pages "
                "are the quantization unit)"
            )
        if cfg.speculate > 0 or draft is not None:
            raise ValueError(
                "kv_dtype='int8' does not compose with speculative "
                "decoding yet (the verify kernels read bf16 pools)"
            )
        if decode_kernel == "fused":
            raise ValueError(
                "kv_dtype='int8' does not compose with "
                "decode_kernel='fused' (the fused kernel reads a "
                "stacked bf16 pool); use per_layer"
            )
    if cfg.quantization == "int8" and not family.int8_weights:
        # The JAX engine quantizes such a family's weights, and its first
        # admission then fails: the forwards read no quantized leaf.
        raise NotImplementedError(
            f"quantization='int8' on the {family.name} family: its forwards "
            "read no int8 weights (ROADMAP fault C15); int8 weights serve "
            "the llama family (llama, mistral, qwen)"
        )
    if cfg.quantization not in ("", "int8"):
        raise ValueError(f"unknown quantization {cfg.quantization!r}")
    if mesh is not None:
        _refuse_under_mesh(cfg, mesh, draft, cache_mode, family)


# What still refuses under a mesh, with its ROADMAP item.
MESH_ITEM = "ROADMAP A item 11a2"


def _refuse_under_mesh(cfg: EngineConfig, mesh, draft, cache_mode: str,
                       family: ModelFamily) -> None:
    """Raise for a mesh setting, or a feature under a mesh, that is not
    ported, naming its ROADMAP item."""
    for axis, what, item in (
        (AXIS_PIPELINE, "pipeline parallelism", "ROADMAP A item 11b"),
        (AXIS_SEQ, "ring attention (sequence parallelism)", "ROADMAP A item 11c"),
        (AXIS_DATA, "data parallelism", MESH_ITEM),
    ):
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(
                f"{what} ({axis} = {axis_size(mesh, axis)}) is not ported yet ({item})"
            )
    refused = [
        (family.param_specs is None, f"the {family.name} family"),
        (draft is not None, "a draft model"),
        (cache_mode == "slot", "the slot cache"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(f"{what} under a mesh is not ported yet ({MESH_ITEM})")


# The kernels that have no build yet for a head dim a family's checkpoint
# may have, with the ROADMAP item that adds it.
_HEAD_DIM_ITEMS = {
    (paged_verify_attention, 256): "ROADMAP B, B3 at head_dim 256",
}


def refuse_kernel_head_dims(
    family: ModelFamily, model_cfg, cfg: EngineConfig, decode_kernel: str,
    speculate: int, device: torch.device, cache_mode: str = "paged",
    draft_cfg=None,
) -> None:
    """On a CUDA device, raise NotImplementedError when a kernel on the
    engine's path has no build for the model's head_dim: B2 where the
    family's whole-prompt prefill goes through it (for the draft model's
    head_dim too), the paged decode kernel of the layout and pool dtype
    (B1, B4 or B1-int8; the slot cache decodes through the plain
    attention), and B3 when the engine speculates. Checked at
    construction, before any capture: a wrapper would raise only inside
    it. The CPU runs the plain versions, which take any head_dim."""
    if device.type != "cuda":
        return
    name = family.name
    path = [(paged_verify_attention, model_cfg, name)] if speculate else []
    for mcfg, who in ((model_cfg, name), (draft_cfg, "the draft")):
        if mcfg is not None and family.prefill_uses_flash(mcfg):
            path.append((flash_causal_prefill, mcfg, who))
    if cache_mode == "paged":
        if resolve_kv_dtype(cfg.kv_dtype) == "int8":
            decode = paged_decode_attention_int8
        elif decode_kernel == "fused":
            decode = paged_decode_attention_fused
        else:
            decode = paged_decode_attention
        path.append((decode, model_cfg, name))
    for kernel, mcfg, who in path:
        d = mcfg.head_size
        if d not in kernel.head_dims:
            item = _HEAD_DIM_ITEMS.get((kernel, d))
            raise NotImplementedError(
                f"{who} at head_dim {d} on {device}: "
                f"{kernel.__name__} takes head_dim {kernel.head_dims}"
                + (f" ({item})" if item else "")
            )


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class _Dispatch(NamedTuple):
    """A dispatched decode call, reaped by _process_chunk."""

    program: DeviceProgram
    ring: int  # the program's ring slot holding this call's outputs
    riders: list  # (slot, request) pairs active at dispatch
    chunk_len: int  # model steps the call advances (0: a verify window)
    dispatched_at: float  # time.monotonic()


class Engine:
    """Single-model continuous-batching engine on one device."""

    # Capture the device programs as CUDA graphs on a CUDA device. Only a
    # measurement that compares graphs with eager calls turns it off.
    _capture_graphs = True

    def __init__(
        self,
        family: ModelFamily | str,
        model_cfg: Any,
        params: dict,
        mesh=None,
        cfg: EngineConfig = EngineConfig(),
        eos_token_ids: tuple[int, ...] = (),
        scheduler: RequestScheduler | None = None,
        device: str | torch.device | None = None,
        draft: tuple[Any, Any] | None = None,
        presharded: bool = False,
    ):
        """`device` defaults to cuda (raising without a GPU); pass "cpu"
        to run the plain PyTorch versions of the kernels. `draft` =
        (draft config, draft params): a small model of the same family
        whose greedy chain proposes each speculative window (needs
        cfg.speculate > 0 and the paged cache). `presharded`: under a
        mesh, `params` is already this rank's shard (quantized where
        cfg.quantization asks), as weights.load_params(shard=) loads it,
        and is not cut again."""
        self.device = resolve_device(device)
        self.decode_kernel = resolve_decode_kernel(cfg.decode_kernel)
        self.family = (
            get_model_family(family) if isinstance(family, str) else family
        )
        if self.family.prefill is None:
            raise ValueError(
                f"the {self.family.name} family ({self.family.feature}) is not "
                "served by the slot engine"
            )
        self.cache_mode = _resolve_cache_mode(cfg, self.family)
        _refuse_unported(cfg, mesh, draft, self.decode_kernel, self.cache_mode,
                         self.family)
        self._kv_quant = resolve_kv_dtype(cfg.kv_dtype) == "int8"
        # Resolved: the step loop overlaps unless step_overlap says no.
        self._overlap = _resolve_overlap(cfg)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.eos_token_ids = eos_token_ids
        self._lock = threading.Lock()
        self._next_rid = 0
        self._draining = False
        self._sched = scheduler if scheduler is not None else RequestScheduler()
        self._active: dict[int, _Request] = {}  # slot -> request
        self._requests: dict[int, _Request] = {}
        self._free_slots = list(range(cfg.num_slots))
        # Base entropy for unseeded requests (per-request seed = base ^ rid).
        self._seed_base = int.from_bytes(np.random.bytes(4), "little")
        # Latency records (kind, seconds[, "rid-<n>"]) with kind in
        # queue_wait, prefill, ttft, itl, e2e and kv_transfer (a handoff's
        # page gather or scatter); drained by drain_timing().
        self._timing: list[tuple] = []
        # Optional preemption observer: on_preempt(rid, client).
        self.on_preempt = None
        # Adaptive speculation: measured tokens/s EMA per decode mode
        # ("spec" | "chunk"); None until a mode's second call.
        self._mode_tps: dict[str, float | None] = {}
        self._mode_calls: dict[str, int] = {}
        self._decode_calls = 0
        # Speculation acceptance over live slots (windows = verify steps x
        # live slots).
        self.spec_stats = {"windows": 0, "proposed": 0, "accepted": 0}
        # Prefix cache: fresh admissions looked up, prompt tokens served
        # from adopted pages, prompt tokens admitted.
        self.prefix_stats = {"lookups": 0, "hit_tokens": 0, "prompt_tokens": 0}
        # Disaggregation accounting (cumulative; the server converts these
        # to counters): handoffs exported after prefill, handoffs imported
        # into decode slots, KV bytes in each direction.
        self.disagg_stats = {
            "exported": 0, "imported": 0, "exported_bytes": 0, "imported_bytes": 0,
        }
        # Cluster KV-sharing accounting (cumulative): prefix pages served to
        # peers and seeded from peers, and spill/fill traffic.
        self.kv_share_stats = {
            "exported_pages": 0, "exported_bytes": 0, "imported_pages": 0,
            "imported_bytes": 0, "spilled_pages": 0, "filled_pages": 0,
        }
        # Snapshot of the most recent step() for per-step gauges.
        self.last_step_stats: dict[str, float] = {}
        # Per-phase step profiler: step() fills _phase_scratch with phase
        # durations and closes each step into the profiler's ring.
        self.profiler = StepProfiler()
        self._phase_scratch: dict[str, float] | None = None
        # The dispatched-but-unreaped decode chunk (overlapped stepping).
        self._inflight: _Dispatch | None = None
        # Events reaped outside step() (the cancel and drain barriers):
        # delivered first by the next step().
        self._pending_events: list[StepEvent] = []
        # Resolved speculation window: cfg.speculate where the paged cache
        # and the family's verify forward allow it, else 0 (vanilla
        # decode, with a warning). A draft model is refused where it
        # cannot propose, as the JAX engine refuses it.
        self._spec = 0
        self._draft = False
        verify = self.family.decode_verify_paged is not None
        if cfg.speculate > 0:
            if self.cache_mode == "paged" and verify:
                self._spec = cfg.speculate
            elif draft is not None:
                raise ValueError(
                    "draft model provided but speculation is "
                    f"unavailable (cache_mode={self.cache_mode!r}, "
                    f"pp=1, family verify={verify})"
                )
            else:
                logging.getLogger(__name__).warning(
                    "speculate=%d requested but unavailable (%s); running "
                    "vanilla decode", cfg.speculate,
                    f"family {self.family.name} has no verify forward"
                    if not verify else f"cache_mode={self.cache_mode!r}",
                )
        elif draft is not None:
            raise ValueError("draft model provided but cfg.speculate == 0")
        draft_cfg = None
        if draft is not None:
            draft_cfg, draft_params = draft
            if draft_cfg.vocab_size > model_cfg.vocab_size:
                # A proposal past the target's embedding table would index
                # out of range in the verify window (on the card, a
                # device-side assert).
                raise ValueError(
                    f"draft vocabulary ({draft_cfg.vocab_size}) is larger than "
                    f"the target's ({model_cfg.vocab_size})"
                )
        refuse_kernel_head_dims(self.family, model_cfg, cfg, self.decode_kernel,
                                self._spec, self.device, self.cache_mode, draft_cfg)

        self._tp = None if mesh is None else TensorParallel(mesh)
        if self._tp is not None:
            # Unseeded requests draw from rank 0's base on every rank.
            self._seed_base = self._tp.agree(self._seed_base)
        self.params = _to_device(params, self.device)
        if presharded and self._tp is None:
            raise ValueError("presharded params need a mesh")
        if cfg.quantization == "int8":
            # On the engine's device, one layer slice at a time; the draft
            # stays unquantized, as in the JAX engine. A quantized leaf is
            # only packed N-major.
            self.params = quantize_params(self.params)
        if self._tp is not None and not presharded:
            self.params = self._shard(self.params, mesh)
        if cfg.quantization == "int8":
            if self.device.type == "cuda":
                for name, leaf in self.params["layers"].items():
                    if is_quantized(leaf):
                        check_weight(leaf, name)
        if draft is not None:
            # The draft keeps its own slot cache (engine/kvcache.py) on the
            # engine's device: its proposals run the family's decode_step.
            self._draft = True
            self._draft_cfg = draft_cfg
            self._draft_params = _to_device(draft_params, self.device)
            self.draft_cache = KVCache.create(
                draft_cfg.num_layers, cfg.num_slots, cfg.max_seq_len,
                draft_cfg.num_kv_heads, draft_cfg.head_size, cfg.cache_dtype,
                device=self.device,
            )
        self._chunk_fn = None
        if cfg.prefill_chunk > 0:
            self._chunk_fn = self.family.prefill_chunk
            if self._chunk_fn is None:
                raise ValueError(
                    f"family {self.family.name} does not support chunked prefill"
                )
            if cfg.prefill_chunk > cfg.max_seq_len:
                raise ValueError(
                    f"prefill_chunk={cfg.prefill_chunk} exceeds "
                    f"max_seq_len={cfg.max_seq_len}: a chunk must fit the "
                    "staging buffer"
                )
        if self.cache_mode == "paged":
            self._init_paged()
        else:
            if cfg.prefix_cache:
                raise ValueError(
                    "prefix_cache requires cache_mode='paged' (pages are "
                    "the sharing unit)"
                )
            self._prefix_cache = False
            self.cache = KVCache.create(
                model_cfg.num_layers, cfg.num_slots, cfg.max_seq_len,
                model_cfg.num_kv_heads, model_cfg.head_size, cfg.cache_dtype,
                device=self.device,
            )

        # Per-slot decode state on the device: steady-state decode needs
        # no host-to-device copy per chunk.
        B, dev = cfg.num_slots, self.device
        self._state = {
            "tokens": torch.zeros(B, dtype=torch.int64, device=dev),
            "positions": torch.zeros(B, dtype=torch.int64, device=dev),
            "seeds": torch.zeros(B, dtype=torch.int64, device=dev),
            "temp": torch.zeros(B, dtype=torch.float32, device=dev),
            "topk": torch.zeros(B, dtype=torch.int64, device=dev),
            "topp": torch.ones(B, dtype=torch.float32, device=dev),
            "lora_idx": torch.zeros(B, dtype=torch.int64, device=dev),
        }
        # LoRA adapter buffers: fixed shapes and addresses, row 0 all zeros
        # ("no adapter"). A load or an unload writes a row in place: the
        # captured programs read the new weights with no capture again.
        self._lora = None
        self._adapter_slots: dict[str, int] = {}
        # Buffer row -> weight generation (the prefix-cache hash seed;
        # row 0, the base model, stays at generation 0).
        self._adapter_gen: dict[int, int] = {}
        self._adapter_free: list[int] = []
        # Why every adapter load is refused whatever max_adapters says: the
        # family takes no adapters ("" where it does). The JAX engine builds
        # llama's buffers for such a family, whose forwards then ignore them
        # (ROADMAP fault C10).
        self.adapter_refusal = ""
        if cfg.max_adapters > 0 and self.family.init_lora_buffers is None:
            self.adapter_refusal = (
                f"the {self.family.name} family takes no LoRA adapters "
                "(ROADMAP fault C10)"
            )
        elif cfg.max_adapters > 0:
            self._lora = self.family.init_lora_buffers(
                model_cfg, cfg.max_adapters + 1, cfg.max_lora_rank, device=dev,
                tp=self._tp,
            )
            self._adapter_free = list(range(1, cfg.max_adapters + 1))
        self._build_programs()

    def _shard(self, params: dict, mesh) -> dict:
        """The rank's shard of the (quantized) params, cut by
        `weights.ShardPlan`. Where tp exceeds the KV heads, wk/wv (and
        their biases) keep the one KV head this rank's q heads read; the
        pools then hold that head (the JAX engine replicates every KV head
        across tp there)."""
        shard = ShardPlan(self.family, self.model_cfg, mesh).shard(params)
        if self.cfg.quantization == "int8":
            # Row-parallel cuts leave w8 row-major: store it N-major again.
            shard = quantize_params(shard)
        return shard

    def _refuse_mesh(self, what: str) -> None:
        if self._tp is not None:
            raise NotImplementedError(f"{what} under a mesh is not ported yet ({MESH_ITEM})")

    def _kv_heads(self) -> int:
        """The KV heads this rank's pools hold."""
        n = self.model_cfg.num_kv_heads
        return n if self._tp is None else self._tp.local_kv_heads(n)

    def _init_paged(self) -> None:
        """The paged cache: the page pools, their host allocator, the
        prefix cache's settings and the host mirror of the block
        tables."""
        cfg, model_cfg = self.cfg, self.model_cfg
        n_pages = cfg.effective_num_pages()
        self._n_pages = n_pages
        max_pages = -(-cfg.max_seq_len // cfg.page_size)
        if n_pages - 1 < max_pages:
            raise ValueError(
                f"num_pages={n_pages} cannot hold one max_seq_len "
                f"sequence ({max_pages} pages + scratch); preemption "
                "could not guarantee progress"
            )
        self.cache = PagedKVCache.create(
            model_cfg.num_layers,
            n_pages,
            cfg.page_size,
            cfg.num_slots,
            cfg.max_seq_len,
            self._kv_heads(),
            model_cfg.head_size,
            dtype="int8" if self._kv_quant else cfg.cache_dtype,
            device=self.device,
        )
        self._alloc = PageAllocator(
            n_pages, cfg.page_size, max_pages_per_slot=max_pages
        )
        self._prefix_cache = bool(cfg.prefix_cache)
        if self._prefix_cache:
            if cfg.prefill_chunk <= 0:
                raise ValueError(
                    "prefix_cache needs prefill_chunk > 0 (cache hits "
                    "prefill only the uncached suffix, which runs "
                    "through the staged-chunk path)"
                )
            if (cfg.max_seq_len - cfg.prefill_chunk) // cfg.page_size < 1:
                # The adoptable prefix is capped at max_seq_len -
                # prefill_chunk (the padded suffix chunk must fit the
                # staging buffer): past the cap the cache never hits.
                logging.getLogger(__name__).warning(
                    "prefix_cache is inert: prefill_chunk=%d leaves "
                    "no adoptable pages under max_seq_len=%d "
                    "(page_size=%d) — shrink prefill_chunk",
                    cfg.prefill_chunk, cfg.max_seq_len, cfg.page_size,
                )
        # Host mirror of the block tables: page growth/release edits this;
        # one [slots, MP] copy refreshes the device table in place before
        # the next decode (_bt_dirty).
        self._bt_host = np.full((cfg.num_slots, max_pages), -1, np.int32)
        self._bt_dirty = False
        self._bt_staging = HostStaging(self.cache.block_tables)

    def _build_programs(self) -> None:
        """The decode-chunk program (paged or slot cache), the
        verify-window program when the engine speculates, the draft's
        propose-chain and catch-up programs when a draft proposes, and
        the staged-chunk programs when a paged engine chunks, with their
        fixed inputs and outputs. On a CUDA device each is captured as a
        CUDA graph (all share one memory pool: their replays run in order
        on one stream). Capture happens here, while no slot is live:
        every block-table row is -1, so the paged warm-ups write K/V only
        to scratch page 0; the slot-cache and draft warm-ups write rows
        of the slot caches, and the decode warm-ups advance the slot
        state, so both are reset after; the staged-chunk warm-ups carry a
        masked slot index, so they write no slot state. Under a mesh the
        tp group's communicator is warmed up first; a gloo group's
        collectives cannot be captured, so its programs run eagerly."""
        B, dev = self.cfg.num_slots, self.device
        capture = dev.type == "cuda" and self._capture_graphs
        if self._tp is not None:
            self._tp.warm_up(dev)
            if capture and not self._tp.capturable:
                capture = False
                logging.getLogger(__name__).warning(
                    "the tp group's %s collectives cannot be captured in a CUDA "
                    "graph: the device programs run eagerly", self._tp.backend,
                )
        pool = torch.cuda.graph_pool_handle() if capture else None
        self._chunk_out = torch.zeros(
            max(1, self.cfg.decode_chunk), B, dtype=torch.int64, device=dev
        )
        if self._draft:
            # With a draft, the decode chunk copies the slot state it starts
            # from here: the catch-up replays the chunk's inputs.
            self._pre_tokens = torch.zeros(B, dtype=torch.int64, device=dev)
            self._pre_positions = torch.zeros(B, dtype=torch.int64, device=dev)
        with torch.no_grad():
            self._decode_program = DeviceProgram(
                self._decode_chunk, (self._chunk_out,), dev,
                capture=capture, pool=pool,
            )
            self._spec_program = None
            if self._spec:
                gamma = self._spec
                self._proposals = torch.zeros(B, gamma, dtype=torch.int64, device=dev)
                self._proposal_staging = HostStaging(self._proposals)
                self._spec_choices = torch.zeros(
                    B, gamma + 1, dtype=torch.int64, device=dev
                )
                self._spec_n_emit = torch.zeros(B, dtype=torch.int64, device=dev)
                self._spec_program = DeviceProgram(
                    self._spec_step, (self._spec_choices, self._spec_n_emit),
                    dev, capture=capture, pool=pool,
                )
            self._draft_propose_program = self._draft_catchup_program = None
            if self._draft:
                self._draft_propose_program = DeviceProgram(
                    self._draft_propose, (), dev, capture=capture, pool=pool
                )
                self._draft_catchup_program = DeviceProgram(
                    self._draft_catchup, (), dev, capture=capture, pool=pool
                )
            self._stage_mid_program = self._stage_last_program = None
            self._stage_pages_program = None
            if self._chunk_fn is not None and self.cache_mode == "paged":
                self._build_stage_programs(capture, pool)
        self._state["tokens"].zero_()
        self._state["positions"].zero_()
        for cache in (self.cache if self.cache_mode == "slot" else None,
                      self.draft_cache if self._draft else None):
            if cache is not None:
                cache.k.zero_()
                cache.v.zero_()

    def _build_stage_programs(self, capture: bool, pool) -> None:
        """The one-slot staging buffers [NL, max_seq_len, KVH, D] that
        chunks accumulate in, the staged-chunk programs' fixed inputs
        (one [1, C] chunk, `_chunk_ints` = [start, length, slot, adapter,
        seed, top_k, forced], `_chunk_floats` = [temperature, top_p], the
        slot's block-table row) with a pinned staging pair each, and the
        programs: a mid chunk, the final chunk, and (with the prefix
        cache) the gather of a block-table row into the staging
        buffers."""
        mcfg, cfg, dev = self.model_cfg, self.cfg, self.device
        shape = (mcfg.num_layers, cfg.max_seq_len, self._kv_heads(),
                 mcfg.head_size)
        self._stage_k = torch.zeros(shape, dtype=cfg.cache_dtype, device=dev)
        self._stage_v = torch.zeros(shape, dtype=cfg.cache_dtype, device=dev)
        self._chunk_tokens = torch.zeros(
            1, cfg.prefill_chunk, dtype=torch.int64, device=dev
        )
        self._chunk_ints = torch.zeros(7, dtype=torch.int64, device=dev)
        self._chunk_floats = torch.zeros(2, dtype=torch.float32, device=dev)
        self._chunk_bt_row = torch.full(
            (self._bt_host.shape[1],), -1, dtype=torch.int32, device=dev
        )
        self._chunk_tok = torch.zeros(1, dtype=torch.int64, device=dev)
        # Warm-up inputs: length 1, the masked slot num_slots, no forced
        # token, greedy.
        self._chunk_ints.copy_(torch.tensor(
            [0, 1, cfg.num_slots, 0, 0, 0, -1], dtype=torch.int64
        ))
        self._chunk_floats.copy_(torch.tensor([0.0, 1.0]))
        self._chunk_staging = {
            name: HostStaging(t) for name, t in (
                ("tokens", self._chunk_tokens), ("ints", self._chunk_ints),
                ("floats", self._chunk_floats), ("bt_row", self._chunk_bt_row),
            )
        }
        self._stage_mid_program = DeviceProgram(
            self._stage_mid, (), dev, capture=capture, pool=pool
        )
        self._stage_last_program = DeviceProgram(
            self._stage_last, (self._chunk_tok,), dev,
            capture=capture, pool=pool,
        )
        if self._prefix_cache:
            self._stage_pages_program = DeviceProgram(
                self._stage_from_pages, (), dev, capture=capture, pool=pool
            )

    # ---- device functions -------------------------------------------------

    def _prefill_admit(
        self,
        tokens: torch.Tensor,  # [A, S]
        ints: torch.Tensor,  # [A, 6]: length, slot, seed, top_k, adapter, forced
        floats: torch.Tensor,  # [A, 2]: temp, top_p
        bt_rows: torch.Tensor,  # [A, MP]
    ) -> torch.Tensor:
        """Batched admission: prefill [A, S] prompts, scatter their K/V
        into the page pools, sample each first token and write the slots'
        decode state. forced >= 0 overrides the sampled token (preemption
        resume). Padding rows carry slot = num_slots: their page writes go
        to scratch page 0 (bt_row = -1) and their state writes are masked
        out. Returns [A] first tokens."""
        mcfg, page = self.model_cfg, self.cfg.page_size
        lengths = ints[:, 0]
        slots = ints[:, 1]
        seeds = ints[:, 2]
        topk = ints[:, 3]
        adapters = ints[:, 4]
        forced = ints[:, 5]
        temp, topp = floats[:, 0], floats[:, 1]
        logits, k_all, v_all = self.family.prefill(
            self.params, mcfg, tokens, lengths, **self._model_kw(adapters)
        )
        page_ids, offsets = batched_sequence_page_coords(
            bt_rows, lengths, tokens.shape[1], page
        )
        batched_scatter_sequence(
            self.cache.k_pages, self.cache.v_pages, k_all, v_all,
            page_ids, offsets,
        )
        toks = sample(logits, seeds, lengths, temp, topk, topp)
        toks = torch.where(forced >= 0, forced, toks)
        live = slots < self.cfg.num_slots
        s = slots[live]
        self.cache.block_tables[s] = bt_rows[live]
        st = self._state
        st["tokens"][s] = toks[live]
        st["positions"][s] = lengths[live]
        st["seeds"][s] = seeds[live]
        st["temp"][s] = temp[live]
        st["topk"][s] = topk[live]
        st["topp"][s] = topp[live]
        st["lora_idx"][s] = adapters[live]
        return toks

    def _model_kw(self, lora_idx: torch.Tensor) -> dict:
        """The model functions' keyword arguments: the tp group under a
        mesh, and the adapter buffers and each row's adapter index when
        LoRA is on."""
        kw = {} if self._tp is None else {"tp": self._tp}
        if self._lora is not None:
            kw.update(lora=self._lora, lora_idx=lora_idx)
        return kw

    def _stage_mid(self) -> None:
        """The mid-chunk program: one non-final chunk (`_chunk_tokens` at
        `_chunk_ints[0]`) into the staging buffers, in place."""
        ints = self._chunk_ints
        self._chunk_fn(
            self.params, self.model_cfg, self._chunk_tokens, ints[0], ints[1],
            self._stage_k, self._stage_v, want_logits=False,
            **self._model_kw(ints[3:4]),
        )

    def _stage_last(self) -> None:
        """The final-chunk program: the chunk's logits, the scatter of the
        whole staged sequence through the slot's block-table row
        (positions >= length go to scratch page 0), the row's write into
        the block tables, the first-token sample (forced >= 0 overrides
        it: preemption resume) and the slot-state update, in one call.
        Writes the token into `_chunk_tok`. A slot index >= num_slots
        (the capture's warm-up) writes no table row and no slot state."""
        cfg, st = self.cfg, self._state
        ints, floats, bt_row = self._chunk_ints, self._chunk_floats, self._chunk_bt_row
        start, length, slot = ints[0], ints[1], ints[2]
        adapter, seed, topk, forced = ints[3:4], ints[4:5], ints[5:6], ints[6]
        temp, topp = floats[0:1], floats[1:2]
        logits, _, _ = self._chunk_fn(
            self.params, self.model_cfg, self._chunk_tokens, start, length,
            self._stage_k, self._stage_v, want_logits=True,
            **self._model_kw(adapter),
        )
        page_ids, offsets = batched_sequence_page_coords(
            bt_row[None], length[None], cfg.max_seq_len, cfg.page_size
        )
        batched_scatter_sequence(
            self.cache.k_pages, self.cache.v_pages, self._stage_k[:, None],
            self._stage_v[:, None], page_ids, offsets,
        )
        tok = sample(logits, seed, length[None], temp, topk, topp)
        tok = torch.where(forced >= 0, forced, tok)  # [1]
        live = slot < cfg.num_slots
        row = slot.clamp(max=cfg.num_slots - 1).reshape(1)
        for dst, value in (
            (self.cache.block_tables, bt_row[None]), (st["tokens"], tok),
            (st["positions"], length[None]), (st["seeds"], seed),
            (st["temp"], temp), (st["topk"], topk), (st["topp"], topp),
            (st["lora_idx"], adapter),
        ):
            dst.index_copy_(0, row, torch.where(live, value, dst.index_select(0, row)))
        self._chunk_tok.copy_(tok)

    def _stage_from_pages(self) -> None:
        """The prefix-hit program: gather the pages of the block-table row
        `_chunk_bt_row` into the staging buffers, so the adopted prefix
        becomes the context the suffix chunks attend over. The whole row
        gathers every call (-1 entries read scratch page 0): entries past
        the cached length are masked by the chunks' causal frontier and
        overwritten by the suffix. Int8 pages dequantize into the staging
        buffers; the resident pages stay as they are."""
        row = self._chunk_bt_row.long().clamp(min=0)
        for dst, pool in ((self._stage_k, self.cache.k_pages),
                          (self._stage_v, self.cache.v_pages)):
            pages = pool[:, row]  # [NL, MP, page, KVH, D]
            if isinstance(pages, QuantizedPool):
                pages = dequantize_kv(pages.q8, pages.scale, dst.dtype)
            nl, mp, pg, kvh, d = pages.shape
            dst.copy_(pages.reshape(nl, mp * pg, kvh, d)[:, : dst.shape[1]])

    def _decode_chunk(self) -> None:
        """The decode-chunk program: `decode_chunk` decode steps over every
        slot (paged, or against the slot cache), each followed by sample.
        Writes the [chunk, num_slots] tokens into _chunk_out and the
        advanced tokens and positions into the slot state, in place. The
        block tables are read-only here: the host grows pages to cover
        position + chunk before dispatch. With a draft, the tokens and
        positions the chunk starts from are first copied aside for the
        catch-up (`_draft_catchup`)."""
        st = self._state
        max_len = self.cfg.max_seq_len
        tokens, positions = st["tokens"], st["positions"]
        if self._draft:
            self._pre_tokens.copy_(tokens)
            self._pre_positions.copy_(positions)
        for k in range(self._chunk_out.shape[0]):
            if self.cache_mode == "paged":
                logits, _, _ = self.family.decode_step_paged(
                    self.params, self.model_cfg, tokens, positions,
                    self.cache.k_pages, self.cache.v_pages,
                    self.cache.block_tables, attn_kernel=self.decode_kernel,
                    **self._model_kw(st["lora_idx"]),
                )
            else:
                logits, _, _ = self.family.decode_step(
                    self.params, self.model_cfg, tokens, positions,
                    self.cache.k, self.cache.v, **self._model_kw(st["lora_idx"]),
                )
            tokens = sample(
                logits, st["seeds"], positions + 1, st["temp"],
                st["topk"], st["topp"],
            )
            positions = torch.clamp(positions + 1, max=max_len - 1)
            self._chunk_out[k].copy_(tokens)
        st["tokens"].copy_(tokens)
        st["positions"].copy_(positions)

    def _spec_step(self) -> None:
        """The verify-window program: verify [last_token, gamma proposals]
        (the proposals from _proposals) in a single forward; accept the
        longest prefix where the seeded sampler's choice equals the
        proposal; emit accepted + 1 tokens. The stream equals vanilla
        decoding: choice k is sampled from the same logits with the same
        position it would see one step at a time, and a mismatch ends the
        window before any diverging context is used. Writes choices
        [B, gamma + 1] and n_emit [B] into their fixed outputs and the
        advanced slot state in place."""
        st = self._state
        gamma = self._spec
        positions = st["positions"]
        proposals = self._proposals
        tokens_in = torch.cat([st["tokens"][:, None], proposals], dim=1)
        logits, _, _ = self.family.decode_verify_paged(
            self.params, self.model_cfg, tokens_in, positions,
            self.cache.k_pages, self.cache.v_pages, self.cache.block_tables,
            **self._model_kw(st["lora_idx"]),
        )
        choices = torch.stack([
            sample(logits[:, k], st["seeds"], positions + k + 1, st["temp"],
                   st["topk"], st["topp"])
            for k in range(gamma + 1)
        ], dim=1)  # [B, gamma + 1]
        match = (choices[:, :gamma] == proposals).long()
        accepted = torch.cumprod(match, dim=1).sum(dim=1)
        n_emit = accepted + 1  # [B] in 1..gamma+1
        self._spec_choices.copy_(choices)
        self._spec_n_emit.copy_(n_emit)
        st["positions"].copy_(
            torch.clamp(positions + n_emit, max=self.cfg.max_seq_len - 1)
        )
        st["tokens"].copy_(torch.gather(choices, 1, accepted[:, None])[:, 0])

    # ---- the draft model ---------------------------------------------------

    def _draft_step(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """One draft decode step over every slot against the draft's slot
        cache (in place). Returns f32 logits [num_slots, V_draft]."""
        logits, _, _ = self.family.decode_step(
            self._draft_params, self._draft_cfg, tokens, positions,
            self.draft_cache.k, self.draft_cache.v,
        )
        return logits

    def _draft_propose(self) -> None:
        """The propose-chain program: gamma + 1 greedy draft steps, each
        argmax feeding the next, from the true last emitted token at its
        true position (the slot state), writing the first gamma picks into
        `_proposals`, the verify program's fixed input: proposals never
        cross the host. The chain runs one step past the last proposal so
        that proposal gamma's own K/V is written too: on a fully accepted
        window that token is emitted and the next window starts after it,
        and without the extra step its position would be a hole in the
        draft cache that poisons every later window's proposals."""
        st = self._state
        tokens, positions = st["tokens"], st["positions"]
        max_len = self.cfg.max_seq_len
        for k in range(self._spec + 1):
            tokens = torch.argmax(self._draft_step(tokens, positions), dim=-1)
            positions = torch.clamp(positions + 1, max=max_len - 1)
            if k < self._spec:
                self._proposals[:, k].copy_(tokens)

    def _draft_catchup(self) -> None:
        """The catch-up program: a teacher-forced draft pass over a decode
        chunk's inputs (the token the chunk started from, then its emitted
        tokens but the last, which is the next call's input) from the
        chunk's first positions. A chunk-mode window under spec_adaptive
        advances the sequences without the draft; without this pass the
        draft cache falls out of step after the first such window and
        acceptance collapses for the rest of each request."""
        max_len = self.cfg.max_seq_len
        positions = self._pre_positions
        for k in range(self._chunk_out.shape[0]):
            tokens = self._pre_tokens if k == 0 else self._chunk_out[k - 1]
            self._draft_step(tokens, positions)
            positions = torch.clamp(positions + 1, max=max_len - 1)

    def _draft_admit(self, tokens: torch.Tensor, lengths: torch.Tensor,
                     slots: list[int]) -> None:
        """Draft prefill of an admission batch ([A, S] prompts, eager): the
        draft's slot rows must hold the prompts' K/V before the first
        window. Padding rows (slot num_slots) write nothing."""
        _, k_all, v_all = self.family.prefill(
            self._draft_params, self._draft_cfg, tokens, lengths
        )
        insert_sequences(self.draft_cache.k, self.draft_cache.v, k_all, v_all, slots)

    def _draft_admit_chunked(self, seq: list[int], plen: int, slot: int) -> None:
        """The draft's prefill for a chunked or prefix-hit admission: the
        whole prompt in prefill_chunk chunks into the draft's slot row
        (the draft shares no pages with the target's prefix cache, so a
        cache hit still prefills the draft over the full sequence)."""
        if not self._draft:
            return
        C = self.cfg.prefill_chunk
        if plen >= C:
            mids, last = self._chunk_plan(seq, plen, C)
            chunks = [*mids, last]
        else:
            padded = np.zeros((1, C), np.int64)
            padded[0, :plen] = seq
            chunks = [(0, padded)]
        dev, dc = self.device, self.draft_cache
        with torch.no_grad():
            for start, tokens in chunks:
                self._chunk_fn(
                    self._draft_params, self._draft_cfg,
                    torch.from_numpy(np.asarray(tokens, np.int64)).to(dev),
                    start, plen, dc.k[:, slot], dc.v[:, slot], want_logits=False,
                )

    # ---- requests ------------------------------------------------------------

    def add_request(
        self,
        prompt_tokens: list[int],
        params: SamplingParams | None = None,
        adapter: str | None = None,
        on_admit=None,
        priority: str | None = None,
        client: str = "",
        deadline_ms: float | None = None,
        resume_tokens: list[int] | None = None,
    ) -> int:
        """Queue a request. `on_admit(rid)` runs under the engine lock
        before the request becomes visible to `step()`. `priority`,
        `client` and `deadline_ms` go to the scheduler, which may refuse
        an infeasible deadline with DeadlineInfeasible.

        Continuation: `resume_tokens` is a generation prefix that another
        replica already emitted (the proxy resuming a stream whose
        replica died). The request admits through the recompute path
        that preemption uses: prefill prompt + prefix[:-1] with the first
        token forced to prefix[-1], and step() emits only new tokens. The
        sampler is seeded and position-folded, so a greedy or seeded
        continuation is token-identical to the uninterrupted stream."""
        params = params or SamplingParams()
        resume = [int(t) for t in (resume_tokens or [])]
        if resume:
            if len(resume) >= params.max_tokens:
                raise ValueError(
                    f"resume prefix of {len(resume)} tokens >= max_tokens "
                    f"{params.max_tokens}: nothing left to generate"
                )
            if len(prompt_tokens) + len(resume) >= self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt + resume prefix length "
                    f"{len(prompt_tokens) + len(resume)} >= max_seq_len "
                    f"{self.cfg.max_seq_len}"
                )
            if resume[-1] in self.eos_token_ids:
                raise ValueError("resume prefix already ends at a stop token")
        with self._lock:
            # The adapter's row is read under the lock that load and unload
            # take: a row freed and refilled after the lookup would serve
            # this request another adapter's weights under its name.
            adapter_idx = self._adapter_index(adapter)
            if len(prompt_tokens) == 0:
                raise ValueError("empty prompt")
            if len(prompt_tokens) >= self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt length {len(prompt_tokens)} >= max_seq_len "
                    f"{self.cfg.max_seq_len}"
                )
            if self._draining:
                raise EngineDraining("engine is draining")
            rid = self._next_rid
            self._next_rid += 1
            seed = (
                params.seed
                if params.seed is not None
                else (self._seed_base ^ rid)
            ) & 0xFFFFFFFF
            req = _Request(
                rid=rid,
                prompt=list(prompt_tokens),
                params=params,
                seed=seed,
                adapter_idx=adapter_idx,
                client=client,
                # A non-empty out_tokens prefix is what admission reads as
                # resumed: the seat preemption's re-admission uses.
                out_tokens=resume,
                stop_token_ids=self.eos_token_ids,
                t_enqueue=_now(),
            )
            self._requests[rid] = req
            if on_admit is not None:
                try:
                    on_admit(rid)
                except BaseException:
                    del self._requests[rid]
                    raise
            try:
                req.priority = self._sched.submit(
                    req, priority=priority, client=client,
                    deadline_ms=deadline_ms,
                )
            except BaseException:
                del self._requests[rid]
                raise
            return rid

    def begin_drain(self) -> None:
        """Stop admitting new requests; queued and active work continues."""
        with self._lock:
            # Overlap barrier: drain decisions must see fully-reaped state.
            self._barrier_locked()
            self._draining = True

    def has_work(self) -> bool:
        # Events a barrier reaped (cancel, drain) still wait for the next
        # step() to deliver them, even when nothing else is left to run.
        return bool(
            len(self._sched) or self._active or self._inflight
            or self._pending_events
        )

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def num_pending(self) -> int:
        return len(self._sched)

    @property
    def scheduler(self) -> RequestScheduler:
        return self._sched

    def drain_timing(self) -> list[tuple]:
        """Pop the accumulated latency records."""
        with self._lock:
            out, self._timing = self._timing, []
        return out

    def prefix_holdings(self) -> list[str]:
        """Every chain hash (hex) the prefix cache holds now: what a replica
        advertises for prefix-aware routing. Advisory: admission checks
        again through lookup()."""
        if not self._prefix_cache:
            return []
        with self._lock:
            return [h.hex() for h in self._alloc.holdings()]

    def kv_utilization(self) -> float:
        """Fraction of KV capacity in use: allocated pages over the pool
        (page 0, the scratch page, excluded) in paged mode, occupied token
        positions over the slots' capacity in slot mode. Pages parked idle
        in the prefix cache count as free: any admission can reclaim
        them."""
        if self.cache_mode == "paged":
            total = self._n_pages - 1
            if total <= 0:
                return 0.0
            return 1.0 - self._alloc.free_pages / total
        cap = self.cfg.num_slots * self.cfg.max_seq_len
        if cap <= 0:
            return 0.0
        return sum(r.position for r in self._active.values()) / cap

    def kv_cache_info(self) -> dict:
        """KV-cache capacity facts for /v1/state and the metrics plane, as
        the JAX engine reports them: the dtype, whether the pool is
        quantized, the capacity factor against a bf16 pool at equal
        memory (2D/(D+4) under int8) and the resident bytes of the two
        pools, scales included."""
        factor = (kv_capacity_factor(self.model_cfg.head_size)
                  if self._kv_quant else 1.0)
        info = {
            "dtype": self._kv_dtype_name(),
            "quantized": self._kv_quant,
            "capacity_factor": factor,
            "slot_capacity": self.cfg.num_slots,
        }
        if self.cache_mode == "paged":
            info["num_pages"] = self._n_pages
            info["page_size"] = self.cfg.page_size
            info["token_capacity"] = (self._n_pages - 1) * self.cfg.page_size
        info["pool_bytes"] = self.cache.nbytes()
        return info

    def _pop_pending(self) -> None:
        """Dequeue the scheduler's head for admission, stamping when it
        first left the queue."""
        req = self._sched.pop()
        if not req.t_admit_start:
            req.t_admit_start = _now()

    def _bucket(self, n: int) -> int:
        for b in self.cfg.buckets():
            if n <= b:
                return b
        return self.cfg.max_seq_len

    # ---- admission -------------------------------------------------------

    def _admit_pending(self) -> list[StepEvent]:
        """Prefill pending requests into free slots. Returns the emitted
        first tokens."""
        if self.cache_mode == "paged":
            return self._admit_pending_paged()
        return self._admit_pending_slot()

    def _admit_pending_slot(self) -> list[StepEvent]:
        """Slot-cache admission, one request a call: the whole prompt
        through the bucketed prefill (`_prefill_admit_slot`), or a prompt
        longer than prefill_chunk chunk by chunk into its slot row
        (`_admit_chunked`). A continuation or a preempted request
        re-prefills prompt + prefix[:-1] as context with its last emitted
        token forced, as in paged mode."""
        emitted: list[StepEvent] = []
        C = self.cfg.prefill_chunk
        while len(self._sched) and self._free_slots:
            req = self._sched.peek()
            slot = self._free_slots[-1]
            resumed = bool(req.out_tokens)
            seq = req.prompt + req.out_tokens[:-1] if resumed else req.prompt
            plen = len(seq)
            self._pop_pending()
            self._free_slots.pop()
            req.slot = slot
            if C > 0 and plen > C:
                tok = self._admit_chunked(req, slot, seq, plen, C)
            else:
                tok = self._prefill_admit_slot(req, slot, seq, plen)
            ev = self._finish_admission(req, slot, plen, tok, resumed)
            if ev is not None:
                emitted.append(ev)
        return emitted

    def _sample_first(self, logits: torch.Tensor, req: _Request, slot: int,
                      plen: int) -> int:
        """A slot admission's first token: sample it from the prompt's
        last logits (forced to the last emitted token on a resume), and
        write the slot's decode state. Returns the token."""
        dev, p = self.device, req.params
        forced = req.out_tokens[-1] if req.out_tokens else -1
        seed = torch.tensor([req.seed], dtype=torch.int64, device=dev)
        length = torch.tensor([plen], dtype=torch.int64, device=dev)
        temp = torch.tensor([p.temperature], dtype=torch.float32, device=dev)
        topk = torch.tensor([p.top_k], dtype=torch.int64, device=dev)
        topp = torch.tensor([p.top_p], dtype=torch.float32, device=dev)
        tok = sample(logits, seed, length, temp, topk, topp)
        if forced >= 0:
            tok = torch.full_like(tok, forced)
        st = self._state
        for name, value in (("tokens", tok), ("positions", length), ("seeds", seed),
                            ("temp", temp), ("topk", topk), ("topp", topp)):
            st[name][slot] = value[0]
        st["lora_idx"][slot] = req.adapter_idx
        return int(tok[0])

    def _prefill_admit_slot(self, req: _Request, slot: int, seq: list[int],
                            plen: int) -> int:
        """Slot-cache admission of one request, eager: prefill the [1,
        bucket] prompt, write its K/V into the slot row
        (kvcache.insert_sequence), sample the first token and write the
        slot's decode state. Returns the token."""
        dev = self.device
        tokens = np.zeros((1, self._bucket(plen)), np.int64)
        tokens[0, :plen] = seq
        adapter = torch.tensor([req.adapter_idx], dtype=torch.int64, device=dev)
        with torch.no_grad():
            logits, k_all, v_all = self.family.prefill(
                self.params, self.model_cfg, torch.from_numpy(tokens).to(dev),
                torch.tensor([plen], device=dev), **self._model_kw(adapter),
            )
            insert_sequence(self.cache.k, self.cache.v, k_all[:, 0], v_all[:, 0], slot)
            return self._sample_first(logits, req, slot, plen)

    def _admit_chunked(self, req: _Request, slot: int, seq: list[int], plen: int,
                       C: int) -> int:
        """Slot-cache chunked prefill, eager: the chunks of `_chunk_plan`
        written straight into the slot's row of the cache (a view: the
        chunk function writes it in place); the final chunk's logits give
        the first token. `seq` includes a continuation's prefix (the
        forced token then overrides the sample)."""
        mids, last = self._chunk_plan(seq, plen, C)
        dev = self.device
        adapter = torch.tensor([req.adapter_idx], dtype=torch.int64, device=dev)
        k_slot, v_slot = self.cache.k[:, slot], self.cache.v[:, slot]
        with torch.no_grad():
            for (start, tokens), want in [*((m, False) for m in mids), (last, True)]:
                logits, _, _ = self._chunk_fn(
                    self.params, self.model_cfg,
                    torch.from_numpy(np.asarray(tokens, np.int64)).to(dev),
                    start, plen, k_slot, v_slot, want_logits=want,
                    **self._model_kw(adapter),
                )
            return self._sample_first(logits, req, slot, plen)

    def _admit_pending_paged(self) -> list[StepEvent]:
        """Paged admission, batched: same-bucket pending prompts prefill in
        one call (up to cfg.max_admit_batch). A prompt longer than
        prefill_chunk, or one whose prefix the prefix cache holds, is
        admitted alone through the staged-chunk path (the staging buffer
        holds one sequence), after any batch gathered before it. A
        preempted request resumes by recompute: prompt + emitted tokens
        (minus the last, whose K/V the next decode step writes), with its
        first token forced to the one already emitted, and is never
        hashed."""
        emitted: list[StepEvent] = []
        C = self.cfg.prefill_chunk
        page = self.cfg.page_size
        while len(self._sched) and self._free_slots:
            batch: list[tuple[_Request, int, list[int], int, bool, list | None]] = []
            bucket = None
            chunked = None  # a long prompt, for the staged-chunk path
            prefix_hit = None  # a cached prefix, for the suffix path
            while (
                len(self._sched)
                and self._free_slots
                and len(batch) < max(1, self.cfg.max_admit_batch)
            ):
                req = self._sched.peek()
                resumed = bool(req.out_tokens)
                seq = req.prompt + req.out_tokens[:-1] if resumed else req.prompt
                plen = len(seq)
                hashes = None
                if self._prefix_cache and not resumed:
                    if req.apc_hashes is None:
                        # Safe across steps: an adapter swap refuses while a
                        # queued request uses the row, so the generation in
                        # the seed cannot change under it.
                        req.apc_hashes = self._prefix_hashes(seq, req.adapter_idx)
                    hashes = req.apc_hashes
                    # Cap the hit twice over: the final token must compute
                    # (its logits give the first token), and cached_len + C
                    # must fit the staging buffer, or the padded suffix
                    # chunk's write would be clamped to a wrong offset and
                    # scattered into shared pages.
                    cap = min(
                        (plen - 1) // page,
                        max(0, (self.cfg.max_seq_len - C) // page),
                    )
                    hit = self._alloc.lookup(hashes[:cap])
                    if hit:
                        if not batch:
                            prefix_hit = (req, seq, plen, hashes, hit)
                        break
                if C > 0 and plen > C:
                    if not batch:
                        chunked = (req, seq, plen, resumed, hashes)
                    break
                b = self._bucket(plen)
                if bucket is None:
                    bucket = b
                elif b != bucket:
                    break  # same-bucket batching only
                slot = self._free_slots[-1]
                try:
                    pages = self._alloc.ensure(slot, plen)
                except OutOfPages:
                    break  # defer; ensure() rolled back
                self._pop_pending()
                self._free_slots.pop()
                req.slot = slot
                self._set_bt_row(slot, pages)
                batch.append((req, slot, seq, plen, resumed, hashes))
            if prefix_hit is not None:
                req, seq, plen, hashes, hit = prefix_hit
                slot = self._free_slots[-1]
                self._alloc.adopt(slot, hit)
                try:
                    pages = self._alloc.ensure(slot, plen)
                except OutOfPages:
                    self._alloc.unadopt(slot)
                    break  # defer; nothing held
                self._pop_pending()
                self._free_slots.pop()
                req.slot = slot
                self._set_bt_row(slot, pages)
                cached_len = len(hit) * page
                tok = self._admit_prefix_hit(req, slot, seq, plen, cached_len)
                self._note_prefix_admission(slot, plen, cached_len, hashes)
                ev = self._finish_admission(req, slot, plen, tok)
                if ev is not None:
                    emitted.append(ev)
                continue
            if chunked is not None:
                req, seq, plen, resumed, hashes = chunked
                slot = self._free_slots[-1]
                try:
                    pages = self._alloc.ensure(slot, plen)
                except OutOfPages:
                    break  # defer; ensure() rolled back
                self._pop_pending()
                self._free_slots.pop()
                req.slot = slot
                self._set_bt_row(slot, pages)
                mids, last = self._chunk_plan(seq, plen, C)
                self._draft_admit_chunked(seq, plen, slot)
                tok = self._run_staged_chunks(req, slot, plen, mids, last)
                if not resumed:
                    self._note_prefix_admission(slot, plen, 0, hashes)
                ev = self._finish_admission(req, slot, plen, tok, resumed)
                if ev is not None:
                    emitted.append(ev)
                continue
            if not batch:
                break
            toks = self._admit_paged_batch(batch, bucket)
            for (req, slot, _seq, plen, resumed, hashes), tok in zip(batch, toks):
                if not resumed:
                    self._note_prefix_admission(slot, plen, 0, hashes)
                ev = self._finish_admission(req, slot, plen, int(tok), resumed)
                if ev is not None:
                    emitted.append(ev)
        return emitted

    def _prefix_hashes(self, tokens: list[int], adapter_idx: int = 0) -> list[bytes]:
        """The prompt's page-aligned hash chain (routing/prefixchain.py),
        as digests, seeded with the adapter row and its weight
        generation: new weights hot-swapped into a reused row can never
        hit pages computed under the old ones."""
        gen = self._adapter_gen.get(adapter_idx, 0)
        return [
            bytes.fromhex(h)
            for h in page_hash_chain(tokens, self.cfg.page_size, adapter_idx, gen)
        ]

    def _note_prefix_admission(
        self, slot: int, plen: int, cached_len: int, hashes: list | None,
    ) -> None:
        """Account a fresh admission and register its full prompt pages
        (pages decode never writes: the first decode token lands at
        position plen). `hashes` is None when the prefix cache is off.
        Runs before _finish_admission, which releases the slot of a
        request that finishes on its first token: registration is what
        lets its pages park in the cache."""
        if not self._prefix_cache or hashes is None:
            return
        self.prefix_stats["lookups"] += 1
        self.prefix_stats["hit_tokens"] += cached_len
        self.prefix_stats["prompt_tokens"] += plen
        n_reg = plen // self.cfg.page_size
        if n_reg:
            self._alloc.register(hashes[:n_reg], self._alloc.pages_for(slot)[:n_reg])

    def _admit_prefix_hit(
        self, req: _Request, slot: int, seq: list[int], plen: int,
        cached_len: int,
    ) -> int:
        """Admission over an adopted cached prefix: gather the prefix pages
        into the staging buffers, then prefill only the suffix through
        the staged chunks.

        No chunk starts before cached_len. The adopted pages are shared
        and read by other slots; recomputing their positions through the
        chunk program (another program than the one that wrote them)
        would scatter values that are not bit-identical into them. So a
        suffix shorter than C pads forward from cached_len instead of
        aligning backward into the cached region. (The final scatter
        still rewrites the prefix pages, with the values gathered from
        them: the same bits.)"""
        C = self.cfg.prefill_chunk
        arr = np.asarray(seq, np.int32)
        mids = []
        s = cached_len
        while plen - s > C:
            mids.append((s, arr[None, s : s + C]))
            s += C
        if plen - cached_len >= C:
            last = (plen - C, arr[None, plen - C : plen])
        else:
            # The admission loop's cap keeps this chunk inside the
            # staging buffer.
            assert cached_len + C <= self.cfg.max_seq_len, (
                cached_len, C, self.cfg.max_seq_len,
            )
            padded = np.zeros((1, C), np.int32)
            padded[0, : plen - cached_len] = arr[cached_len:plen]
            last = (cached_len, padded)
        self._draft_admit_chunked(seq, plen, slot)
        return self._run_staged_chunks(req, slot, plen, mids, last, from_pages=True)

    def _run_staged_chunks(
        self, req: _Request, slot: int, plen: int, mids, last,
        from_pages: bool = False,
    ) -> int:
        """Run a staged-chunk schedule: with `from_pages` the gather of the
        slot's block-table row first, then the mid chunks, then the final
        chunk, each a device-program dispatch whose inputs arrive through
        pinned staging. Only the final chunk's token comes back: one wait
        on the device per admission. Shared by chunked and prefix-hit
        admission, so the two cannot drift."""
        staging = self._chunk_staging
        ints = np.array([
            0, plen, slot, req.adapter_idx, req.seed, req.params.top_k,
            req.out_tokens[-1] if req.out_tokens else -1,
        ], np.int64)
        with torch.no_grad():
            staging["bt_row"].upload(self._bt_host[slot])
            if from_pages:
                self._stage_pages_program.dispatch()
            for start, tokens in mids:
                ints[0] = start
                staging["tokens"].upload(tokens)
                staging["ints"].upload(ints)
                self._stage_mid_program.dispatch()
            ints[0], tokens = last
            staging["tokens"].upload(tokens)
            staging["ints"].upload(ints)
            staging["floats"].upload(np.array(
                [req.params.temperature, req.params.top_p], np.float32
            ))
            program = self._stage_last_program
            return int(program.read(program.dispatch())[0][0])

    @staticmethod
    def _chunk_plan(seq: list[int], plen: int, C: int):
        """Chunk schedule: full mid chunks at 0, C, ...; the final chunk is
        aligned backward to end exactly at plen (start plen - C), so its
        writes never reach past plen. Overlapping positions recompute the
        same K/V. Returns ([(start, tokens [1, C]), ...], (last_start,
        last_tokens))."""
        arr = np.asarray(seq, np.int32)
        n_chunks = -(-plen // C)
        mids = [(i * C, arr[None, i * C : (i + 1) * C]) for i in range(n_chunks - 1)]
        return mids, (plen - C, arr[None, plen - C : plen])

    def _admit_paged_batch(self, batch, bucket: int) -> np.ndarray:
        A = len(batch)
        a_pad = 1
        while a_pad < A:
            a_pad *= 2
        mp = self._bt_host.shape[1]
        tokens = np.zeros((a_pad, bucket), np.int64)
        ints = np.zeros((a_pad, 6), np.int64)
        floats = np.zeros((a_pad, 2), np.float32)
        bt_rows = np.full((a_pad, mp), -1, np.int32)
        # Padding rows: length 1, slot out of range (masked), bt_row -1
        # (page writes hit scratch), greedy sampling params.
        ints[:, 0] = 1
        ints[:, 1] = self.cfg.num_slots
        ints[:, 5] = -1
        floats[:, 1] = 1.0
        for i, (req, slot, seq, plen, _resumed, _hashes) in enumerate(batch):
            tokens[i, :plen] = seq
            ints[i] = [
                plen,
                slot,
                req.seed,
                req.params.top_k,
                req.adapter_idx,
                # Resume: force the already-emitted last token.
                req.out_tokens[-1] if req.out_tokens else -1,
            ]
            floats[i] = [req.params.temperature, req.params.top_p]
            bt_rows[i] = self._bt_host[slot]
        dev = self.device
        with torch.no_grad():
            tokens_dev = torch.from_numpy(tokens).to(dev)
            toks = self._prefill_admit(
                tokens_dev,
                torch.from_numpy(ints).to(dev),
                torch.from_numpy(floats).to(dev),
                torch.from_numpy(bt_rows).to(dev),
            )
            if self._draft:
                self._draft_admit(tokens_dev, torch.from_numpy(ints[:, 0]).to(dev),
                                  ints[:, 1].tolist())
        return toks[:A].cpu().numpy()

    def _finish_admission(
        self, req: _Request, slot: int, plen: int, tok: int,
        resumed: bool = False,
    ) -> StepEvent | None:
        if resumed:
            if req.done:  # finished/cancelled while pending: don't revive
                self._release(req)
                return None
            # tok is the FORCED already-emitted last token; no new event.
            req.position = plen
            req.last_token = tok
            self._active[slot] = req
            return None
        # First token of a fresh admission: queue wait (enqueue to
        # dequeue), prefill (dequeue to first token), TTFT (enqueue to
        # first token).
        now = _now()
        self._timing.append(
            ("queue_wait", max(0.0, req.t_admit_start - req.t_enqueue))
        )
        self._timing.append(("prefill", max(0.0, now - req.t_admit_start)))
        self._timing.append(
            ("ttft", max(0.0, now - req.t_enqueue), f"rid-{req.rid}")
        )
        req.t_prev_token = now
        req.out_tokens.append(tok)
        req.position = plen
        req.last_token = tok
        finished = self._check_stop(req)
        if finished:
            self._release(req)
        else:
            self._active[slot] = req
        return StepEvent(req.rid, tok, finished, req.finish_reason)

    def _check_stop(self, req: _Request) -> bool:
        if req.last_token in req.stop_token_ids:
            req.done = True
            req.finish_reason = "stop"
        elif len(req.out_tokens) >= req.params.max_tokens:
            req.done = True
            req.finish_reason = "length"
        elif req.position >= self.cfg.max_seq_len:
            # Next decode would write past the cache.
            req.done = True
            req.finish_reason = "length"
        return req.done

    # ---- pages and slots -------------------------------------------------

    def _decode_lookahead(self) -> int:
        """How far positions can advance in one decode call. Adaptive
        speculation may run either mode a given step, so cover both."""
        if self._spec:
            chunk = self._spec + 1
            if self.cfg.spec_adaptive:
                chunk = max(chunk, max(1, self.cfg.decode_chunk))
            return chunk
        return max(1, self.cfg.decode_chunk)

    def _ensure_decode_pages(self, inflight_lag: int = 0) -> None:
        """Grow every active slot's pages to cover the next decode call.
        Pool exhaustion preempts the lowest-class, youngest other request
        (recompute on re-admission). The pool holds one full sequence, so
        the oldest request is always served.

        `inflight_lag`: model steps of a dispatched-but-unreaped chunk.
        Host positions lag the device by that many tokens while a chunk
        is in flight, so coverage extends past the lag, or the overlapped
        dispatch would decode into unallocated rows of the block table."""
        chunk = self._decode_lookahead() + max(0, int(inflight_lag))
        for slot, req in sorted(
            self._active.items(), key=lambda kv: kv[1].rid
        ):
            if self._active.get(slot) is not req:
                continue  # preempted by an earlier iteration of this loop
            need = min(req.position + chunk + 1, self.cfg.max_seq_len)
            while True:
                before = len(self._alloc.pages_for(slot))
                try:
                    pages = self._alloc.ensure(slot, need)
                except OutOfPages:
                    victims = [
                        r for r in self._active.values() if r is not req
                    ]
                    if not victims:  # cannot happen (init invariant)
                        raise
                    self._preempt(max(
                        victims,
                        key=lambda r: (CLASS_RANK.get(r.priority, 0), r.rid),
                    ))
                    continue
                break
            if len(pages) != before:
                self._set_bt_row(slot, pages)

    def _set_bt_row(self, slot: int, pages: list[int]) -> None:
        row = np.full((self._bt_host.shape[1],), -1, np.int32)
        row[: len(pages)] = pages
        self._bt_host[slot] = row
        self._bt_dirty = True

    def _preempt(self, victim: _Request) -> None:
        """Evict an active request: free its slot and pages and requeue it
        at the front of pending for recompute re-admission."""
        slot = victim.slot
        self._active.pop(slot, None)
        self._free_slots.append(slot)
        victim.slot = -1
        self._alloc.release(slot)
        self._bt_host[slot] = -1
        self._bt_dirty = True
        self._sched.requeue_front(victim)
        cb = self.on_preempt
        if cb is not None:
            try:
                cb(victim.rid, victim.client)
            except Exception:
                pass

    def _release(self, req: _Request) -> None:
        if req.finish_reason in ("stop", "length") and req.t_enqueue:
            self._timing.append(("e2e", max(0.0, _now() - req.t_enqueue)))
            req.t_enqueue = 0.0
        # A preempted request can finish while waiting in the queue: drop
        # it there too, or re-admission would resurrect it.
        self._sched.remove(req)
        if req.slot >= 0:
            self._active.pop(req.slot, None)
            self._free_slots.append(req.slot)
            if self.cache_mode == "paged":
                # Free the pages and clear the row before the next decode:
                # a stale row would scatter the junk token of a freed slot
                # into pages that may now belong to a live sequence.
                self._alloc.release(req.slot)
                self._bt_host[req.slot] = -1
                self._bt_dirty = True
            req.slot = -1
        self._requests.pop(req.rid, None)

    def cancel(self, rid: int) -> bool:
        """Abort a request (pending or active)."""
        with self._lock:
            req = self._requests.get(rid)
            if req is None:
                return False
            # Overlap barrier: freeing the slot and pages under an unreaped
            # chunk would let admission reuse them before the reap.
            self._barrier_locked()
            # The reaped tokens of the request being cancelled have no
            # reader; the other requests' events wait for the next step().
            self._pending_events = [
                ev for ev in self._pending_events if ev.rid != rid
            ]
            self._sched.remove(req)
            req.done = True
            req.finish_reason = "cancelled"
            self._release(req)
            return True

    # ---- disaggregated serving: KV handoff export / import -----------------

    def _kv_dtype_name(self) -> str:
        """Wire-format dtype name of the pools ("bfloat16", "float32", or
        "int8" for quantized pools): handoff and page-export headers carry
        it, and importers refuse a mismatch rather than cast."""
        if self._kv_quant:
            return "int8"
        return str(self.cfg.cache_dtype).removeprefix("torch.")

    def _gather_pages_host(self, pool, pages: list[int]):
        """Gather pool[:, pages] to the host in the wire dtype. Returns
        (values, scales): a quantized pool gives its int8 pages and f32
        scales, the resident bytes (never a dequantized copy); otherwise
        the scales are None. The copy to the host waits for every call
        before it on the engine's stream, so it reads what the prefill
        wrote."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=pool.device)
        if isinstance(pool, QuantizedPool):
            return pool.q8[:, idx].cpu().numpy(), pool.scale[:, idx].cpu().numpy()
        return _pages_to_host(pool[:, idx]), None

    def _page_wire_nbytes(self) -> int:
        """Payload bytes of ONE page's K+V on the wire (scales included
        when quantized): the unit every kv_share byte counter uses."""
        mcfg = self.model_cfg
        ps, kvh, d = self.cfg.page_size, mcfg.num_kv_heads, mcfg.head_size
        if self._kv_quant:
            return 2 * mcfg.num_layers * ps * kvh * (d + 4)
        itemsize = torch.empty((), dtype=self.cfg.cache_dtype).element_size()
        return 2 * mcfg.num_layers * ps * kvh * d * itemsize

    def _check_wire_geometry(self, what: str, k_pages: np.ndarray) -> None:
        mcfg = self.model_cfg
        nl, _n, _page, kvh, d = k_pages.shape
        if (nl, kvh, d) != (mcfg.num_layers, mcfg.num_kv_heads, mcfg.head_size):
            raise HandoffError(
                f"{what} geometry [{nl}L,{kvh}KVH,{d}D] does not match "
                f"this model [{mcfg.num_layers}L,{mcfg.num_kv_heads}KVH,"
                f"{mcfg.head_size}D]"
            )

    def export_handoff(
        self,
        prompt_tokens: list[int],
        params: SamplingParams | None = None,
        adapter: str | None = None,
        client: str = "",
        priority: str = "",
        model_name: str = "",
    ) -> KVHandoff:
        """Prefill-role serving: run (chunked) prefill for one request
        SYNCHRONOUSLY, sample its first token, and return a `KVHandoff`
        carrying the paged KV and the sampling state, instead of entering
        decode. The slot and pages are borrowed only for this call; with
        the prefix cache on, the prompt pages park in the idle pool on
        release.

        Raises EngineBusy when no slot or pages are free right now (the
        server sheds 429 and the router re-picks) and EngineDraining once
        drain has begun."""
        self._refuse_mesh("handoff export")
        if self.cache_mode != "paged":
            raise RuntimeError(
                "KV handoff export requires cache_mode='paged' (pages are "
                "the transfer unit)"
            )
        params = params or SamplingParams()
        seq = list(prompt_tokens)
        plen = len(seq)
        with self._lock:
            # Under the lock, as in add_request: the row cannot change hands
            # before the prefill reads it.
            adapter_idx = self._adapter_index(adapter)
            if plen == 0:
                raise ValueError("empty prompt")
            if plen >= self.cfg.max_seq_len:
                raise ValueError(
                    f"prompt length {plen} >= max_seq_len {self.cfg.max_seq_len}"
                )
            # Overlap barrier: this borrows a slot and pages synchronously;
            # an unreaped chunk's stop-driven frees must land first.
            self._barrier_locked()
            if self._draining:
                raise EngineDraining("engine is draining")
            if not self._free_slots:
                raise EngineBusy("no free prefill slot")
            rid = self._next_rid
            self._next_rid += 1
            seed = (
                params.seed if params.seed is not None else (self._seed_base ^ rid)
            ) & 0xFFFFFFFF
            slot = self._free_slots.pop()
            try:
                pages = self._alloc.ensure(slot, plen)
            except OutOfPages:
                self._free_slots.append(slot)
                raise EngineBusy("KV page pool exhausted")
            try:
                self._set_bt_row(slot, pages)
                req = _Request(rid=rid, prompt=seq, params=params, seed=seed,
                               adapter_idx=adapter_idx, client=client,
                               stop_token_ids=self.eos_token_ids)
                t0 = _now()
                C = self.cfg.prefill_chunk
                hashes = self._prefix_hashes(seq, adapter_idx)
                if C > 0 and plen > C:
                    mids, last = self._chunk_plan(seq, plen, C)
                    tok = self._run_staged_chunks(req, slot, plen, mids, last)
                else:
                    tok = int(self._admit_paged_batch(
                        [(req, slot, seq, plen, False, None)], self._bucket(plen),
                    )[0])
                prefill_s = max(0.0, _now() - t0)
                self._timing.append(("prefill", prefill_s))
                self._timing.append(("ttft", prefill_s, f"rid-{rid}"))
                # Gather the sequence's pages to the host IN TABLE ORDER:
                # the packed-page blob is position-major by construction.
                t_kv = time.perf_counter()
                k_host, k_scales = self._gather_pages_host(self.cache.k_pages, pages)
                v_host, v_scales = self._gather_pages_host(self.cache.v_pages, pages)
                self._timing.append(("kv_transfer", time.perf_counter() - t_kv))
                if self._prefix_cache:
                    # Publish the prompt pages before release so they park
                    # in the idle LRU instead of the free list.
                    self._note_prefix_admission(slot, plen, 0, hashes)
            finally:
                self._alloc.release(slot)
                self._bt_host[slot] = -1
                self._bt_dirty = True
                self._free_slots.append(slot)
            first_finish = ""
            if tok in self.eos_token_ids:
                first_finish = "stop"
            elif params.max_tokens <= 1:
                first_finish = "length"
            handoff = KVHandoff(
                token_ids=seq,
                first_token=tok,
                first_finish=first_finish,
                page_size=self.cfg.page_size,
                dtype=self._kv_dtype_name(),
                k_pages=k_host,
                v_pages=v_host,
                k_scales=k_scales,
                v_scales=v_scales,
                seed=seed,
                temperature=params.temperature,
                top_k=params.top_k,
                top_p=params.top_p,
                max_tokens=params.max_tokens,
                stop=tuple(params.stop),
                prefix_hashes=tuple(h.hex() for h in hashes),
                adapter=adapter or "",
                client=client,
                priority=priority,
                model=model_name,
            )
            self.disagg_stats["exported"] += 1
            self.disagg_stats["exported_bytes"] += handoff.nbytes()
            return handoff

    def import_handoff(self, handoff: KVHandoff, on_admit=None) -> tuple[int, StepEvent]:
        """Decode-role serving: admit a prefilled handoff DIRECTLY into a
        slot (scatter its KV through a fresh block-table row, set the
        slot's sampler state), bypassing every prefill. Returns (rid,
        first_event): the exporting engine sampled the first token, so the
        caller forwards `first_event` to its subscriber itself.
        `on_admit(rid)` runs under the engine lock before the slot becomes
        visible to step(), as add_request's hook does.

        The stream is token-identical to a unified run: the pages hold the
        exporter's KV bits, the slot resumes the same seeded sampler at
        the same position, and decode runs the same program. Geometry and
        dtype mismatches raise HandoffError: refuse, never cast.

        On an engine with a draft model the draft prefills the handoff's
        tokens into its slot row, as a direct admission does (the JAX
        engine leaves the row stale: ROADMAP fault C14)."""
        self._refuse_mesh("handoff import")
        if self.cache_mode != "paged":
            raise RuntimeError("KV handoff import requires cache_mode='paged'")
        self._check_wire_geometry("handoff", handoff.k_pages)
        plen = handoff.plen
        if plen >= self.cfg.max_seq_len:
            raise HandoffError(
                f"handoff length {plen} >= max_seq_len {self.cfg.max_seq_len}"
            )
        expect = self._kv_dtype_name()
        if handoff.dtype != expect or (self._kv_quant and not handoff.quantized):
            # Refuse, never cast: a cast here would silently alter KV
            # values while the stream still claims token-identity with the
            # exporting engine.
            raise HandoffError(
                f"handoff KV dtype {handoff.dtype!r} != local pool dtype "
                f"{expect!r}; casting would break token-identity "
                "(re-export from a matching-dtype prefill pool)"
            )
        params = SamplingParams(
            temperature=handoff.temperature, top_k=handoff.top_k,
            top_p=handoff.top_p, max_tokens=handoff.max_tokens,
            seed=handoff.seed, stop=tuple(handoff.stop),
        )
        with self._lock:
            # Overlap barrier: the import admits a slot outside step()'s
            # admission, so reap before the slot and page grant.
            self._barrier_locked()
            if self._draining:
                raise EngineDraining("engine is draining")
            adapter_idx = 0
            if handoff.adapter:
                if self._lora is None or handoff.adapter not in self._adapter_slots:
                    raise KeyError(f"adapter {handoff.adapter!r} not loaded here")
                adapter_idx = self._adapter_slots[handoff.adapter]
            rid = self._next_rid
            self._next_rid += 1
            first = int(handoff.first_token)
            first_ev = StepEvent(rid, first, bool(handoff.first_finish),
                                 handoff.first_finish)
            if handoff.first_finish:
                # Finished at its first token: nothing to decode, no slot.
                if on_admit is not None:
                    on_admit(rid)
                self.disagg_stats["imported"] += 1
                self.disagg_stats["imported_bytes"] += handoff.nbytes()
                return rid, first_ev
            if not self._free_slots:
                raise EngineBusy("no free decode slot")
            slot = self._free_slots.pop()
            try:
                pages = self._alloc.ensure(slot, plen)
            except OutOfPages:
                self._free_slots.append(slot)
                raise EngineBusy("KV page pool exhausted")
            now = _now()
            req = _Request(
                rid=rid, prompt=list(handoff.token_ids), params=params,
                seed=handoff.seed & 0xFFFFFFFF,
                priority=handoff.priority or CLASS_STANDARD,
                client=handoff.client, adapter_idx=adapter_idx,
                out_tokens=[first], slot=slot,
                position=plen, last_token=first,
                stop_token_ids=self.eos_token_ids,
                t_enqueue=now, t_admit_start=now, t_prev_token=now,
            )
            self._requests[rid] = req
            if on_admit is not None:
                try:
                    on_admit(rid)
                except BaseException:
                    del self._requests[rid]
                    self._alloc.release(slot)
                    self._free_slots.append(slot)
                    raise
            # The host mirror gets the row; the next step uploads the
            # table (_bt_dirty) before its decode dispatch.
            self._set_bt_row(slot, pages)
            t_kv = time.perf_counter()
            k_seq, v_seq = handoff.contiguous_kv()
            dev = self.device
            dtype = torch.int8 if self._kv_quant else self.cfg.cache_dtype
            scales = None
            if self._kv_quant:
                scales = tuple(_pages_to_device(s, torch.float32, dev)
                               for s in handoff.contiguous_scales())
            with torch.no_grad():
                self._import_kv(
                    slot, plen, _pages_to_device(k_seq, dtype, dev),
                    _pages_to_device(v_seq, dtype, dev), req, scales,
                )
                if self._draft:
                    tokens = np.zeros((1, self._bucket(plen)), np.int64)
                    tokens[0, :plen] = handoff.token_ids
                    self._draft_admit(torch.from_numpy(tokens).to(dev),
                                      torch.tensor([plen], device=dev), [slot])
            self._timing.append(("kv_transfer", time.perf_counter() - t_kv))
            if self._prefix_cache and handoff.prefix_hashes:
                n_reg = min(plen // self.cfg.page_size, len(handoff.prefix_hashes))
                if n_reg > 0:
                    self._alloc.register(
                        [bytes.fromhex(h) for h in handoff.prefix_hashes[:n_reg]],
                        pages[:n_reg],
                    )
            self._active[slot] = req
            self.disagg_stats["imported"] += 1
            self.disagg_stats["imported_bytes"] += handoff.nbytes()
            return rid, first_ev

    def _import_kv(self, slot: int, plen: int, k_seq: torch.Tensor,
                   v_seq: torch.Tensor, req: _Request, scales=None) -> None:
        """The import program, eager: scatter the [NL, plen, KVH, D]
        sequence through the slot's block-table row into the pools, write
        the row into the device block tables, and set the slot's decode
        state (the JAX engine's `_import_handoff` and `_slot_resume_state`)
        so that the next decode step resumes where the exporting engine's
        sampler left off. Everything is written in place. An int8 pool
        takes int8 rows and their (k, v) [NL, plen, KVH] `scales`,
        written verbatim."""
        dev, page = self.device, self.cfg.page_size
        row = torch.from_numpy(self._bt_host[slot].copy()).to(dev)
        page_ids, offsets = batched_sequence_page_coords(
            row[None], torch.tensor([plen], device=dev), plen, page
        )
        if self._kv_quant:
            scatter_sequence_prequantized(
                self.cache.k_pages, self.cache.v_pages, k_seq, scales[0],
                v_seq, scales[1], page_ids[0], offsets[0],
            )
        else:
            batched_scatter_sequence(
                self.cache.k_pages, self.cache.v_pages, k_seq[:, None],
                v_seq[:, None], page_ids, offsets,
            )
        self.cache.block_tables[slot] = row
        st, p = self._state, req.params
        for name, value in (
            ("tokens", req.last_token), ("positions", plen), ("seeds", req.seed),
            ("temp", p.temperature), ("topk", p.top_k), ("topp", p.top_p),
            ("lora_idx", req.adapter_idx),
        ):
            st[name][slot] = value

    # ---- cluster KV-sharing tier --------------------------------------------

    def cached_prefix_depth(self, hashes_hex: list[str]) -> int:
        """How many leading pages of the chain are held locally right now:
        what a peer fetch would NOT need to transfer."""
        if not self._prefix_cache:
            return 0
        try:
            hashes = [bytes.fromhex(h) for h in hashes_hex]
        except ValueError:
            return 0
        with self._lock:
            return len(self._alloc.lookup(hashes))

    def compute_prefix_chain(self, tokens: list[int]) -> list[str]:
        """Base-model page-hash chain (hex) of a token sequence: the
        engine-side oracle the front door's chain must match."""
        return [h.hex() for h in self._prefix_hashes(list(tokens))]

    def export_prefix_pages(self, hashes_hex: list[str], max_bytes: int = 0):
        """Serve a peer's partial-chain fetch: gather the longest locally
        held prefix of the requested chain (optionally cut to a transfer
        cap) to the host as a `KVPageExport`. The pages are copied under
        the engine lock after the overlap barrier, so the bytes are a
        settled snapshot; an empty export means "hold nothing of that
        chain". None when the prefix cache is off or the chain is not
        hex."""
        self._refuse_mesh("prefix-page export")
        if not self._prefix_cache:
            return None
        try:
            hashes = [bytes.fromhex(h) for h in hashes_hex]
        except ValueError:
            return None
        mcfg = self.model_cfg
        ps = self.cfg.page_size
        page_nbytes = self._page_wire_nbytes()
        with self._lock:
            # Overlap barrier: an in-flight chunk may still be writing.
            self._barrier_locked()
            pages = self._alloc.lookup(hashes)
            if max_bytes > 0:
                pages = pages[: max_bytes // page_nbytes]
            n = len(pages)
            if n:
                k_host, k_scales = self._gather_pages_host(self.cache.k_pages, pages)
                v_host, v_scales = self._gather_pages_host(self.cache.v_pages, pages)
            else:
                shape = (mcfg.num_layers, 0, ps, mcfg.num_kv_heads, mcfg.head_size)
                k_scales = v_scales = None
                if self._kv_quant:
                    k_host, v_host = np.zeros(shape, np.int8), np.zeros(shape, np.int8)
                    k_scales = np.zeros(shape[:-1], np.float32)
                    v_scales = np.zeros(shape[:-1], np.float32)
                else:
                    host = _HOST_DTYPES[self.cfg.cache_dtype]
                    k_host, v_host = np.zeros(shape, host), np.zeros(shape, host)
            self.kv_share_stats["exported_pages"] += n
            self.kv_share_stats["exported_bytes"] += n * page_nbytes
        return KVPageExport(
            prefix_hashes=tuple(hashes_hex[:n]), page_size=ps,
            dtype=self._kv_dtype_name(), k_pages=k_host, v_pages=v_host,
            k_scales=k_scales, v_scales=v_scales,
        )

    def import_prefix_pages(self, export: KVPageExport, source: str = "peer") -> int:
        """Seed fetched prefix pages into the idle pool, unowned: the next
        admission whose chain matches adopts them through the ordinary
        lookup()/adopt() path, so a stale or partial import can only cost
        recompute. Geometry, page size and dtype must match exactly.
        Returns the number of pages written (0 when the pool refuses or
        every page was already held)."""
        self._refuse_mesh("prefix-page import")
        if not self._prefix_cache or export.n_pages == 0:
            return 0
        self._check_wire_geometry("page export", export.k_pages)
        page = export.k_pages.shape[2]
        if page != self.cfg.page_size:
            raise HandoffError(
                f"page size {page} != local {self.cfg.page_size} (chain "
                "hashes are page-size-dependent; no re-paging is possible)"
            )
        if export.dtype != self._kv_dtype_name() or (
            self._kv_quant and not export.quantized
        ):
            raise HandoffError(
                f"KV dtype {export.dtype} != local cache dtype "
                f"{self._kv_dtype_name()}; casting would break token-identity"
            )
        try:
            hashes = [bytes.fromhex(h) for h in export.prefix_hashes]
        except ValueError as e:
            raise HandoffError(f"bad chain hash: {e}") from e
        with self._lock:
            # Overlap barrier: seeding idle-pool pages races an unreaped
            # chunk's frees and allocations.
            self._barrier_locked()
            seeded = self._alloc.seed_unowned(hashes)
            if seeded is None:
                return 0
            write = [(i, p) for i, p in enumerate(seeded) if p is not None]
            if write:
                dev, dtype = self.device, self.cfg.cache_dtype
                idx = torch.as_tensor([p for _, p in write], dtype=torch.long, device=dev)
                cols = [i for i, _ in write]
                with torch.no_grad():
                    for pool, src, scales in (
                        (self.cache.k_pages, export.k_pages, export.k_scales),
                        (self.cache.v_pages, export.v_pages, export.v_scales),
                    ):
                        if self._kv_quant:
                            # Verbatim int8 pages and scales: the chain
                            # hash vouches for these exact bytes.
                            pool.q8[:, idx] = _pages_to_device(src[:, cols], torch.int8, dev)
                            pool.scale[:, idx] = _pages_to_device(
                                scales[:, cols], torch.float32, dev)
                        else:
                            pool[:, idx] = _pages_to_device(src[:, cols], dtype, dev)
            key = "imported_pages" if source == "peer" else "filled_pages"
            self.kv_share_stats[key] += len(write)
            if source == "peer":
                self.kv_share_stats["imported_bytes"] += (
                    len(write) * self._page_wire_nbytes()
                )
            return len(write)

    def enable_kv_spill(self, store) -> None:
        """Wire idle-pool eviction to a spill store: just before an evicted
        page's registration is destroyed, its K/V bytes are serialized
        into `store` under the chain hash, so a later fetch of an evicted
        hot prefix can FILL from the store instead of recomputing. The
        hook runs under the engine lock on the eviction path; the
        allocator swallows its failures."""
        self._refuse_mesh("KV spill")

        def _spill(page: int, h: bytes) -> None:
            k, k_scales = self._gather_pages_host(self.cache.k_pages, [page])
            v, v_scales = self._gather_pages_host(self.cache.v_pages, [page])
            store.put(h.hex(), serialize_pages(KVPageExport(
                prefix_hashes=(h.hex(),), page_size=self.cfg.page_size,
                dtype=self._kv_dtype_name(), k_pages=k, v_pages=v,
                k_scales=k_scales, v_scales=v_scales,
            )))
            self.kv_share_stats["spilled_pages"] += 1

        self._alloc.on_evict = _spill

    # ---- stepping ----------------------------------------------------------

    def _spec_pick(self) -> bool:
        """Choose this decode call's mode (True = speculative window,
        False = decode chunk). Epsilon-greedy over measured tokens/s:
        sample each arm twice, then run the winner, re-probing the loser
        every cfg.spec_probe_every calls so a workload shift is noticed.
        Greedy streams are identical in both modes; a seeded near-tie can
        flip where the two modes' logits differ in the last bits, so set
        spec_adaptive=False where seeded streams must be bit-stable."""
        if not self.cfg.spec_adaptive:
            return True
        self._decode_calls += 1
        s = self._mode_tps.get("spec")
        c = self._mode_tps.get("chunk")
        if self._mode_calls.get("spec", 0) < 2:
            return True
        if self._mode_calls.get("chunk", 0) < 2:
            return False
        if self._decode_calls % max(2, self.cfg.spec_probe_every) == 0:
            pick = s <= c  # probe the currently losing arm
        else:
            pick = s > c
        if self._tp is not None:
            # Each rank's clock differs: rank 0 decides for every rank, or
            # ranks would enter different programs' collectives.
            pick = bool(self._tp.agree(int(pick)))
        return pick

    def _spec_observe(self, mode: str, tokens: int, dt: float) -> None:
        """Fold one decode call's throughput into the mode's EMA. The
        first call per mode is counted but not folded: it pays one-time
        set-up (the kernels' build, allocator growth)."""
        calls = self._mode_calls.get(mode, 0) + 1
        self._mode_calls[mode] = calls
        if calls < 2 or dt <= 0 or tokens <= 0:
            return
        tps = tokens / dt
        prev = self._mode_tps.get(mode)
        self._mode_tps[mode] = tps if prev is None else 0.7 * prev + 0.3 * tps

    def step(self) -> list[StepEvent]:
        """Admit pending prefills, then dispatch one decode call: a decode
        chunk (cfg.decode_chunk model steps) or, with speculation, one
        verify window. Returns StepEvents in emission order.

        With overlap on, the chunk dispatched by this call is reaped by the
        next one: the device computes chunk N+1 while the host reads back
        and processes chunk N's tokens. Barriers reap first wherever
        overlap could change tokens (see _reap_inflight_locked)."""
        with self._lock:
            # Per-phase timeline for this step (fleet/profiler.py).
            phases: dict[str, float] = {}
            self._phase_scratch = phases
            emitted: list[StepEvent] = []
            if self._pending_events:
                # Tokens reaped by an out-of-step barrier (cancel, drain):
                # delivered before this step's.
                emitted.extend(self._pending_events)
                self._pending_events.clear()
            # ADMISSION BARRIER: a pending prompt's slot and page grant must
            # observe the in-flight chunk's slot frees (and a preempted
            # request's re-prefill its full out_tokens), so reap before
            # admitting; and before any speculation window, whose
            # proposals read out_tokens.
            if self._inflight is not None and (len(self._sched) or self._spec):
                emitted.extend(self._reap_inflight_locked())
            t_admit = time.perf_counter()
            emitted.extend(self._admit_pending())
            phases["prefill"] = time.perf_counter() - t_admit
            prev, self._inflight = self._inflight, None
            current = None
            mode = None
            t0 = time.perf_counter()
            if self._active and prev is not None:
                # SEQUENCE-CAP BARRIER: dispatching chunk N+1 before reaping
                # N advances device positions by up to len(N) + chunk. If a
                # slot could cross max_seq_len in that window, reap first:
                # the dispatch then overshoots by at most one chunk, the
                # envelope the synchronous loop already tolerates.
                horizon = prev.chunk_len + self._decode_lookahead() + 1
                if any(
                    req.position + horizon >= self.cfg.max_seq_len
                    for req in self._active.values()
                ):
                    emitted.extend(self._process_chunk(prev))
                    prev = None
            if self._active and self.cache_mode == "paged":
                self._ensure_decode_pages(
                    inflight_lag=prev.chunk_len if prev is not None else 0
                )
                if self._bt_dirty:
                    t_up = time.perf_counter()
                    self._bt_staging.upload(self._bt_host)
                    self._bt_dirty = False
                    self._note_phase("dispatch", time.perf_counter() - t_up)
            if self._active:
                riders = list(self._active.items())
                with torch.no_grad():
                    if self._spec and self._spec_pick():
                        mode = "spec"
                        if self._draft:
                            # The chain writes the verify program's input.
                            self._draft_propose_program.dispatch()
                        else:
                            self._proposal_staging.upload(self._build_proposals())
                        program, chunk_len = self._spec_program, 0
                    else:
                        if self._spec:
                            mode = "chunk"
                        program = self._decode_program
                        chunk_len = self._chunk_out.shape[0]
                    t_dec = time.perf_counter()
                    phases["schedule"] = (
                        t_dec - t0 - phases.get("dispatch", 0.0)
                    )
                    current = _Dispatch(
                        program, program.dispatch(), riders, chunk_len,
                        time.monotonic(),
                    )
                    if self._draft and chunk_len:
                        # Keep the draft cache in step with the chunk.
                        self._draft_catchup_program.dispatch()
                phases["decode"] = time.perf_counter() - t_dec
                if self._overlap and not self._spec:
                    # Reap current next call. Speculation never overlaps:
                    # proposals read out_tokens, and the adaptive arm needs
                    # the measured wall time of every decode call.
                    self._inflight = current
                    current = None
            if prev is not None:
                emitted.extend(self._process_chunk(prev))
            if current is not None:
                evs = self._process_chunk(current)
                emitted.extend(evs)
                if mode is not None:
                    # Wall time covers the dispatch, the device work and the
                    # readback: the cost the mode choice trades off.
                    self._spec_observe(mode, len(evs), time.perf_counter() - t0)
            step_s = time.perf_counter() - t0
            # The scheduler's drain-rate estimate (deadline feasibility,
            # Retry-After): completed requests per second of step time.
            finished = sum(1 for ev in emitted if ev.finished)
            self._sched.observe_service(finished, step_s)
            # The overlap tail (reaping a chunk whose rows all finished,
            # emitting nothing, with no work left) keeps the last real
            # step's numbers.
            if (
                emitted or self._active or len(self._sched)
                or current is not None or self._inflight is not None
            ):
                self.last_step_stats = {
                    "batch_size": len(self._active),
                    "waiting": len(self._sched),
                    "tokens": len(emitted),
                    "duration_s": step_s,
                }
            self._phase_scratch = None
            # Record only steps that did something; a dispatch-only step
            # (overlap holding its first chunk) counts.
            if (
                emitted or current is not None or prev is not None
                or self._inflight is not None
            ):
                self.profiler.observe_step(
                    phases, tokens=len(emitted), batch=len(self._active),
                    duration_s=step_s,
                )
            return emitted

    def _reap_inflight_locked(self) -> list[StepEvent]:
        """Reap the dispatched-but-unreaped chunk now (the caller holds the
        engine lock): the barrier behind every mutation that must observe
        the chunk's tokens or slot frees (admission, cancel, drain,
        speculation windows). Returns the chunk's events."""
        inflight = self._inflight
        if inflight is None:
            return []
        self._inflight = None
        return self._process_chunk(inflight)

    def _barrier_locked(self) -> None:
        """The barrier for callers outside step() (cancel, drain; under the
        engine lock): reap the in-flight chunk and queue its events for
        the next step(), so no token is lost."""
        self._pending_events.extend(self._reap_inflight_locked())

    def inflight_info(self) -> dict | None:
        """{"dispatched_at": monotonic seconds} of the dispatched-but-
        unreaped chunk, or None: for a server watchdog. A lock-free read
        of an attribute that step() swaps whole."""
        inflight = self._inflight
        if inflight is None:
            return None
        return {"dispatched_at": inflight.dispatched_at}

    def _note_phase(self, phase: str, seconds: float) -> None:
        """Add a phase duration to the current step's timeline (no-op
        outside step(); always under the engine lock)."""
        ph = self._phase_scratch
        if ph is not None:
            ph[phase] = ph.get(phase, 0.0) + seconds

    def _emit(self, req: _Request, tok: int, now: float) -> StepEvent:
        """Append one decoded token to a live request, releasing it when
        the token finishes it. `now` is when the call that produced it
        was reaped: tokens of one call share it, as in the JAX engine."""
        if req.t_prev_token:
            self._timing.append(
                ("itl", max(0.0, now - req.t_prev_token), f"rid-{req.rid}")
            )
        req.t_prev_token = now
        req.out_tokens.append(tok)
        req.position += 1
        req.last_token = tok
        finished = self._check_stop(req)
        if finished:
            self._release(req)
        return StepEvent(req.rid, tok, finished, req.finish_reason)

    def _process_chunk(self, call: _Dispatch) -> list[StepEvent]:
        """Reap a dispatched call: wait for its outputs to reach the host
        (overlap_idle), read them (readback) and emit its riders' tokens
        (sample). The whole [chunk, num_slots] buffer comes back: at the
        serving shapes it is 512 bytes."""
        t_wait = time.perf_counter()
        call.program.wait(call.ring)
        self._note_phase("overlap_idle", time.perf_counter() - t_wait)
        t_read = time.perf_counter()
        outputs = call.program.read(call.ring)
        self._note_phase("readback", time.perf_counter() - t_read)
        t_sample = time.perf_counter()
        now = _now()
        if call.program is self._spec_program:
            emitted = self._process_spec(*outputs, call.riders, now)
        else:
            toks = outputs[0]  # [chunk, num_slots]
            emitted = []
            for k in range(toks.shape[0]):
                for slot, req in call.riders:
                    if req.done:
                        continue  # surplus chunk tokens discarded
                    emitted.append(self._emit(req, int(toks[k, slot]), now))
        self._note_phase("sample", time.perf_counter() - t_sample)
        return emitted

    def _process_spec(self, choices: np.ndarray, n_emit: np.ndarray,
                      riders, now: float) -> list[StepEvent]:
        """Emit each slot's accepted and corrected tokens (1..gamma+1 per
        step). A stop mid-window discards the rest, like chunk surplus."""
        emitted: list[StepEvent] = []
        for slot, req in riders:
            if req.done:
                continue
            self.spec_stats["windows"] += 1
            self.spec_stats["proposed"] += self._spec
            self.spec_stats["accepted"] += int(n_emit[slot]) - 1
            for j in range(int(n_emit[slot])):
                emitted.append(self._emit(req, int(choices[slot, j]), now))
                if req.done:
                    break
        return emitted

    def _build_proposals(self) -> np.ndarray:
        """Prompt-lookup proposals [num_slots, gamma]: the longest suffix
        n-gram (n = 3, 2, 1) of each active request's context that
        occurred earlier proposes its historical continuation; inactive
        slots get zeros (their results are discarded). Contexts live in
        per-request incremental buffers: only newly emitted tokens append
        each step."""
        gamma = self._spec
        out = np.zeros((self.cfg.num_slots, gamma), np.int32)
        for slot, req in self._active.items():
            need = len(req.prompt) + len(req.out_tokens)
            if req.ctx is None or need < req.ctx_len:
                req.ctx = np.empty(self.cfg.max_seq_len + gamma + 2, np.int32)
                base = req.prompt + req.out_tokens
                req.ctx[: len(base)] = base
                req.ctx_len = len(base)
                req.ngram_idx = {n: {} for n in (3, 2, 1)}
                req.ngram_upto = {n: 0 for n in (3, 2, 1)}
            elif req.ctx_len < need:
                req.ctx[req.ctx_len:need] = req.out_tokens[req.ctx_len - len(req.prompt):]
                req.ctx_len = need
            out[slot] = self._ngram_propose_indexed(req, gamma)
        return out

    @staticmethod
    def _ngram_propose_indexed(req: _Request, gamma: int) -> np.ndarray:
        """O(gamma)-per-step lookup: the last-occurrence index is extended
        only over the window starts added since the previous step."""
        ctx, L = req.ctx, req.ctx_len
        for n in (3, 2, 1):
            if L <= n:
                continue
            s = L - n  # the suffix's own start, never indexed
            idx = req.ngram_idx[n]
            for i in range(req.ngram_upto[n], s):
                idx[tuple(ctx[i : i + n].tolist())] = i
            req.ngram_upto[n] = s
            hit = idx.get(tuple(ctx[s:L].tolist()))
            if hit is not None:
                start = hit + n
                prop = ctx[start : min(start + gamma, L)]
                if len(prop):
                    pad = np.full(gamma - len(prop), prop[-1], np.int32)
                    return np.concatenate([prop, pad])
        return np.full(gamma, int(ctx[L - 1]), np.int32)

    @staticmethod
    def _ngram_propose(ctx: np.ndarray, gamma: int) -> np.ndarray:
        """The same proposal by a full rescan of the context."""
        L = len(ctx)
        for n in (3, 2, 1):
            if L <= n:
                continue
            suffix = ctx[-n:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            hits = hits[hits < L - n]  # exclude the suffix itself
            if len(hits):
                start = int(hits[-1]) + n
                prop = ctx[start : start + gamma]
                if len(prop):
                    pad = np.full(gamma - len(prop), prop[-1], np.int32)
                    return np.concatenate([prop, pad])
        return np.full(gamma, int(ctx[-1]), np.int32)  # repeat-last fallback

    # ---- LoRA adapter admin ------------------------------------------------

    def _adapter_index(self, adapter: str | None) -> int:
        """The buffer row of a named adapter (0 for none), raising as the
        JAX engine does: ValueError with LoRA off, KeyError when the
        adapter is not loaded."""
        if not adapter:
            return 0
        if self._lora is None:
            raise ValueError(self.adapter_refusal or "LoRA is disabled (max_adapters=0)")
        if adapter not in self._adapter_slots:
            raise KeyError(f"adapter {adapter!r} not loaded")
        return self._adapter_slots[adapter]

    def loaded_adapters(self) -> list[str]:
        return sorted(self._adapter_slots)

    def lora_shapes(self) -> dict[str, tuple[tuple, tuple]]:
        """{target: (A shape, B shape)} of one whole adapter at rank
        max_lora_rank, [NL, in, r] and [NL, r, out] (the model's dims, a
        mesh or not): what load_adapter takes."""
        NL, r = self.model_cfg.num_layers, self.cfg.max_lora_rank
        return {t: ((NL, i, r), (NL, r, o))
                for t, (i, o) in self.family.lora_dims(self.model_cfg).items()}

    def load_adapter(self, name: str, adapter_weights: dict) -> None:
        """Install adapter weights into a free buffer row. Weights:
        {target: (A [NL, in, r], B [NL, r, out])} (numpy arrays or CPU
        tensors) with r <= max_lora_rank; the alpha/r scaling must already
        be folded into B. Loading the same name again overwrites its row.
        Under a mesh the weights are the whole adapter's, and the rank
        keeps its heads' part (the family's `lora_shard`).

        The rows are written in place under the engine lock, on the
        engine's stream, behind any call already dispatched, and the
        stream is synchronized before this returns: a request admitted
        afterwards reads the new weights, and no program is captured
        again. Every target and rank is checked before a row is taken or
        written. A family that takes no adapters raises ValueError with
        `adapter_refusal`."""
        if self._lora is None:
            raise ValueError(self.adapter_refusal or "LoRA is disabled (max_adapters=0)")
        with self._lock:
            if name in self._adapter_slots:
                slot = self._adapter_slots[name]
                if self._adapter_in_use_locked(slot):
                    # Overwriting the row would flip in-flight streams to the
                    # new weights mid-generation: the hazard unload_adapter
                    # refuses.
                    raise RuntimeError(
                        f"adapter {name!r} has in-flight requests; retry "
                        "after they finish"
                    )
            elif not self._adapter_free:
                raise RuntimeError(
                    f"adapter capacity ({self.cfg.max_adapters}) exhausted"
                )
            r_max = self.cfg.max_lora_rank
            rows = {}
            for target, (A, B) in adapter_weights.items():
                if target not in self._lora:
                    raise KeyError(f"unknown LoRA target {target!r}")
                A, B = _host_tensor(A), _host_tensor(B)
                r = A.shape[-1]
                if r > r_max:
                    raise ValueError(f"adapter rank {r} > max_lora_rank {r_max}")
                if self._tp is not None:
                    A, B = self.family.lora_shard(self.model_cfg, self._tp, target, A, B)
                rows[target] = (A, B, r)
            if name not in self._adapter_slots:
                slot = self._adapter_free.pop(0)
            with torch.no_grad():
                for target, (A, B, r) in rows.items():
                    bufA, bufB = self._lora[target]["A"], self._lora[target]["B"]
                    # One [NL, in, r_max] / [NL, r_max, out] host row each,
                    # zero-padded past r, cast as the JAX engine casts.
                    padA = torch.zeros(bufA[:, slot].shape, dtype=bufA.dtype)
                    padB = torch.zeros(bufB[:, slot].shape, dtype=bufB.dtype)
                    padA[..., :r] = A.to(bufA.dtype)
                    padB[:, :r, :] = B.to(bufB.dtype)
                    bufA[:, slot].copy_(padA)
                    bufB[:, slot].copy_(padB)
            self._sync_lora()
            self._adapter_slots[name] = slot
            # New weights in this row: prefix-cache entries hashed under
            # the old generation must never hit again.
            self._adapter_gen[slot] = self._adapter_gen.get(slot, 0) + 1

    def adapter_in_use(self, name: str) -> bool:
        """True when the adapter is loaded and a pending or active request
        uses it. Advisory: the load and unload guards check again under
        the lock; the server asks it to answer 409 before fetching
        weights that a refused reload would discard."""
        if self._lora is None:
            return False
        with self._lock:
            slot = self._adapter_slots.get(name)
            return slot is not None and self._adapter_in_use_locked(slot)

    def _adapter_in_use_locked(self, slot: int) -> bool:
        """True when a pending or active request uses the adapter row
        (the caller holds the engine lock; step() holds it throughout, so
        no request mid-admission is missed)."""
        return any(
            r.adapter_idx == slot for r in self._sched.items()
        ) or any(r.adapter_idx == slot for r in self._active.values())

    def unload_adapter(self, name: str) -> bool:
        """Zero the adapter's row in place and free it. False when the
        adapter is not loaded; RuntimeError while a request uses it
        (zeroing the row would turn its stream into the base model's, and
        a later load could give the row to another adapter mid-stream)."""
        if self._lora is None or name not in self._adapter_slots:
            return False
        with self._lock:
            slot = self._adapter_slots.get(name)
            if slot is None:
                return False
            if self._adapter_in_use_locked(slot):
                raise RuntimeError(
                    f"adapter {name!r} has in-flight requests; retry after "
                    "they finish"
                )
            del self._adapter_slots[name]
            self._adapter_gen[slot] = self._adapter_gen.get(slot, 0) + 1
            with torch.no_grad():
                for bufs in self._lora.values():
                    bufs["A"][:, slot].zero_()
                    bufs["B"][:, slot].zero_()
            self._sync_lora()
            self._adapter_free.append(slot)
            return True

    def _sync_lora(self) -> None:
        """Wait for the adapter-row writes on the engine's stream."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def generate(
        self,
        prompts: list[list[int]],
        params: SamplingParams | None = None,
        adapter: str | None = None,
    ) -> list[list[int]]:
        """Blocking batch generation (tests/benchmarks)."""
        rids = [self.add_request(p, params, adapter=adapter) for p in prompts]
        collected: dict[int, list[int]] = {r: [] for r in rids}
        while self.has_work():
            for ev in self.step():
                if ev.rid in collected:
                    collected[ev.rid].append(ev.token)
        return [collected[r] for r in rids]
