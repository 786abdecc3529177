"""Continuous-batching inference engine core: paged KV cache, overlapped
stepping. Counterpart of kubeai_tpu/engine/engine.py.

  add_request() ──► pending queue (RequestScheduler)
                         │ (free slot + pages?)
           batched prefill admission (same-bucket prompts, rows padded to
           a power of two) ─► page scatter ─► first-token sample
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
buffers. Prefill admission (`_prefill_admit`) runs eagerly.

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

Ported: paged mode, synchronous and overlapped stepping, preemption by
recompute, the SLO scheduler, both decode layouts, and speculative
decoding by prompt lookup (adaptive or always on). Settings of the JAX
engine that are not ported raise NotImplementedError naming their
ROADMAP item.
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
from kubeai_tpu_torch.engine.graphs import DeviceProgram, HostStaging
from kubeai_tpu_torch.engine.paged_cache import (
    OutOfPages,
    PageAllocator,
    PagedKVCache,
)
from kubeai_tpu_torch.engine.sampling import SamplingParams, sample
from kubeai_tpu_torch.fleet.profiler import StepProfiler
from kubeai_tpu_torch.models.registry import ModelFamily, get_model_family
from kubeai_tpu_torch.ops.paged_attention import (
    batched_scatter_sequence,
    batched_sequence_page_coords,
    resolve_decode_kernel,
)
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
    cache_mode: str = "paged"  # "slot" is not ported (ROADMAP A13)
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
    prefill_chunk: int = 0  # ROADMAP A8
    prefix_cache: bool = False  # ROADMAP A8
    cache_dtype: Any = torch.bfloat16
    kv_dtype: str = ""  # "int8": ROADMAP A10
    # Decode steps run per step() call; tokens past a request's stop point
    # within a chunk are discarded on the host.
    decode_chunk: int = 8
    quantization: str = ""  # "int8" weights: ROADMAP A12
    # Decode attention layout: "per_layer" | "fused"; "" = the
    # $KUBEAI_TPU_DECODE_KERNEL env var, default "per_layer".
    decode_kernel: str = ""
    max_adapters: int = 0  # LoRA: ROADMAP A11
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
    # Enqueue time (_now() clock) for the ttft and e2e records; zeroed
    # once e2e is recorded.
    t_enqueue: float = 0.0


class EngineDraining(RuntimeError):
    """Raised by add_request once drain has begun."""


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


def _refuse_unported(cfg: EngineConfig, mesh, draft, decode_kernel: str) -> None:
    """Raise for every JAX engine setting this port does not serve."""
    if cfg.cache_mode == "slot":
        raise NotImplementedError(
            "cache_mode='slot' is not ported (ROADMAP A13); use 'paged'"
        )
    if cfg.cache_mode != "paged":
        raise ValueError(f"unknown cache_mode {cfg.cache_mode!r}")
    if cfg.prefill_chunk > 0 or cfg.prefix_cache:
        raise NotImplementedError(
            "chunked prefill and the prefix cache are not ported yet "
            "(ROADMAP A8)"
        )
    kv = (cfg.kv_dtype or "").strip().lower()
    if kv == "int8":
        # The JAX engine's own refusals come first.
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
        raise NotImplementedError("int8 KV pools are not ported yet (ROADMAP A10)")
    if kv not in ("", "bfloat16", "bf16"):
        raise ValueError(f"unknown kv_dtype {cfg.kv_dtype!r}")
    if cfg.quantization == "int8":
        raise NotImplementedError("int8 weights are not ported yet (ROADMAP A12)")
    if cfg.quantization:
        raise ValueError(f"unknown quantization {cfg.quantization!r}")
    if cfg.max_adapters > 0:
        raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A11)")
    if mesh is not None:
        raise NotImplementedError(
            "meshes and parallelism are not ported yet (ROADMAP A14)"
        )
    if draft is not None:
        raise NotImplementedError(
            "draft-model speculation is not ported yet: it drafts through "
            "the slot cache (ROADMAP A13); prompt-lookup speculation "
            "(speculate > 0, no draft) is"
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
    ):
        """`device` defaults to cuda (raising without a GPU); pass "cpu"
        to run the plain PyTorch versions of the kernels. `draft` (a
        draft model for speculation) is not ported and raises."""
        self.device = resolve_device(device)
        self.decode_kernel = resolve_decode_kernel(cfg.decode_kernel)
        _refuse_unported(cfg, mesh, draft, self.decode_kernel)
        # Resolved: the step loop overlaps unless step_overlap says no.
        self._overlap = _resolve_overlap(cfg)
        self.family = (
            get_model_family(family) if isinstance(family, str) else family
        )
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
        # Latency records ("ttft", seconds, "rid-<n>") and ("e2e",
        # seconds); drained by drain_timing().
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
        # Resolved speculation window: cfg.speculate where the family has
        # a verify forward, else 0 (vanilla decode, with a warning).
        self._spec = 0
        if cfg.speculate > 0:
            if self.family.decode_verify_paged is not None:
                self._spec = cfg.speculate
            else:
                logging.getLogger(__name__).warning(
                    "speculate=%d requested but family %s has no verify "
                    "forward; running vanilla decode",
                    cfg.speculate, self.family.name,
                )

        self.params = _to_device(params, self.device)

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
            model_cfg.num_kv_heads,
            model_cfg.head_size,
            dtype=cfg.cache_dtype,
            device=self.device,
        )
        self._alloc = PageAllocator(
            n_pages, cfg.page_size, max_pages_per_slot=max_pages
        )
        # Host mirror of the block tables: page growth/release edits this;
        # one [slots, MP] copy refreshes the device table in place before
        # the next decode (_bt_dirty).
        self._bt_host = np.full((cfg.num_slots, max_pages), -1, np.int32)
        self._bt_dirty = False
        self._bt_staging = HostStaging(self.cache.block_tables)

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
        }
        self._build_programs()

    def _build_programs(self) -> None:
        """The decode-chunk program and, when the engine speculates, the
        verify-window program, with their fixed inputs and outputs. On a
        CUDA device each is captured as a CUDA graph (the two share one
        memory pool: their replays run in order on one stream). Capture
        happens here, while no slot is live: every block-table row is -1,
        so the warm-up calls write K/V only to scratch page 0; they do
        advance the slot state, which is reset after."""
        B, dev = self.cfg.num_slots, self.device
        capture = dev.type == "cuda" and self._capture_graphs
        pool = torch.cuda.graph_pool_handle() if capture else None
        self._chunk_out = torch.zeros(
            max(1, self.cfg.decode_chunk), B, dtype=torch.int64, device=dev
        )
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
        self._state["tokens"].zero_()
        self._state["positions"].zero_()

    # ---- device functions -------------------------------------------------

    def _prefill_admit(
        self,
        tokens: torch.Tensor,  # [A, S]
        ints: torch.Tensor,  # [A, 5]: length, slot, seed, top_k, forced
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
        forced = ints[:, 4]
        temp, topp = floats[:, 0], floats[:, 1]
        logits, k_all, v_all = self.family.prefill(
            self.params, mcfg, tokens, lengths
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
        return toks

    def _decode_chunk(self) -> None:
        """The decode-chunk program: `decode_chunk` paged decode steps over
        every slot, each followed by sample. Writes the [chunk, num_slots]
        tokens into _chunk_out and the advanced tokens and positions into
        the slot state, in place. The block tables are read-only here:
        the host grows pages to cover position + chunk before dispatch."""
        st = self._state
        max_len = self.cfg.max_seq_len
        tokens, positions = st["tokens"], st["positions"]
        for k in range(self._chunk_out.shape[0]):
            logits, _, _ = self.family.decode_step_paged(
                self.params, self.model_cfg, tokens, positions,
                self.cache.k_pages, self.cache.v_pages,
                self.cache.block_tables, attn_kernel=self.decode_kernel,
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
    ) -> int:
        """Queue a request. `on_admit(rid)` runs under the engine lock
        before the request becomes visible to `step()`. `priority`,
        `client` and `deadline_ms` go to the scheduler, which may refuse
        an infeasible deadline with DeadlineInfeasible."""
        params = params or SamplingParams()
        if adapter:
            raise NotImplementedError("LoRA adapters are not ported yet (ROADMAP A11)")
        if len(prompt_tokens) == 0:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self.cfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt_tokens)} >= max_seq_len "
                f"{self.cfg.max_seq_len}"
            )
        with self._lock:
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
                client=client,
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

    def _bucket(self, n: int) -> int:
        for b in self.cfg.buckets():
            if n <= b:
                return b
        return self.cfg.max_seq_len

    # ---- admission -------------------------------------------------------

    def _admit_pending_paged(self) -> list[StepEvent]:
        """Paged admission, batched: same-bucket pending prompts prefill in
        one call (up to cfg.max_admit_batch). A preempted request resumes
        by recompute: prompt + emitted tokens (minus the last, whose K/V
        the next decode step writes), with its first token forced to the
        one already emitted."""
        emitted: list[StepEvent] = []
        while len(self._sched) and self._free_slots:
            batch: list[tuple[_Request, int, list[int], int, bool]] = []
            bucket = None
            while (
                len(self._sched)
                and self._free_slots
                and len(batch) < max(1, self.cfg.max_admit_batch)
            ):
                req = self._sched.peek()
                resumed = bool(req.out_tokens)
                seq = req.prompt + req.out_tokens[:-1] if resumed else req.prompt
                plen = len(seq)
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
                self._sched.pop()
                self._free_slots.pop()
                req.slot = slot
                self._set_bt_row(slot, pages)
                batch.append((req, slot, seq, plen, resumed))
            if not batch:
                break
            toks = self._admit_paged_batch(batch, bucket)
            for (req, slot, _seq, plen, resumed), tok in zip(batch, toks):
                ev = self._finish_admission(req, slot, plen, int(tok), resumed)
                if ev is not None:
                    emitted.append(ev)
        return emitted

    def _admit_paged_batch(self, batch, bucket: int) -> np.ndarray:
        A = len(batch)
        a_pad = 1
        while a_pad < A:
            a_pad *= 2
        mp = self._bt_host.shape[1]
        tokens = np.zeros((a_pad, bucket), np.int64)
        ints = np.zeros((a_pad, 5), np.int64)
        floats = np.zeros((a_pad, 2), np.float32)
        bt_rows = np.full((a_pad, mp), -1, np.int32)
        # Padding rows: length 1, slot out of range (masked), bt_row -1
        # (page writes hit scratch), greedy sampling params.
        ints[:, 0] = 1
        ints[:, 1] = self.cfg.num_slots
        ints[:, 4] = -1
        floats[:, 1] = 1.0
        for i, (req, slot, seq, plen, _resumed) in enumerate(batch):
            tokens[i, :plen] = seq
            ints[i] = [
                plen,
                slot,
                req.seed,
                req.params.top_k,
                # Resume: force the already-emitted last token.
                req.out_tokens[-1] if req.out_tokens else -1,
            ]
            floats[i] = [req.params.temperature, req.params.top_p]
            bt_rows[i] = self._bt_host[slot]
        dev = self.device
        with torch.no_grad():
            toks = self._prefill_admit(
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(ints).to(dev),
                torch.from_numpy(floats).to(dev),
                torch.from_numpy(bt_rows).to(dev),
            )
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
        self._timing.append(
            ("ttft", max(0.0, _now() - req.t_enqueue), f"rid-{req.rid}")
        )
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
            # Free the pages and clear the row before the next decode: a
            # stale row would scatter the junk token of a freed slot into
            # pages that may now belong to a live sequence.
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
            return s <= c  # probe the currently losing arm
        return s > c

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
            emitted.extend(self._admit_pending_paged())
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
            if self._active:
                self._ensure_decode_pages(
                    inflight_lag=prev.chunk_len if prev is not None else 0
                )
                if self._bt_dirty:
                    t_up = time.perf_counter()
                    self._bt_staging.upload(self._bt_host)
                    self._bt_dirty = False
                    self._note_phase("dispatch", time.perf_counter() - t_up)
                riders = list(self._active.items())
                with torch.no_grad():
                    if self._spec and self._spec_pick():
                        mode = "spec"
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

    def _emit(self, req: _Request, tok: int) -> StepEvent:
        """Append one decoded token to a live request, releasing it when
        the token finishes it."""
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
        if call.program is self._spec_program:
            emitted = self._process_spec(*outputs, call.riders)
        else:
            toks = outputs[0]  # [chunk, num_slots]
            emitted = []
            for k in range(toks.shape[0]):
                for slot, req in call.riders:
                    if req.done:
                        continue  # surplus chunk tokens discarded
                    emitted.append(self._emit(req, int(toks[k, slot])))
        self._note_phase("sample", time.perf_counter() - t_sample)
        return emitted

    def _process_spec(self, choices: np.ndarray, n_emit: np.ndarray,
                      riders) -> list[StepEvent]:
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
                emitted.append(self._emit(req, int(choices[slot, j])))
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

    def generate(
        self,
        prompts: list[list[int]],
        params: SamplingParams | None = None,
    ) -> list[list[int]]:
        """Blocking batch generation (tests/benchmarks)."""
        rids = [self.add_request(p, params) for p in prompts]
        collected: dict[int, list[int]] = {r: [] for r in rids}
        while self.has_work():
            for ev in self.step():
                if ev.rid in collected:
                    collected[ev.rid].append(ev.token)
        return [collected[r] for r in rids]
