"""Continuous-batching inference engine core: paged KV cache, synchronous
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
torch tensors on the engine's device and is updated in place; the JAX
version threads it through jitted functions. `_prefill_admit` and
`_decode_chunk` are plain torch callables; the decode chunk is a Python
loop of `decode_chunk` steps.

Two JAX behaviours are reproduced by hand:
  - jit scatters drop out-of-range writes: admission padding rows carry
    slot = num_slots, and their state writes are masked out here;
  - jnp gathers clamp out-of-range indices: positions past a slot's
    block table map to scratch page 0 (ops.paged_attention).

Ported: paged mode, synchronous stepping, preemption by recompute, the
SLO scheduler, both decode layouts, and speculative decoding by prompt
lookup (adaptive or always on). Settings of the JAX engine that are not
ported raise NotImplementedError naming their ROADMAP item.
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
from kubeai_tpu_torch.engine.paged_cache import (
    OutOfPages,
    PageAllocator,
    PagedKVCache,
)
from kubeai_tpu_torch.engine.sampling import SamplingParams, sample
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
    step_overlap: str = "auto"  # "auto" resolves to off; "on": ROADMAP A7

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


def _resolve_overlap(cfg: EngineConfig) -> None:
    overlap = cfg.step_overlap
    if isinstance(overlap, bool):
        overlap = "on" if overlap else "off"
    overlap = (overlap or "auto").strip().lower()
    if overlap not in ("auto", "on", "off"):
        raise ValueError(
            f"unknown step_overlap {cfg.step_overlap!r} "
            "(expected 'auto' | 'on' | 'off')"
        )
    if overlap == "on":
        raise NotImplementedError(
            "overlapped stepping is not ported yet (ROADMAP A7); use "
            "step_overlap='auto' or 'off' (both run synchronously)"
        )


def _refuse_unported(cfg: EngineConfig, mesh, draft, decode_kernel: str) -> None:
    """Raise for every JAX engine setting this port does not serve."""
    if cfg.cache_mode == "slot":
        raise NotImplementedError(
            "cache_mode='slot' is not ported (ROADMAP A13); use 'paged'"
        )
    if cfg.cache_mode != "paged":
        raise ValueError(f"unknown cache_mode {cfg.cache_mode!r}")
    _resolve_overlap(cfg)
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


class Engine:
    """Single-model continuous-batching engine on one device."""

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
        # one [slots, MP] copy refreshes the device table before the next
        # decode (_bt_dirty).
        self._bt_host = np.full((cfg.num_slots, max_pages), -1, np.int32)
        self._bt_dirty = False

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

    def _decode_chunk(self) -> torch.Tensor:
        """`decode_chunk` paged decode steps over every slot, each followed
        by sample. The block tables are read-only here: the host grows
        pages to cover position + chunk before calling. Returns
        [chunk, num_slots] tokens."""
        st = self._state
        max_len = self.cfg.max_seq_len
        tokens, positions = st["tokens"], st["positions"]
        out = []
        for _ in range(max(1, self.cfg.decode_chunk)):
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
            out.append(tokens)
        st["tokens"], st["positions"] = tokens, positions
        return torch.stack(out)

    def _spec_step(self, proposals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One speculative step: verify [last_token, gamma proposals] in a
        single forward; accept the longest prefix where the seeded
        sampler's choice equals the proposal; emit accepted + 1 tokens.
        The stream equals vanilla decoding: choice k is sampled from the
        same logits with the same position it would see one step at a
        time, and a mismatch ends the window before any diverging context
        is used. Returns (choices [B, gamma + 1], n_emit [B])."""
        st = self._state
        gamma = self._spec
        positions = st["positions"]
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
        st["positions"] = torch.clamp(positions + n_emit, max=self.cfg.max_seq_len - 1)
        st["tokens"] = torch.gather(choices, 1, accepted[:, None])[:, 0]
        return choices, n_emit

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
            self._draining = True

    def has_work(self) -> bool:
        return bool(len(self._sched) or self._active)

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

    def _ensure_decode_pages(self) -> None:
        """Grow every active slot's pages to cover the next decode call.
        Pool exhaustion preempts the lowest-class, youngest other request
        (recompute on re-admission). The pool holds one full sequence, so
        the oldest request is always served."""
        chunk = self._decode_lookahead()
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
        """Admit pending prefills, then run one decode call: a decode chunk
        (cfg.decode_chunk model steps) or, with speculation, one verify
        window. Returns StepEvents in emission order."""
        with self._lock:
            emitted: list[StepEvent] = []
            t0 = time.perf_counter()
            emitted.extend(self._admit_pending_paged())
            if self._active:
                t_dec = time.perf_counter()
                self._ensure_decode_pages()
                if self._bt_dirty:
                    self.cache.block_tables.copy_(
                        torch.from_numpy(self._bt_host)
                    )
                    self._bt_dirty = False
                riders = list(self._active.items())
                mode = None
                with torch.no_grad():
                    if self._spec and self._spec_pick():
                        mode = "spec"
                        proposals = torch.from_numpy(self._build_proposals())
                        choices, n_emit = self._spec_step(
                            proposals.to(self.device, torch.int64)
                        )
                        evs = self._process_spec(choices, n_emit, riders)
                    else:
                        if self._spec:
                            mode = "chunk"
                        evs = self._process_chunk(self._decode_chunk(), riders)
                emitted.extend(evs)
                if mode is not None:
                    # Wall time covers the device work and the readback:
                    # the cost the mode choice trades off.
                    self._spec_observe(mode, len(evs), time.perf_counter() - t_dec)
            # The scheduler's drain-rate estimate (deadline feasibility,
            # Retry-After): completed requests per second of step time.
            finished = sum(1 for ev in emitted if ev.finished)
            self._sched.observe_service(finished, time.perf_counter() - t0)
            return emitted

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

    def _process_chunk(self, toks_seq: torch.Tensor, chunk_slots) -> list[StepEvent]:
        toks = toks_seq.cpu().numpy()  # [chunk, num_slots]
        emitted: list[StepEvent] = []
        for k in range(toks.shape[0]):
            for slot, req in chunk_slots:
                if req.done:
                    continue  # surplus chunk tokens discarded
                emitted.append(self._emit(req, int(toks[k, slot])))
        return emitted

    def _process_spec(self, choices: torch.Tensor, n_emit: torch.Tensor,
                      riders) -> list[StepEvent]:
        """Emit each slot's accepted and corrected tokens (1..gamma+1 per
        step). A stop mid-window discards the rest, like chunk surplus."""
        choices = choices.cpu().numpy()  # [B, gamma + 1]
        n_emit = n_emit.cpu().numpy()  # [B]
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
