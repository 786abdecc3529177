"""Lockstep serving: one engine program, N ranks.
Counterpart of kubeai_tpu/engine/multihost.py.

Under a mesh every rank must enter the same collectives in the same
order: each rank runs the same engine on the same requests (engine.py,
"Tensor and expert parallelism"). Requests, however, arrive only at
global rank 0 (the only rank that serves HTTP). The bridge is op
BROADCAST: rank 0 buffers control ops (admissions, cancels, adapter
loads), and each step() broadcasts a fixed-shape descriptor to every
rank (`_broadcast`, a `torch.distributed.broadcast` of host tensors over
a gloo group of every rank, never the NCCL group, so no descriptor enters
a CUDA graph; workers block there until rank 0 acts). Every rank then
applies the SAME ops to its engine and runs the SAME engine.step(): the
tp collectives line up across the mesh.

Determinism requirements this module enforces, as the JAX package does:
  - request ids: every rank calls inner.add_request in broadcast order,
    so rid sequences match;
  - sampling seeds: resolved ON RANK 0 (explicit seed or drawn once) and
    shipped in the descriptor, never derived from per-rank entropy;
  - page allocation: the allocator is a deterministic free-list, so
    identical op streams yield identical block tables on every rank.

LoRA hot-swap IS lockstep: rank 0's admin call broadcasts a control
descriptor carrying the op + adapter name, then (for loads) one
fixed-shape weight payload: the adapter's full A/B matrices zero-padded
to max_lora_rank, so every adapter broadcasts with identical shapes and
the padding contributes nothing to the delta. Every rank installs the
same weights into the same buffer row (row assignment is deterministic
under identical op order), cutting them to its heads as its projections
are cut (Engine.load_adapter). The broadcast happens INSIDE load_adapter
under the same I/O lock step() holds across its descriptor -> tokens ->
engine.step() sequence, so the collective order stays identical on every
rank.

The embedding forward is lockstep too, on a slice whose ranks all run
in one process (the server serves /v1/embeddings there, as the JAX
server does under its one-process mesh; a slice of several processes
keeps the JAX 400): `embed` broadcasts a control descriptor whose op is
EMBED with the batch's [B, S] in its first meta row, then the tokens and
lengths as one int64 [B, S + 1] payload, under the same I/O lock; every
rank then runs the family's `hidden_states` on its shard under its tp
group, and rank 0 returns the vectors. The descriptor keeps the JAX
module's layout: EMBED is one more code of the op column.

Two additions the JAX package does not need: a gloo collective has a
timeout, so while rank 0 idles it broadcasts a descriptor that runs no
step every `heartbeat_s` (a worker would otherwise time out waiting); and
a failed broadcast (a dead rank, a timed-out collective) calls
`on_failure`, which ends the server: no rank ever serves on with fewer
ranks. Each rank folds every stream its engine finished into a
`StreamDigest`, which the entry point logs at shutdown.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from kubeai_tpu_torch.engine.engine import (
    Engine,
    StepEvent,
    StepOverlapUnsupported,
)
from kubeai_tpu_torch.engine.sampling import SamplingParams

logger = logging.getLogger(__name__)

MAX_ADMITS = 8  # ops per step (excess stays buffered for the next step)
MAX_CANCELS = 32
# meta columns: plen, seed(int32 bit-cast), top_k, adapter_idx, max_tokens
_META_COLS = 5


@dataclasses.dataclass
class _PendingAdd:
    vrid: int  # the virtual rid handed to the caller
    tokens: list[int]
    params: SamplingParams
    adapter_idx: int = 0
    # Name kept alongside the resolved index so unload_adapter can refuse
    # while this admission is still buffered (the index must stay valid
    # until it broadcasts).
    adapter_name: str | None = None
    cancelled: bool = False


# header[4] op codes: the adapter ops, and the embedding forward (its
# [B, S] in meta[0, :2])
_ADAPTER_NONE, _ADAPTER_LOAD, _ADAPTER_UNLOAD, _EMBED = 0, 1, 2, 3
_ADAPTER_NAME_BYTES = 64


def _control_zeros() -> dict:
    """The per-step control descriptor: small (a few hundred bytes), so
    the common no-admission decode step stays cheap. The padded token
    matrix broadcasts in a SECOND collective only when n_admits > 0 (both
    sides branch on the same header, so the collective sequence stays
    identical across ranks); adapter LOAD ops likewise trigger a second,
    fixed-shape weight broadcast."""
    return {
        # n_admits, n_cancels, step, stop, adapter_op
        "header": np.zeros((5,), np.int32),
        "meta": np.zeros((MAX_ADMITS, _META_COLS), np.int32),
        "floats": np.zeros((MAX_ADMITS, 2), np.float32),  # temp, top_p
        "cancels": np.zeros((MAX_CANCELS,), np.int32),
        "adapter_name": np.zeros((_ADAPTER_NAME_BYTES,), np.uint8),
    }


def _encode_name(name: str) -> np.ndarray:
    raw = name.encode("utf-8")
    if len(raw) > _ADAPTER_NAME_BYTES:
        raise ValueError(
            f"adapter name longer than {_ADAPTER_NAME_BYTES} utf-8 bytes"
        )
    buf = np.zeros((_ADAPTER_NAME_BYTES,), np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    return buf


def _decode_name(buf: np.ndarray) -> str:
    return bytes(buf).rstrip(b"\x00").decode("utf-8")


def _lora_payload_zeros(engine: Engine) -> dict:
    """Fixed-shape weight payload: one {target.A/.B} float32 array pair
    per LoRA target, shaped like one whole (unsharded) adapter at rank
    max_lora_rank. Identical construction on every rank => identical
    broadcast shapes."""
    out = {}
    for target, (a_shape, b_shape) in engine.lora_shapes().items():
        out[target + ".A"] = np.zeros(a_shape, np.float32)
        out[target + ".B"] = np.zeros(b_shape, np.float32)
    return out


def _payload_to_weights(engine: Engine, payload: dict) -> dict:
    return {
        target: (payload[target + ".A"], payload[target + ".B"])
        for target in engine.lora_shapes()
    }


def _embed_payload_zeros(desc: dict) -> np.ndarray:
    """The embedding op's payload, shaped by its descriptor: each row's
    right-padded tokens, then its length."""
    B, S = (int(x) for x in desc["meta"][0, :2])
    return np.zeros((B, S + 1), np.int64)


def _embed(engine: Engine, payload: np.ndarray) -> torch.Tensor:
    """The family's hidden_states over the payload's rows on this rank's
    shard (its tp group's collectives inside): f32 [B, E] on the host."""
    dev = engine.device
    rows = torch.from_numpy(payload)
    kw = {} if engine._tp is None else {"tp": engine._tp}
    with torch.no_grad():
        vecs = engine.family.hidden_states(
            engine.params, engine.model_cfg, rows[:, :-1].to(dev), rows[:, -1].to(dev), **kw)
    return vecs.cpu()


def _broadcast(desc, group, is_source: bool):
    """`desc` (a dict of numpy arrays, or one array) as global rank 0 holds
    it, on every rank of `group`: one `dist.broadcast` of the arrays'
    bytes, packed into a CPU tensor. Every rank passes arrays of the same
    shapes and dtypes (a worker its zeros; `is_source` is kept for the
    JAX signature: rank 0 is the source)."""
    arrays = desc if isinstance(desc, dict) else {"": desc}
    flat = np.concatenate([
        np.ascontiguousarray(a).reshape(-1).view(np.uint8) for a in arrays.values()
    ])
    # The tensor shares flat's memory: a worker's bytes arrive in flat.
    dist.broadcast(torch.from_numpy(flat), src=0, group=group)
    out, off = {}, 0
    for k, a in arrays.items():
        out[k] = flat[off:off + a.nbytes].copy().view(a.dtype).reshape(a.shape)
        off += a.nbytes
    return out if isinstance(desc, dict) else out[""]


class StreamDigest:
    """A sha256 over every stream an engine finished, (inner rid, token
    count, tokens) in finish order: equal on every rank of a lockstep
    mesh."""

    def __init__(self):
        self._open: dict[int, list[int]] = {}
        self._sha = hashlib.sha256()
        self.streams = 0
        self.tokens = 0

    def feed(self, events) -> None:
        for ev in events:
            toks = self._open.setdefault(ev.rid, [])
            if ev.token is not None and ev.token >= 0:
                toks.append(int(ev.token))
            if ev.finished:
                del self._open[ev.rid]
                self._sha.update(np.asarray([ev.rid, len(toks), *toks], np.int64).tobytes())
                self.streams += 1
                self.tokens += len(toks)

    def hexdigest(self) -> str:
        return self._sha.hexdigest()


class LockstepEngine:
    """Engine facade for GLOBAL RANK 0: buffers ops, broadcasts them inside
    step(), and drives the inner engine exactly like every worker drives
    theirs. Exposes the Engine surface EngineServer consumes. `group` is a
    gloo group of every rank (None: the default group)."""

    is_lockstep = True  # server gates non-lockstep paths (embeddings, resume)

    def __init__(self, inner: Engine, group=None, heartbeat_s: float = 0.0,
                 on_failure=None):
        # Overlapped stepping cannot run under lockstep: every rank must
        # replay the SAME op/step sequence, and an unreaped chunk on rank
        # 0 would reorder its broadcast schedule relative to the workers'.
        # Explicit "on" is a typed refusal; "auto" silently degrades to
        # the synchronous loop. Defense in depth: server main() resolves
        # this before the worker engines are even built.
        explicit = inner.cfg.step_overlap
        if explicit is True or str(explicit).strip().lower() == "on":
            raise StepOverlapUnsupported(
                "step_overlap='on' does not compose with lockstep "
                "multihost: the overlapped reap would desynchronize the "
                "per-step cross-host broadcast; use 'auto' or 'off'"
            )
        inner._overlap = False
        self.inner = inner
        self.group = group
        self.on_failure = on_failure
        self.digest = StreamDigest()
        self._lock = threading.Lock()
        # Serializes every broadcast SEQUENCE (a step's descriptor ->
        # tokens -> engine.step(), an adapter op's descriptor -> payload,
        # a heartbeat, a shutdown) so the global collective order is
        # identical on every rank.
        self._io_lock = threading.RLock()
        self._adds: list[_PendingAdd] = []
        self._cancels: list[int] = []
        # Cancels that raced step(): their admission batch was popped
        # from _adds but its _rid_map entries weren't populated yet.
        # Resolved at the top of the next step().
        self._unresolved_cancels: list[int] = []
        self._next_virtual_rid = 0
        # virtual rid (handed to callers before broadcast) -> inner rid
        self._rid_map: dict[int, int] = {}
        self._entropy = np.random.default_rng()
        self._closed = threading.Event()
        self._last_broadcast = time.monotonic()
        self._heartbeat_s = heartbeat_s
        if heartbeat_s > 0:
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name="lockstep-heartbeat").start()

    # -- Engine surface used by EngineServer ----------------------------------

    @property
    def cfg(self):
        return self.inner.cfg

    @property
    def family(self):
        return self.inner.family

    @property
    def model_cfg(self):
        return self.inner.model_cfg

    @property
    def params(self):
        return self.inner.params

    @property
    def device(self):
        return self.inner.device

    @property
    def adapter_refusal(self) -> str:
        return self.inner.adapter_refusal

    @property
    def scheduler(self):
        return self.inner.scheduler

    @property
    def profiler(self):
        return self.inner.profiler

    @property
    def on_preempt(self):
        return self.inner.on_preempt

    @on_preempt.setter
    def on_preempt(self, fn) -> None:
        self.inner.on_preempt = fn

    def drain_timing(self) -> list[tuple]:
        return self.inner.drain_timing()

    @property
    def num_pending(self) -> int:
        with self._lock:
            return len(self._adds) + self.inner.num_pending

    @property
    def num_active(self) -> int:
        return self.inner.num_active

    def _bucket(self, n: int) -> int:
        return self.inner._bucket(n)

    def loaded_adapters(self) -> list[str]:
        return self.inner.loaded_adapters()

    def adapter_in_use(self, name: str) -> bool:
        """Engine-surface parity: the server pre-checks this before
        fetching reload weights. Advisory, like Engine.adapter_in_use."""
        return self.inner.adapter_in_use(name)

    # -- broadcasts -------------------------------------------------------------

    def _send(self, desc):
        """Broadcast from this rank (the caller holds _io_lock). A failure
        (a dead rank, a timed-out collective) goes to on_failure before it
        is raised."""
        try:
            out = _broadcast(desc, self.group, is_source=True)
        except Exception as e:
            logger.error("lockstep broadcast failed: %s", e)
            if self.on_failure is not None:
                self.on_failure(e)
            raise
        self._last_broadcast = time.monotonic()
        return out

    def _heartbeat_loop(self) -> None:
        """While rank 0 idles, a descriptor that runs no step every
        heartbeat_s, so the workers' waits stay inside the collective
        timeout and a dead rank is noticed."""
        while not self._closed.wait(self._heartbeat_s / 4):
            with self._io_lock:
                if self._closed.is_set():
                    return
                if time.monotonic() - self._last_broadcast < self._heartbeat_s:
                    continue
                try:
                    self._send(_control_zeros())
                except Exception:  # noqa: BLE001 — on_failure has run
                    return

    def load_adapter(self, name: str, adapter_weights: dict) -> None:
        """Lockstep adapter install: broadcast the op + padded weights to
        every rank, then install locally. Synchronous: returns once this
        rank has installed (workers install on their own receive,
        strictly before their next engine collective)."""
        if self.inner._lora is None:
            raise ValueError(
                self.inner.adapter_refusal or "LoRA is disabled (max_adapters=0)")
        name_buf = _encode_name(name)
        payload = _lora_payload_zeros(self.inner)
        r_max = self.cfg.max_lora_rank
        for target, (A, B) in adapter_weights.items():
            if target + ".A" not in payload:
                raise KeyError(f"unknown LoRA target {target!r}")
            A = np.asarray(A, np.float32)
            B = np.asarray(B, np.float32)
            r = A.shape[-1]
            if r > r_max:
                raise ValueError(f"adapter rank {r} > max_lora_rank {r_max}")
            want_a = payload[target + ".A"][..., :r].shape
            want_b = payload[target + ".B"][:, :r, :].shape
            if A.shape != want_a or B.shape != want_b:
                raise ValueError(
                    f"adapter {target} shapes {A.shape}, {B.shape} are not "
                    f"{want_a}, {want_b}")
            # Zero-pad rank to r_max: fixed broadcast shapes, and the
            # padding contributes nothing to x@A@B.
            payload[target + ".A"][..., :r] = A
            payload[target + ".B"][:, :r, :] = B
        desc = _control_zeros()
        desc["header"][4] = _ADAPTER_LOAD
        desc["adapter_name"] = name_buf
        with self._io_lock:
            # Capacity must be validated BEFORE any broadcast: a
            # post-broadcast raise would leave workers' loops dead (or
            # diverged) and the next step() collective hanging.
            if (
                name not in self.inner._adapter_slots
                and not self.inner._adapter_free
            ):
                raise RuntimeError(
                    f"adapter capacity ({self.cfg.max_adapters}) exhausted"
                )
            slot = self.inner._adapter_slots.get(name)
            if slot is not None and self.inner._adapter_in_use_locked(slot):
                # Same-name reload would overwrite weights under in-flight
                # streams; refuse BEFORE the broadcast (pre-broadcast
                # mirror of Engine.load_adapter's guard).
                raise RuntimeError(
                    f"adapter {name!r} has in-flight requests; retry "
                    "after they finish"
                )
            self._send(desc)
            payload = self._send(payload)
            self.inner.load_adapter(
                name, _payload_to_weights(self.inner, payload)
            )

    def embed(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Lockstep embedding forward: the op's descriptor and its payload
        broadcast, then the family's hidden_states on every rank. `tokens`
        [B, S] right-padded, `lengths` [B]; f32 [B, E] on the host."""
        if self.inner.family.hidden_states is None:
            raise ValueError(f"model family {self.family.name} has no embedding support")
        B, S = tokens.shape
        desc = _control_zeros()
        desc["header"][4] = _EMBED
        desc["meta"][0, :2] = (B, S)
        payload = _embed_payload_zeros(desc)
        payload[:, :-1] = tokens.cpu().numpy()
        payload[:, -1] = lengths.cpu().numpy()
        with self._io_lock:
            self._send(desc)
            return _embed(self.inner, self._send(payload))

    def unload_adapter(self, name: str) -> bool:
        if self.inner._lora is None or name not in self.inner._adapter_slots:
            return False
        desc = _control_zeros()
        desc["header"][4] = _ADAPTER_UNLOAD
        desc["adapter_name"] = _encode_name(name)
        with self._io_lock:
            # Buffered admissions hold a resolved slot index; unloading
            # now could let a subsequent load reassign that slot to a
            # DIFFERENT adapter before the admission broadcasts —
            # silently decoding with the wrong weights. Refuse instead.
            # _lock is held across the guard AND the broadcast+unload so
            # add_request can't resolve the slot in between; _io_lock is
            # held by step() across its _adds pop, so a popped-but-not-
            # yet-broadcast batch can't slip past the scan either.
            with self._lock:
                if any(
                    a.adapter_name == name and not a.cancelled
                    for a in self._adds
                ):
                    raise RuntimeError(
                        f"adapter {name!r} has queued requests; retry after "
                        "they admit"
                    )
                slot = self.inner._adapter_slots.get(name)
                if slot is not None and self.inner._adapter_in_use_locked(
                    slot
                ):
                    # Pre-broadcast mirror of Engine.unload_adapter's
                    # in-use refusal.
                    raise RuntimeError(
                        f"adapter {name!r} has in-flight requests; retry "
                        "after they finish"
                    )
                self._send(desc)
                return self.inner.unload_adapter(name)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._adds or self._cancels) or self.inner.has_work()

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
        if resume_tokens:
            # Continuation admission would have to replay the resume
            # prefix identically on every rank; until the descriptor
            # carries it, multi-host replicas refuse and the proxy falls
            # back to the terminal-error tail.
            raise ValueError(
                "stream resume is not supported on multi-host replicas"
            )
        # Scheduling args are accepted for API parity with Engine but not
        # broadcast: lockstep admission must replay in identical order on
        # every rank, so multi-host replicas keep FIFO ordering (every
        # inner scheduler sees the same default-class submissions and WFQ
        # degenerates to arrival order). Queue-full shedding still
        # applies at the HTTP layer; per-class precedence and deadline
        # shedding are single-host features for now.
        params = params or SamplingParams()
        if adapter and self.inner._lora is None:
            raise ValueError(
                self.inner.adapter_refusal or "LoRA is disabled (max_adapters=0)")
        if len(prompt_tokens) == 0:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self.inner.cfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(prompt_tokens)} >= max_seq_len "
                f"{self.inner.cfg.max_seq_len}"
            )
        # Seeds ship in the descriptor: resolve rank-0-side once, masked
        # to 32 bits (clients may send negative / >32-bit seeds; the
        # inner engine masks too, so the fold-in value stays identical).
        seed = (
            params.seed
            if params.seed is not None
            else int(self._entropy.integers(0, 2**31 - 1))
        )
        params = dataclasses.replace(params, seed=seed & 0xFFFFFFFF)
        with self._lock:
            # Resolve to the inner slot index under _lock so it serializes
            # with unload_adapter: either this admission is appended first
            # (the unload guard sees it and refuses) or the unload
            # completes first (the adapter is gone and we raise). The
            # index is deterministic across ranks; the descriptor ships it.
            adapter_idx = 0
            if adapter:
                slot = self.inner._adapter_slots.get(adapter)
                if slot is None:
                    raise KeyError(f"adapter {adapter!r} not loaded")
                adapter_idx = slot
            rid = self._next_virtual_rid
            self._next_virtual_rid += 1
            if on_admit is not None:
                # Same contract as Engine.add_request: registration is
                # visible before any step can emit events for this rid.
                on_admit(rid)
            self._adds.append(
                _PendingAdd(
                    rid, list(prompt_tokens), params, adapter_idx,
                    adapter or None,
                )
            )
            return rid

    def cancel(self, rid: int) -> bool:
        with self._lock:
            inner_rid = self._rid_map.pop(rid, None)
            if inner_rid is None:
                # Not yet broadcast: tombstone the buffered entry.
                for add in self._adds:
                    if add.vrid == rid and not add.cancelled:
                        add.cancelled = True
                        return True
                if 0 <= rid < self._next_virtual_rid:
                    # Mid-step race: the admission batch holding this rid
                    # is being broadcast right now (popped from _adds, not
                    # yet in _rid_map), or the request already finished.
                    # Defer; step() resolves or discards it.
                    self._unresolved_cancels.append(rid)
                    return True
                return False
            # Mapping pruned here: a cancelled request emits no further
            # events (the inner engine releases it on cancel), so keeping
            # the entry would only leak.
            self._cancels.append(inner_rid)
            return True

    def step(self) -> list[StepEvent]:
        """One lockstep iteration: broadcast buffered ops, apply, step.

        _io_lock is held from BEFORE the _adds pop: once an admission
        batch leaves the buffer its resolved adapter indices must stay
        valid until they broadcast, and unload_adapter (which serializes
        on _io_lock) could otherwise free a slot in that window after
        its buffered-admission scan found _adds already empty."""
        with self._io_lock:
            return self._step_locked()

    def _step_locked(self) -> list[StepEvent]:
        with self._lock:
            # Resolve cancels that raced the previous step's broadcast
            # window: by now (single stepping thread) their rids are
            # mapped, back in the buffer, or gone (finished); gone ones
            # are discarded.
            for vrid in self._unresolved_cancels:
                inner = self._rid_map.pop(vrid, None)
                if inner is not None:
                    self._cancels.append(inner)
                    continue
                for add in self._adds:
                    if add.vrid == vrid and not add.cancelled:
                        add.cancelled = True
                        break
            self._unresolved_cancels = []
            batch = self._adds[:MAX_ADMITS]
            self._adds = self._adds[MAX_ADMITS:]
            cancels = self._cancels[:MAX_CANCELS]
            self._cancels = self._cancels[MAX_CANCELS:]
        live = [a for a in batch if not a.cancelled]
        desc = _control_zeros()
        desc["header"][0] = len(live)
        desc["header"][1] = len(cancels)
        desc["header"][2] = 1  # run a decode step
        for i, add in enumerate(live):
            desc["meta"][i] = [
                len(add.tokens),
                np.uint32(add.params.seed).view(np.int32),
                add.params.top_k,
                add.adapter_idx,
                add.params.max_tokens,
            ]
            desc["floats"][i] = [add.params.temperature, add.params.top_p]
        desc["cancels"][: len(cancels)] = cancels

        out = self._send(desc)
        tokens = None
        if live:  # second, payload-sized collective only on admissions
            tokens = np.zeros((MAX_ADMITS, self.inner.cfg.max_seq_len), np.int32)
            for i, add in enumerate(live):
                tokens[i, : len(add.tokens)] = add.tokens
            tokens = self._send(tokens)
        inner_rids = _apply_descriptor(self.inner, out, tokens, do_step=False)
        with self._lock:
            for add, inner_rid in zip(live, inner_rids):
                self._rid_map[add.vrid] = inner_rid
        events = self.inner.step()
        self.digest.feed(events)
        # Map inner rids back to the virtual rids callers hold; prune
        # finished mappings so the table doesn't grow unboundedly.
        with self._lock:
            inv = {v: k for k, v in self._rid_map.items()}
            # Events whose inner rid has no live mapping (cancelled mid
            # step) are DROPPED: falling back to the raw inner rid could
            # deliver tokens to a different request's subscriber once the
            # virtual and inner sequences diverge.
            mapped = [
                StepEvent(inv[ev.rid], ev.token, ev.finished, ev.finish_reason)
                for ev in events
                if ev.rid in inv
            ]
            for ev in events:
                if ev.finished and ev.rid in inv:
                    self._rid_map.pop(inv[ev.rid], None)
        return mapped

    def generate(self, prompts, params=None):
        """Convenience parity with Engine.generate (tests, warm-up)."""
        outs: dict[int, list[int]] = {}
        rids = [self.add_request(p, params) for p in prompts]
        for r in rids:
            outs[r] = []
        while self.has_work():
            for ev in self.step():
                if ev.rid in outs and ev.token is not None:
                    outs[ev.rid].append(ev.token)
        return [outs[r] for r in rids]

    def shutdown(self) -> None:
        """Release the workers (they exit their loop)."""
        desc = _control_zeros()
        desc["header"][3] = 1
        with self._io_lock:
            self._closed.set()
            self._send(desc)


def _apply_descriptor(engine: Engine, desc: dict, tokens, do_step: bool,
                      digest: StreamDigest | None = None) -> list[int]:
    """Apply a broadcast descriptor to the local engine. Returns the inner
    rids assigned to this step's admissions (same on every rank, by
    construction). A descriptor whose step flag is 0 (a heartbeat) runs
    no step; a step's events go to `digest`."""
    n_admits = int(desc["header"][0])
    n_cancels = int(desc["header"][1])
    # adapter_idx -> name (slot assignment is deterministic, so the map
    # is identical on every rank).
    slot_names = (
        {v: k for k, v in engine._adapter_slots.items()}
        if engine._lora is not None
        else {}
    )
    rids = []
    for i in range(n_admits):
        plen, seed_bits, top_k, adapter_idx, max_tokens = (
            int(x) for x in desc["meta"][i]
        )
        temp, top_p = (float(x) for x in desc["floats"][i])
        params = SamplingParams(
            temperature=temp,
            top_k=top_k,
            top_p=top_p,
            max_tokens=max_tokens,
            seed=int(np.int32(seed_bits).view(np.uint32)),
        )
        if adapter_idx and adapter_idx not in slot_names:
            raise RuntimeError(
                f"lockstep admission names adapter slot {adapter_idx}, which this "
                "rank has not loaded: its state has diverged from rank 0's"
            )
        rids.append(
            engine.add_request(
                [int(t) for t in tokens[i, :plen]], params,
                adapter=slot_names.get(adapter_idx),
            )
        )
    for i in range(n_cancels):
        engine.cancel(int(desc["cancels"][i]))
    if do_step and int(desc["header"][2]):
        events = engine.step()
        if digest is not None:
            digest.feed(events)
    return rids


def worker_loop(engine: Engine, group=None, digest: StreamDigest | None = None) -> StreamDigest:
    """WORKER ranks (global rank > 0): receive descriptors until rank 0's
    shutdown, mirroring its ops and steps. Blocks inside the broadcast
    collective while rank 0 is idle. A failed collective (rank 0 gone, a
    timeout) raises, and so does an adapter load or unload, an embedding
    forward, or an admission's adapter, that fails on this rank after
    rank 0 took it.
    Returns the digest of the streams it produced."""
    engine._overlap = False
    digest = digest if digest is not None else StreamDigest()
    logger.info("multihost worker loop running")
    while True:
        desc = _broadcast(_control_zeros(), group, is_source=False)
        if int(desc["header"][3]):
            logger.info("multihost worker loop: shutdown")
            return digest
        adapter_op = int(desc["header"][4])
        if adapter_op == _ADAPTER_LOAD:
            payload = _broadcast(_lora_payload_zeros(engine), group, is_source=False)
            # Rank 0 validated the load before broadcasting it, so a
            # failure here means this rank's state has diverged from rank
            # 0's. The JAX module logs it and keeps stepping; here it ends
            # the worker, and with it the replica, rather than serve a
            # model that differs by rank.
            engine.load_adapter(
                _decode_name(desc["adapter_name"]),
                _payload_to_weights(engine, payload),
            )
        elif adapter_op == _ADAPTER_UNLOAD:
            engine.unload_adapter(_decode_name(desc["adapter_name"]))
        elif adapter_op == _EMBED:
            _embed(engine, _broadcast(_embed_payload_zeros(desc), group, is_source=False))
        tokens = None
        if int(desc["header"][0]):
            tokens = _broadcast(
                np.zeros((MAX_ADMITS, engine.cfg.max_seq_len), np.int32),
                group, is_source=False,
            )
        _apply_descriptor(engine, desc, tokens, do_step=True, digest=digest)
