"""The engine's device programs: the decode chunk, the speculative
verify window and the three staged-chunk admission calls, each
dispatched as one call. Counterpart of the JAX engine's `_decode_jit` (a
jitted `lax.scan` over the chunk), `_spec_jit`, `_stage_chunk_mid_jit`,
`_stage_chunk_last_jit` and `_stage_from_pages_jit`
(kubeai_tpu/engine/engine.py).

A `DeviceProgram` wraps a function that reads the engine's device state
and writes its results into fixed output tensors, in place, touching
every tensor at a fixed address. On a CUDA device the function is
captured once into a CUDA graph, after one warm-up call that builds what
a capture must find ready (the kernels' library, the cuBLAS handles, the
rope tables); each dispatch replays it, one host launch for the
thousands of kernels of a decode chunk. On the CPU each dispatch calls
the function eagerly through the same static tensors, so the CPU tests
exercise the same buffer handling.

Overlapped stepping dispatches call N+1 before the host reads call N,
and that dispatch overwrites the static outputs. So every dispatch also
copies its outputs, on the stream, into one slot of a two-deep ring of
host buffers (pinned on the card) and records an event behind the copy;
the host waits on that event when it reaps the call. `HostStaging` is
the same in the other direction: a host array reaches a fixed device
tensor through pinned buffers without blocking the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from kubeai_tpu_torch.ops import COUNTED_KERNELS


class DeviceProgram:
    """One device call of the engine. `fn()` reads the engine's device
    state and writes `outputs` in place. With `capture` (a CUDA device
    only) a dispatch replays a CUDA graph of `fn`; a capture or a replay
    that fails raises. Otherwise `fn` runs eagerly.

    `dispatch()` returns the ring slot that will hold this call's outputs
    on the host; `wait(slot)` blocks until they are there and
    `read(slot)` returns copies of them. A slot is written again two
    dispatches later, and only once it has been read."""

    depth = 2

    def __init__(
        self,
        fn: Callable[[], None],
        outputs: tuple[torch.Tensor, ...],
        device: torch.device,
        *,
        capture: bool,
        pool=None,
    ):
        self.fn = fn
        self.outputs = tuple(outputs)
        self.graph: torch.cuda.CUDAGraph | None = None
        # Dispatches since the count was last set to 0.
        self.dispatches = 0
        # Kernel launches one replay makes, by wrapper name (empty when
        # eager: there the wrappers count their own launches).
        self.launches_per_replay: dict[str, int] = {}
        # Device memory the capture reserved for the graph's temporaries.
        self.pool_bytes = 0
        cuda = device.type == "cuda"
        self._host = [
            tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                  for t in self.outputs)
            for _ in range(self.depth)
        ]
        self._events = [torch.cuda.Event() if cuda else None
                        for _ in range(self.depth)]
        self._unread = [False] * self.depth
        self._next = 0
        if capture:
            self._capture(device, pool)

    def _capture(self, device: torch.device, pool) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.fn()  # warm-up, outside the capture
        torch.cuda.current_stream(device).wait_stream(side)
        # A replay calls no wrapper, so the launches a capture counts are
        # the launches of every replay; only the kernels the program runs
        # are kept.
        before = {name: w.launches for name, w in COUNTED_KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved(device)
            self.fn()
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches_per_replay = {
            name: w.launches - before[name]
            for name, w in COUNTED_KERNELS.items() if w.launches > before[name]
        }
        self.graph = graph

    def launches(self) -> dict[str, int]:
        """Kernel launches made by replays since `dispatches` was set to
        0, by wrapper name."""
        return {name: n * self.dispatches
                for name, n in self.launches_per_replay.items()}

    def dispatch(self) -> int:
        slot = self._next
        if self._unread[slot]:
            raise RuntimeError(
                "device program dispatched over a ring slot whose outputs "
                "the host has not read"
            )
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()
        for host, out in zip(self._host[slot], self.outputs):
            host.copy_(out, non_blocking=True)
        event = self._events[slot]
        if event is not None:
            event.record()
        self._unread[slot] = bool(self.outputs)
        self._next = (slot + 1) % self.depth
        self.dispatches += 1
        return slot

    def wait(self, slot: int) -> None:
        event = self._events[slot]
        if event is not None:
            event.synchronize()

    def read(self, slot: int) -> list[np.ndarray]:
        self.wait(slot)
        self._unread[slot] = False
        return [host.numpy().copy() for host in self._host[slot]]


class HostStaging:
    """Copies host arrays into one fixed device tensor `dst` (a captured
    graph keeps reading its address) without blocking the host: each copy
    is enqueued on the stream from one of two host buffers (pinned on the
    card), and a buffer is refilled only after the event recorded behind
    its last copy, so a later edit of the host array cannot reach a copy
    already enqueued."""

    depth = 2

    def __init__(self, dst: torch.Tensor):
        self.dst = dst
        cuda = dst.device.type == "cuda"
        self._bufs = [torch.empty(dst.shape, dtype=dst.dtype, pin_memory=cuda)
                      for _ in range(self.depth)]
        self._events = [torch.cuda.Event() if cuda else None
                        for _ in range(self.depth)]
        self._next = 0

    def upload(self, src: np.ndarray) -> None:
        i = self._next
        self._next = (i + 1) % self.depth
        event = self._events[i]
        if event is not None:
            event.synchronize()
        buf = self._bufs[i]
        buf.numpy()[...] = src
        self.dst.copy_(buf, non_blocking=True)
        if event is not None:
            event.record()
