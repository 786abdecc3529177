"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # every phase, one card

Phases, each fatal on failure:
  1. build   — compile the CUDA kernels of kubeai_tpu_torch/csrc with nvcc
               for sm_90a and print the build seconds and each kernel's
               registers and spills;
  2. kernels — each kernel (B1 paged decode, B2 flash prefill, B3 paged
               verify, B4 fused paged decode) against its plain PyTorch
               version on the card, in bf16 at the serving path's
               Llama-3-8B shapes, with times (from a CUDA graph, and
               eager), the plain version's and one PyTorch library call's
               times, and the least time the card could take (bound); one
               wrong page must fail each paged kernel's limit. B1, B3 and
               B4 also: the edges of their split page walks, B=1 at a 16k
               context; B1's slots past the block table; rows that keep no
               key must be 0. B2 also: ragged S, B=1 at 2048 and 8192.
               For every kernel: two calls and a CUDA-graph replay that
               must give the same bits, its head_dim-64 build, and no
               spills;
  3. model   — a small model (head_dim 128) on the card through the kernels
               against the same weights in f32 on the CPU through the plain
               versions: prefill, paged-decode (both layouts) and
               speculative-verify logits, greedy picks, and lm_head logits
               kept in f32;
  4. serve   — EngineServer over Engine with random Llama-3-8B-shape weights
               on cuda answers concurrent /v1/chat/completions requests
               (one streamed) three times over the same weights, with the
               engine's defaults: the decode chunk and the verify window
               replayed from CUDA graphs, and overlapped stepping. The
               per_layer decode layout (B1 and B2 must launch), prompt-lookup
               speculation (B3 must launch, B1 must not) and the fused
               layout (B4 must launch, B1 must not); B1, B3 and B4 are
               counted as launches per replay x replays and must launch
               only from replays. Each run's greedy and seeded streams must
               equal those of an eager, synchronous engine on the same
               weights. After each run torch.profiler times the decode
               chunk or verify window replayed from its graph and run
               eagerly: wall and device time per step, idle share, device
               time by kernel; the graph pools' memory and the step
               profiler's phase totals are printed. After the per_layer run
               it times one prefill admission at B=1 for the 512 and 1024
               buckets, with B2's device ms and launches. A fourth run
               (`serve_prefix`) turns on chunked prefill (prefill_chunk=512)
               and the prefix cache and sends two waves of chat requests
               over one 1,024-token system prompt: B1 and B2 must launch,
               the staged-chunk programs must dispatch only as graph
               replays, the cache must hit the tokens its rule gives, and
               the streams must equal an eager synchronous engine's; it
               reports TTFT of hits and misses, agreement with whole-prompt
               streams, and a miss and a hit admission from the graphs and
               eagerly. After the per_layer run, `serve_resume` sends the
               proxy's continuation request (`kubeai_resume`): the four
               bodies, greedy and seeded, cut after 1, 5 and 17 tokens,
               then each body alone cut after 1 and 5, then one greedy and
               one seeded cut after 5 with speculation (B3) and fused
               (B4). Each continuation's SSE token ids must be its engine
               tokens and its text the text past `emitted`; every stream
               must equal an eager synchronous engine's fed the same
               requests; a cut after one token must continue the
               uninterrupted stream exactly (agreement past longer cuts,
               which recompute generated tokens through the prefill in
               bf16, is reported); B1 and B2, then B3, then B4 must launch
               for the continuations; `{"kubeai_resume": "nope"}` must get
               400; and POST /v1/profile with `jax_trace` while generates
               run must capture 16 steps and a torch.profiler trace that
               names B1's combine kernel. Prints the continuations' TTFT
               beside the uninterrupted requests';
  5. serve_cli — the engine Pod's entry point: a random-weight Llama
               checkpoint at Llama-3-8B width (4 layers, bf16) written with
               `weights.save_safetensors`, served by `python -m
               kubeai_tpu_torch.engine.server` in a subprocess three times
               (default, `--speculate 4`, and the fused layout through
               KUBEAI_TPU_DECODE_KERNEL); each run: the four chat requests
               of the serve runs (one streamed), /metrics and /v1/state,
               /v1/drain and SIGTERM, which must exit 0 within the drain
               budget. The same checkpoint loaded in-process through
               `weights.load_params` must be bit-equal to the tensors
               written, and an in-process engine of each run's
               configuration on it must give the greedy streams served over
               HTTP. Each run also sends one request with a traceparent
               and an X-Request-Id: its server span must reach a local
               OTLP/HTTP sink (OTEL_EXPORTER_OTLP_TRACES_ENDPOINT) with the
               client's trace id, parent and request id. Reports the load
               rate, the cold-start phases and TTFT.

The last lines are the kernel JSON line, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}. Without a CUDA device, or
without the kubeai_tpu_torch package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time

# Peak rates of one H100 SXM (NVIDIA data sheet, dense bf16, HBM3).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Kernel vs plain version, both on the card in bf16, compared in f32.
# Paged decode keeps P in f32; the two differ by the bf16 rounding of the
# output (at most one bf16 step, 2^-7 relative) and f32 sum order. The
# phase checks that one wrong page in a 2048-token slot fails this limit.
PAGED_ATOL = 2e-3
PAGED_RTOL = 1e-2
# Flash prefill also rounds P to bf16 before P.V (2^-8 relative on each
# weight), on top of the output rounding and the sum order.
FLASH_ATOL = 2e-2
FLASH_RTOL = 2e-2
# Small model, bf16 on the card (kernels) against f32 on the CPU (plain):
# bf16 weights and activations through a few layers.
MODEL_ATOL = 5e-2
MODEL_RTOL = 5e-2
# Paged verify (B3) is held against its plain version computed in f32 on
# the same bf16 values: the rows of a slot at position 0 average only 1-5
# values, so their outputs are O(1) and the bf16 plain version's own
# rounding of q * scale moves them by two bf16 steps (1.6e-2 at 2.6, read
# on the card); in f32 the plain version leaves the kernel's output
# rounding and sum order (7.8e-3 at 2.7, a third of this limit). Fused
# paged decode (B4) is held against the bf16 plain version, as B1 is
# (3.9e-3 read). The phase checks that one wrong page fails each limit.
VERIFY_ATOL = 2e-3
VERIFY_RTOL = 1e-2
FUSED_ATOL = 2e-3
FUSED_RTOL = 1e-2
# lm_head logits on the card against an f32 product of the same bf16
# operands on the CPU: only the sum order differs when the GEMM keeps its
# f32 accumulator; rounding the logits to bf16 would move them by about
# 2^-9 of their size (~1e-3 here).
LOGITS_ATOL = 1e-4
# Kernel name -> (its CUDA source, the TPU kernel's pallas_call it replaces).
KERNELS = {
    "paged_decode_attention": (
        "kubeai_tpu_torch/csrc/paged_decode.cu",
        "kubeai_tpu/ops/paged_attention.py:309",
    ),
    "flash_causal_prefill": (
        "kubeai_tpu_torch/csrc/flash_prefill.cu",
        "kubeai_tpu/ops/pallas_attention.py:108",
    ),
    "paged_verify_attention": (
        "kubeai_tpu_torch/csrc/paged_verify.cu",
        "kubeai_tpu/ops/paged_attention.py:569",
    ),
    "paged_decode_attention_fused": (
        "kubeai_tpu_torch/csrc/paged_decode_fused.cu",
        "kubeai_tpu/ops/paged_attention.py:837",
    ),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def capture(fn, iters: int = 1):
    """(a CUDA graph of `iters` calls of fn, the last call's output)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm the caching allocator outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            out = fn()
    return graph, out


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed, so the host's launch overhead between calls drops out."""
    import torch

    graph, _ = capture(fn, iters)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def within(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    """(every element within atol + rtol * |want|, max |err|), in f32."""
    got = got.float().cpu()
    want = want.float().cpu()
    err = (got - want).abs()
    return bool((err <= atol + rtol * want.abs()).all()), float(err.max())


def compare(name: str, got, want, atol: float, rtol: float) -> float:
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite values")
    ok, max_err = within(got, want, atol, rtol)
    if not ok:
        fail(f"{name}: max |err| {max_err:.3e} beyond atol {atol} rtol {rtol}")
    return max_err


# ---- phase 1: build ----------------------------------------------------------


def phase_build() -> None:
    from kubeai_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"build: {path} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.last_build_seconds:.2f} s)", flush=True)
    log = path.parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or line.startswith("==")):
                print(f"  {line.strip()}")


# ---- phase 2: kernels against their plain versions ---------------------------


def _table(lengths, page: int, mp: int, gen):
    """Block tables: slot b holds ceil(lengths[b] / page) pages (at most
    mp), drawn without repeats from pages 1.. of the pool."""
    import torch

    B = len(lengths)
    perm = torch.randperm(B * mp, generator=gen, device="cpu") + 1
    bt = torch.full((B, mp), -1, dtype=torch.int32)
    used = 0
    for b in range(B):
        need = min(-(-int(lengths[b]) // page), mp)
        bt[b, :need] = perm[used:used + need].to(torch.int32)
        used += need
    return bt


def _wrong_page_fails(name: str, got, bad, atol: float, rtol: float) -> None:
    """The limit has teeth: the plain version over a block table with one
    wrong page must fail it."""
    ok, bad_err = within(got, bad, atol, rtol)
    if ok:
        fail(f"{name}: one wrong page stays within the limit (max |err| {bad_err:.3e})")
    print(f"{name}: one wrong page in slot 0 gives max |err| {bad_err:.3e}, "
          f"beyond atol {atol} rtol {rtol}", flush=True)


def _paged_inputs(gen, B=8, H=32, KVH=8, D=128, page=64, max_len=2048):
    import torch

    mp = max_len // page
    n_pages = 1 + B * mp
    lengths = torch.randint(1, max_len + 1, (B,), generator=gen, device="cpu")
    lengths[0] = max_len  # one full-length slot, one single-token slot
    lengths[1] = 1
    bt = _table(lengths.tolist(), page, mp, gen)
    dev = "cuda"
    q = torch.randn(B, H, D, generator=gen, device="cpu").to(dev, torch.bfloat16)
    kp = torch.randn(n_pages, page, KVH, D, generator=gen, device="cpu").to(dev, torch.bfloat16)
    vp = torch.randn(n_pages, page, KVH, D, generator=gen, device="cpu").to(dev, torch.bfloat16)
    return q, kp, vp, bt.to(dev), lengths.to(dev, torch.int32)


def check_paged_decode() -> dict:
    """B1 at the serving shapes: 8 slots, lengths ragged up to 2048 (slot 0
    the whole table, slot 1 one token), four cases and one wrong page; then
    two calls and a CUDA-graph replay that must give the same bits, the
    split edges, slots past the block table, B=1 at a 16k context, and
    B1's registers and spills from the build log."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        ref_paged_decode_attention,
    )

    gen = torch.Generator().manual_seed(1)
    q, kp, vp, bt, lengths = _paged_inputs(gen)
    B, H, D = q.shape
    KVH, page = kp.shape[2], kp.shape[1]
    args = (q, kp, vp, bt, lengths)
    result = None
    for cap, win in ((None, None), (30.0, None), (None, 500), (50.0, 100)):
        kw = dict(logit_softcap=cap, window=win)
        got, err = _check_decode_case(f"softcap={cap} window={win}", args, kw)
        if cap is None and win is None:
            # One page of the full-length slot 0 read from slot 2's first.
            bad_bt = bt.clone()
            bad_bt[0, 5] = bt[2, 0]
            _wrong_page_fails("paged_decode", got,
                              ref_paged_decode_attention(q, kp, vp, bad_bt, lengths),
                              PAGED_ATOL, PAGED_RTOL)
        line = _time_decode(args, kw, library=cap is None and win is None)
        line["max_abs_err"] = err
        if cap is None and win is None:
            result = dict(line)
        print("kernel paged_decode_attention B=%d H=%d KVH=%d D=%d page=%d "
              "max_len=%d %s" % (B, H, KVH, D, page, int(lengths.max()), json.dumps(line)),
              flush=True)

    # The combine merges the splits in a fixed order: two calls, same bits.
    first = paged_decode_attention(*args)
    if not torch.equal(first, paged_decode_attention(*args)):
        fail("paged_decode: two calls on the same inputs differ")
    # The wrapper reads no device value: one call captured in a CUDA graph
    # and replayed gives the eager call's output.
    graph, captured = capture(lambda: paged_decode_attention(*args))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, first):
        fail("paged_decode: the CUDA-graph replay differs from the eager call")
    print("paged_decode: two eager calls bit-identical; CUDA-graph replay equals "
          "the eager call", flush=True)
    check_decode_split_edges(q, kp, vp, gen)
    check_decode_past_table(q, kp, vp, gen)
    check_decode_long_context()
    check_ptxas("paged_decode.cu")
    return result


def _decode_masked_slots(lengths, L: int, window):
    """[B] True where a B1 slot keeps no key at all: length 0, or a window
    wholly past the L keys of the block table."""
    lengths = lengths.long()
    masked = lengths <= 0
    if window:
        masked = masked | (lengths - window >= L)
    return masked


def _check_decode_case(tag: str, args, kw: dict):
    """B1 against its bf16 plain version; a slot that keeps no key must be
    0 (the plain version averages every column there, as the JAX reference
    does). Returns (B1's output, max |err|)."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        ref_paged_decode_attention,
    )

    _, kp, _, bt, lengths = args
    got = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    want = ref_paged_decode_attention(*args, **kw)
    masked = _decode_masked_slots(lengths, bt.shape[1] * kp.shape[1], kw.get("window"))
    if bool(masked.any()):
        if not bool((got[masked] == 0).all()):
            fail(f"paged_decode {tag}: a slot that keeps no key is not 0")
        want = torch.where(masked[:, None, None], torch.zeros_like(want), want)
    return got, compare(f"paged_decode {tag}", got, want, PAGED_ATOL, PAGED_RTOL)


def _time_decode(args, kw: dict, library: bool) -> dict:
    """B1's time, its plain version's, its bound for this data and, where
    asked, SDPA's on the same keys gathered dense and length-masked (its
    yardstick). B1 and SDPA are timed from a CUDA graph (`ms`,
    `library_ms`: device time per call) and eagerly (`eager_ms`,
    `library_eager_ms`: back-to-back calls from Python, which the host's
    launch overhead can bound); `split_ms` and `combine_ms` are B1's two
    kernels from torch.profiler."""
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        ref_paged_decode_attention,
    )

    q, kp, vp, bt, lengths = args
    B, H, D = q.shape
    KVH, page = kp.shape[2], kp.shape[1]
    L = bt.shape[1] * page
    win = kw.get("window")
    call = lambda: paged_decode_attention(*args, **kw)  # noqa: E731
    ms, eager_ms = graph_ms(call), cuda_ms(call)
    plain_ms = cuda_ms(lambda: ref_paged_decode_attention(*args, **kw), iters=5)
    kernel_ms = device_ms_by_kernel(call, ("split_walk_kernel", "combine_kernel"))
    # This data's work: the keys the mask keeps inside the table, read
    # once; 4 * D flops per head per kept key; q and the output, the block
    # tables and the lengths.
    n_keys = sum(max(min(n, L) - (max(n - win, 0) if win else 0), 0)
                 for n in lengths.tolist())
    nbytes = (n_keys * KVH * D * 2 * 2 + 2 * q.numel() * 2
              + bt.numel() * 4 + lengths.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = 4.0 * D * H * n_keys / PEAK_BF16_FLOPS * 1e3
    line = dict(softcap=kw.get("logit_softcap"), window=win, ms=ms, eager_ms=eager_ms,
                split_ms=kernel_ms["split_walk_kernel"],
                combine_ms=kernel_ms["combine_kernel"], plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_flops), bytes=nbytes,
                bound_by="bytes" if t_bytes >= t_flops else "operations")
    if library:
        idx = bt.long().clamp(min=0)
        kd = kp[idx].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
        vd = vp[idx].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
        mask = (torch.arange(L, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd, vd, attn_mask=mask, enable_gqa=True)
        line["library_ms"], line["library_eager_ms"] = graph_ms(sdpa), cuda_ms(sdpa)
        del kd, vd
    return line


def check_decode_split_edges(q, kp, vp, gen) -> None:
    """Lengths at the edges of B1's splits (a boundary, one either side,
    twice over), 1 and 0 (which must write 0), on the kernel phase's pool,
    with a window that masks whole splits. No timing."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import fused_split

    B, page, mp = q.shape[0], kp.shape[1], 32
    _, per = fused_split(B, kp.shape[2], mp, page)
    edge = per * page  # tokens in a split
    lengths = torch.tensor([edge, edge - 1, edge + 1, 1, 0, 2 * edge,
                            2 * edge - 1, 2 * edge + 1][:B])
    bt = _table(lengths.tolist(), page, mp, gen).to("cuda")
    args = (q, kp, vp, bt, lengths.to("cuda", torch.int32))
    errs = [_check_decode_case(f"split edges {edge} softcap={cap} window={win}", args,
                               dict(logit_softcap=cap, window=win))[1]
            for cap, win in ((None, None), (30.0, None), (None, edge + 10), (50.0, 100))]
    print(f"paged_decode split edges (splits of {edge} tokens; lengths "
          f"{lengths.tolist()}; plain, softcap 30, window {edge + 10}, softcap 50 + "
          f"window 100; length 0 writes 0): max |err| {['%.3e' % e for e in errs]}",
          flush=True)


def check_decode_past_table(q, kp, vp, gen) -> None:
    """Slots whose length passes the 32-page block table keep only the
    table's keys, as the TPU kernel's (B, MP) grid does: the bf16 plain
    version, which masks over the table's columns, is the reference. With
    a window wholly past the table a slot keeps no key and must write 0.
    No timing."""
    import torch

    B, page, mp = q.shape[0], kp.shape[1], 32
    L = mp * page
    lengths = torch.tensor([L + 1, L + 5, L + 64, L + 1000, 2 * L, L + 3, 1, L][:B])
    bt = _table(lengths.tolist(), page, mp, gen).to("cuda")
    args = (q, kp, vp, bt, lengths.to("cuda", torch.int32))
    cases = ((None, None), (30.0, None), (None, 500), (50.0, 100), (None, 2))
    errs = [_check_decode_case(f"past the table softcap={cap} window={win}", args,
                               dict(logit_softcap=cap, window=win))[1]
            for cap, win in cases]
    n_masked = [int(_decode_masked_slots(lengths, L, win).sum()) for _, win in cases]
    print(f"paged_decode past the table ({L} keys; lengths {lengths.tolist()}; plain, "
          f"softcap 30, window 500, softcap 50 + window 100, window 2; slots keeping no "
          f"key, all 0: {n_masked}): max |err| {['%.3e' % e for e in errs]}", flush=True)


def check_decode_long_context() -> None:
    """B=1 at a 16k context: length 16384 over 256 pages, the shape where
    one CTA per (slot, kv head) left most SMs idle."""
    import torch

    B, H, KVH, D, page, mp = 1, 32, 8, 128, 64, 256
    gen = torch.Generator().manual_seed(16)
    lengths = torch.tensor([mp * page])
    bt = _table(lengths.tolist(), page, mp, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(17)

    def rnd(*shape):
        return torch.randn(*shape, generator=cg, device="cuda").to(torch.bfloat16)

    kp, vp = rnd(1 + B * mp, page, KVH, D), rnd(1 + B * mp, page, KVH, D)
    args = (rnd(B, H, D), kp, vp, bt, lengths.to("cuda", torch.int32))
    _, err = _check_decode_case("B=1 16k", args, {})
    line = _time_decode(args, {}, library=True)
    line["max_abs_err"] = err
    print("kernel paged_decode_attention long context B=%d H=%d KVH=%d D=%d page=%d "
          "length=%d %s" % (B, H, KVH, D, page, int(lengths[0]), json.dumps(line)),
          flush=True)
    del kp, vp, args
    torch.cuda.empty_cache()


def check_flash_prefill() -> dict:
    """B2 at the serving widths (H=32, KVH=8, D=128): B=1 and 4 over the
    serve phase's buckets and a ragged 200, and B=1 at 2048 and 8192, each
    against the plain version and timed beside SDPA; then two calls and a
    CUDA-graph replay that must give the same bits, and B2's registers and
    spills from the build log."""
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.attention import causal_prefill_attention
    from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill

    H, KVH, D = 32, 8, 128
    gen = torch.Generator().manual_seed(2)
    main = None
    # S=32 and 128 are the buckets of the serve phase's two short prompts
    # (32 is less than one 128-row block); 512 and 1024 those of its long
    # ones; 2048 is its max_seq_len; 8192 a long prompt.
    cases = [(B, S) for B in (1, 4) for S in (32, 128, 200, 512, 1024)]
    for B, S in cases + [(1, 2048), (1, 8192)]:
        mk = lambda h: torch.randn(B, S, h, D, generator=gen, device="cpu").to(  # noqa: E731
            "cuda", torch.bfloat16)
        q, k, v = mk(H), mk(KVH), mk(KVH)
        got = flash_causal_prefill(q, k, v)
        torch.cuda.synchronize()
        want = causal_prefill_attention(q, k, v)
        err = compare(f"flash_prefill B={B} S={S}", got, want, FLASH_ATOL, FLASH_RTOL)
        del got, want
        # B2 and SDPA from a CUDA graph (device time per call) and eagerly
        # (back-to-back calls from Python, which the host's launch overhead
        # can bound at the small shapes). The plain version's f32 logits
        # take 8.6 GB at S=8192: few calls there.
        call = lambda: flash_causal_prefill(q, k, v)  # noqa: E731
        ms, eager_ms = graph_ms(call), cuda_ms(call)
        few = S >= 4096
        plain_ms = cuda_ms(lambda: causal_prefill_attention(q, k, v),
                           iters=1 if few else 5, warmup=1 if few else 3)
        torch.cuda.empty_cache()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_ms, lib_eager_ms = graph_ms(sdpa), cuda_ms(sdpa)
        flops = 4.0 * B * H * D * S * (S + 1) / 2
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D)
        t_flops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        line = dict(max_abs_err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                    library_ms=lib_ms, library_eager_ms=lib_eager_ms,
                    bound_ms=max(t_flops, t_bytes),
                    bound_by="operations" if t_flops >= t_bytes else "bytes",
                    tflops=flops / ms * 1e-9)
        print("kernel flash_causal_prefill B=%d S=%d H=%d KVH=%d D=%d %s"
              % (B, S, H, KVH, D, json.dumps(line)), flush=True)
        if (B, S) == (1, 512):
            main = line
        if (B, S) == (4, 1024):
            # Every CTA writes its own rows, in one order: two calls give
            # the same bits. The wrapper reads no device value and builds
            # its TMA maps on the host: a CUDA-graph replay of one call
            # gives the eager call's output.
            first = flash_causal_prefill(q, k, v)
            if not torch.equal(first, flash_causal_prefill(q, k, v)):
                fail("flash_prefill: two calls on the same inputs differ")
            graph, captured = capture(call)
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(captured, first):
                fail("flash_prefill: the CUDA-graph replay differs from the eager call")
            print("flash_prefill: two eager calls bit-identical; CUDA-graph replay "
                  "equals the eager call", flush=True)
            del first, captured, graph
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    check_ptxas("flash_prefill.cu")
    return main


def check_paged_verify() -> dict:
    """B3 at the serving shapes: 8 slots, a gamma = 4 window (K = 5),
    positions ragged up to 2043, and slot 2's window running past the end
    of its 32-page block table; then two calls and a CUDA-graph replay
    that must give the same bits, the split edges (with a row masked in
    every split), B=1 at a 16k context, and B3's registers and spills
    from the build log."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_verify_attention,
        ref_paged_verify_attention,
    )

    B, K, H, KVH, D, page, max_len = 8, 5, 32, 8, 128, 64, 2048
    mp = max_len // page
    gen = torch.Generator().manual_seed(5)
    positions = torch.randint(0, max_len - K + 1, (B,), generator=gen)
    positions[0] = max_len - K  # the whole table, up to 2043 + 4
    positions[1] = 0
    positions[2] = max_len - 2  # rows at 2046..2050: three past the table
    bt = _table((positions + K).tolist(), page, mp, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(6)
    q = torch.randn(B, K, H, D, generator=cg, device="cuda").to(torch.bfloat16)
    kp = torch.randn(1 + B * mp, page, KVH, D, generator=cg, device="cuda").to(torch.bfloat16)
    vp = torch.randn(1 + B * mp, page, KVH, D, generator=cg, device="cuda").to(torch.bfloat16)
    pos = positions.to("cuda", torch.int32)
    args = (q, kp, vp, bt, pos)
    result = None
    for cap, win in ((None, None), (30.0, None), (None, 500), (50.0, 100)):
        kw = dict(logit_softcap=cap, window=win)
        got, err = _check_verify_case(f"softcap={cap} window={win}", args, kw)
        bf16_err = within(got, ref_paged_verify_attention(*args, **kw),
                          VERIFY_ATOL, VERIFY_RTOL)[1]
        if cap is None and win is None:
            bad_bt = bt.clone()
            bad_bt[0, 5] = bt[3, 0]
            _wrong_page_fails("paged_verify", got, ref_paged_verify_attention(
                q.float(), kp.float(), vp.float(), bad_bt, pos), VERIFY_ATOL, VERIFY_RTOL)
        line = _time_verify(args, kw, library=cap is None and win is None)
        line["max_abs_err"] = err
        line["max_abs_err_vs_bf16_plain"] = bf16_err
        if cap is None and win is None:
            result = dict(line)
        print("kernel paged_verify_attention B=%d K=%d H=%d KVH=%d D=%d page=%d "
              "positions<=%d %s" % (B, K, H, KVH, D, page, int(positions.max()),
                                    json.dumps(line)), flush=True)

    # The combine merges the splits in a fixed order: two calls, same bits.
    first = paged_verify_attention(*args)
    if not torch.equal(first, paged_verify_attention(*args)):
        fail("paged_verify: two calls on the same inputs differ")
    # The wrapper reads no device value: one call captured in a CUDA graph
    # and replayed gives the eager call's output.
    graph, captured = capture(lambda: paged_verify_attention(*args))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, first):
        fail("paged_verify: the CUDA-graph replay differs from the eager call")
    print("paged_verify: two eager calls bit-identical; CUDA-graph replay equals "
          "the eager call", flush=True)
    check_verify_split_edges(q, kp, vp, gen)
    check_verify_long_context()
    check_ptxas("paged_verify.cu")
    return result


def _verify_masked_rows(pos, K: int, L: int, window):
    """[B, K] True where a verify row keeps no key at all: its window lies
    wholly past the L keys of the block table."""
    import torch

    q_abs = pos.long()[:, None] + torch.arange(K, device=pos.device)
    if not window:
        return torch.zeros_like(q_abs, dtype=torch.bool)
    return q_abs - window + 1 >= L


def device_ms_by_kernel(call, names, calls: int = 10) -> dict:
    """Device ms per call of each kernel whose name holds one of `names`,
    from torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    call()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    found = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for name in names:
            if e.device_type.name == "CUDA" and name in e.key:
                found[name] += getattr(e, "self_device_time_total", 0) / 1e3 / calls
    return found


def _check_verify_case(tag: str, args, kw: dict):
    """B3 against its plain version in f32 on the same bf16 values; a row
    masked in every split must be 0 (the plain version averages every
    column there, as the JAX reference does). Returns (B3's output, max
    |err|)."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_verify_attention,
        ref_paged_verify_attention,
    )

    q, kp, vp, bt, pos = args
    got = paged_verify_attention(*args, **kw)
    torch.cuda.synchronize()
    want = ref_paged_verify_attention(q.float(), kp.float(), vp.float(), bt, pos, **kw)
    masked = _verify_masked_rows(pos, q.shape[1], bt.shape[1] * kp.shape[1], kw.get("window"))
    if bool(masked.any()):
        if not bool((got[masked] == 0).all()):
            fail(f"paged_verify {tag}: a row masked everywhere is not 0")
        want = torch.where(masked[:, :, None, None], 0.0, want)
    err = compare(f"paged_verify {tag}", got, want, VERIFY_ATOL, VERIFY_RTOL)
    return got, err


def _time_verify(args, kw: dict, library: bool) -> dict:
    """B3's time, its plain version's, its bound for this data and, where
    asked, SDPA's on the same keys gathered dense with the causal window
    mask (its yardstick). B3 and SDPA are timed from a CUDA graph (`ms`,
    `library_ms`: device time per call) and eagerly (`eager_ms`,
    `library_eager_ms`: back-to-back calls from Python, which the host's
    launch overhead can bound)."""
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_verify_attention,
        ref_paged_verify_attention,
    )

    q, kp, vp, bt, pos = args
    B, K, H, D = q.shape
    KVH, page = kp.shape[2], kp.shape[1]
    L = bt.shape[1] * page
    win = kw.get("window")
    call = lambda: paged_verify_attention(*args, **kw)  # noqa: E731
    ms, eager_ms = graph_ms(call), cuda_ms(call)
    plain_ms = cuda_ms(lambda: ref_paged_verify_attention(*args, **kw), iters=5)
    kernel_ms = device_ms_by_kernel(call, ("split_kernel", "combine_kernel"))
    # This data's work: each slot reads the keys its rows can see (row 0's
    # window edge to the last row's position, inside the table) once; row
    # k does 4 * D flops per head per key it keeps.
    n_keys = n_pairs = 0
    for p in pos.tolist():
        lo = max(p - win + 1, 0) if win else 0
        n_keys += max(min(p + K, L) - lo, 0)
        for k in range(K):
            row_lo = max(p + k - win + 1, 0) if win else 0
            n_pairs += max(min(p + k, L - 1) - row_lo + 1, 0)
    nbytes = (n_keys * KVH * D * 2 * 2 + 2 * q.numel() * 2
              + bt.numel() * 4 + pos.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = 4.0 * D * H * n_pairs / PEAK_BF16_FLOPS * 1e3
    line = dict(softcap=kw.get("logit_softcap"), window=win, ms=ms, eager_ms=eager_ms,
                split_ms=kernel_ms["split_kernel"], combine_ms=kernel_ms["combine_kernel"],
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_flops), bytes=nbytes,
                bound_by="bytes" if t_bytes >= t_flops else "operations")
    if library:
        idx = bt.long().clamp(min=0)
        kd = kp[idx].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
        vd = vp[idx].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
        q_abs = pos.long()[:, None] + torch.arange(K, device="cuda")
        mask = (torch.arange(L, device="cuda")[None, None, :] <= q_abs[:, :, None])[:, None]
        qt = q.transpose(1, 2).contiguous()  # [B, H, K, D]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kd, vd, attn_mask=mask, enable_gqa=True)
        line["library_ms"], line["library_eager_ms"] = graph_ms(sdpa), cuda_ms(sdpa)
        del kd, vd
    return line


def check_verify_split_edges(q, kp, vp, gen) -> None:
    """Positions at the edges of B3's splits on the kernel phase's pool:
    windows whose row 0 lies in one split and row K - 1 in the next, 0, 1
    and one past the table; a window that masks whole splits, and window 2,
    where the last rows of the slot past the table keep no key in any
    split and must write 0. No timing."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import fused_split

    B, K, page, mp = q.shape[0], q.shape[1], kp.shape[1], 32
    _, per = fused_split(B, kp.shape[2], mp, page)
    edge = per * page  # tokens in a split
    positions = torch.tensor([edge - 1, edge - K + 1, edge, 0, 1, 2 * edge - 2,
                              2 * edge - K, mp * page - 2][:B])
    bt = _table((positions + K).tolist(), page, mp, gen).to("cuda")
    args = (q, kp, vp, bt, positions.to("cuda", torch.int32))
    cases = ((None, None), (30.0, None), (None, edge + 10), (50.0, 100), (None, 2))
    errs = [_check_verify_case(f"split edges {edge} softcap={cap} window={win}", args,
                               dict(logit_softcap=cap, window=win))[1]
            for cap, win in cases]
    n_masked = int(_verify_masked_rows(args[4], K, mp * page, 2).sum())
    print(f"paged_verify split edges (splits of {edge} tokens; positions "
          f"{positions.tolist()}; plain, softcap 30, window {edge + 10}, softcap 50 + "
          f"window 100, window 2 with {n_masked} rows masked everywhere, all 0): max |err| "
          f"{['%.3e' % e for e in errs]}", flush=True)


def check_verify_long_context() -> None:
    """B=1 at a 16k context: the window's last row at position 16383 over
    256 pages, the shape where one CTA per (slot, kv head) left most SMs
    idle."""
    import torch

    B, K, H, KVH, D, page, mp = 1, 5, 32, 8, 128, 64, 256
    gen = torch.Generator().manual_seed(14)
    positions = torch.tensor([mp * page - K])
    bt = _table((positions + K).tolist(), page, mp, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(15)

    def rnd(*shape):
        return torch.randn(*shape, generator=cg, device="cuda").to(torch.bfloat16)

    kp, vp = rnd(1 + B * mp, page, KVH, D), rnd(1 + B * mp, page, KVH, D)
    args = (rnd(B, K, H, D), kp, vp, bt, positions.to("cuda", torch.int32))
    _, err = _check_verify_case("B=1 16k", args, {})
    line = _time_verify(args, {}, library=True)
    line["max_abs_err"] = err
    print("kernel paged_verify_attention long context B=%d K=%d H=%d KVH=%d D=%d "
          "page=%d positions=%d %s" % (B, K, H, KVH, D, page, int(positions[0]),
                                       json.dumps(line)), flush=True)
    del kp, vp, args
    torch.cuda.empty_cache()


def ptxas_report(source: str) -> list[tuple[str, int, int]]:
    """(entry function, registers, spill-store bytes) of each kernel that
    ptxas compiled from `source`, read from the build log."""
    from kubeai_tpu_torch.ops import _build

    log = _build.build_dir() / "build.log"
    rows, entry, spills, in_source = [], None, 0, False
    for line in log.read_text().splitlines():
        line = line.strip()
        if line.startswith("== "):
            in_source = line[3:] == source
        elif in_source and "Compiling entry function" in line:
            entry, spills = line.split("'")[1], 0
        elif in_source and "spill stores" in line:
            spills = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif in_source and entry and "Used" in line and "registers" in line:
            rows.append((entry, int(line.split("Used")[1].split()[0]), spills))
            entry = None
    return rows


def check_ptxas(source: str) -> None:
    """Print the registers and spills of every kernel ptxas compiled from
    `source`; fail if there is no report or any kernel spills."""
    rows = ptxas_report(source)
    if not rows:
        fail(f"{source}: no ptxas report in the build log")
    for entry, regs, spills in rows:
        # _ZN...paged_split_walk_kernelILi128ELi4ELb0EEEv... ->
        # paged_split_walk_kernel<128, 4, 0>
        m = re.search(r"([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)", entry)
        name = (f"{m.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                if m else entry)
        print(f"ptxas {source} {name}: {regs} registers, {spills} bytes spilled",
              flush=True)
    spilled = [e for e, _, s in rows if s]
    if spilled:
        fail(f"{source}: ptxas spills in {spilled}")


def check_paged_fused() -> dict:
    """B4 on a stacked pool of 4 layers at layer 2, the serving widths,
    old lengths ragged up to 2047 and slot 1 empty (pos 0); then two calls
    and a CUDA-graph replay that must give the same bits, the split edges,
    B=1 at a 16k context, and B4's registers and spills from the build
    log."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention_fused,
        ref_paged_decode_attention_fused,
    )

    B, H, KVH, D, page, max_len, NL, layer = 8, 32, 8, 128, 64, 2048, 4, 2
    mp = max_len // page
    gen = torch.Generator().manual_seed(7)
    positions = torch.randint(1, max_len, (B,), generator=gen)
    positions[0] = max_len - 1  # the whole table with the new token
    positions[1] = 0
    bt = _table((positions + 1).tolist(), page, mp, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(8)
    shape = (NL, 1 + B * mp, page, KVH, D)
    q = torch.randn(B, H, D, generator=cg, device="cuda").to(torch.bfloat16)
    kp = torch.randn(shape, generator=cg, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=cg, device="cuda").to(torch.bfloat16)
    kn = torch.randn(B, KVH, D, generator=cg, device="cuda").to(torch.bfloat16)
    vn = torch.randn(B, KVH, D, generator=cg, device="cuda").to(torch.bfloat16)
    pos = positions.to("cuda", torch.int32)
    args = (q, kp, vp, kn, vn, bt, pos, layer)
    result = None
    for cap, win in ((None, None), (30.0, None), (None, 500), (50.0, 100)):
        kw = dict(logit_softcap=cap, window=win)
        # Slot 1 has no old tokens: every head's output is its v_new.
        got, err = _check_fused_case(f"softcap={cap} window={win}", args, kw)
        if cap is None and win is None:
            bad_bt = bt.clone()
            bad_bt[0, 5] = bt[2, 0]
            _wrong_page_fails("paged_fused", got, ref_paged_decode_attention_fused(
                q, kp, vp, kn, vn, bad_bt, pos, layer), FUSED_ATOL, FUSED_RTOL)
            # And the layer offset has teeth: the same call on layer 1.
            _wrong_page_fails("paged_fused (layer 1 for 2)", got,
                              ref_paged_decode_attention_fused(
                                  q, kp, vp, kn, vn, bt, pos, 1), FUSED_ATOL, FUSED_RTOL)
        line = _time_fused(args, kw, library=cap is None and win is None)
        line["max_abs_err"] = err
        if cap is None and win is None:
            result = dict(line)
        print("kernel paged_decode_attention_fused NL=%d layer=%d B=%d H=%d KVH=%d D=%d "
              "page=%d positions<=%d %s" % (NL, layer, B, H, KVH, D, page,
                                            int(positions.max()), json.dumps(line)),
              flush=True)

    # The combine merges the splits in a fixed order: two calls, same bits.
    first = paged_decode_attention_fused(*args)
    if not torch.equal(first, paged_decode_attention_fused(*args)):
        fail("paged_fused: two calls on the same inputs differ")
    # The wrapper reads no device value: one call captured in a CUDA graph
    # and replayed gives the eager call's output.
    graph, captured = capture(lambda: paged_decode_attention_fused(*args))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, first):
        fail("paged_fused: the CUDA-graph replay differs from the eager call")
    print("paged_fused: two eager calls bit-identical; CUDA-graph replay equals "
          "the eager call", flush=True)
    check_fused_split_edges(q, kp, vp, kn, vn, layer, gen)
    check_fused_long_context()
    check_ptxas("paged_decode_fused.cu")
    return result


def _time_fused(args, kw: dict, library: bool) -> dict:
    """B4's time, its plain version's, its bound for this data and, where
    asked, SDPA's on the same keys gathered dense (its yardstick). B4 and
    SDPA are timed from a CUDA graph (`ms`, `library_ms`: device time per
    call) and eagerly (`eager_ms`, `library_eager_ms`: back-to-back calls
    from Python, which the host's launch overhead can bound)."""
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention_fused,
        ref_paged_decode_attention_fused,
    )

    q, kp, vp, kn, vn, bt, pos, layer = args
    B, H, D = q.shape
    KVH, page = kp.shape[3], kp.shape[2]
    L = bt.shape[1] * page
    call = lambda: paged_decode_attention_fused(*args, **kw)  # noqa: E731
    ms, eager_ms = graph_ms(call), cuda_ms(call)
    plain_ms = cuda_ms(lambda: ref_paged_decode_attention_fused(*args, **kw), iters=5)
    # This data's work: the old keys the mask keeps, read once, and the
    # new token's K/V; 4 * D flops per head per kept key.
    lens = torch.clamp(pos.long().cpu(), max=L)
    if kw.get("window"):
        lens = torch.clamp(lens, max=kw["window"] - 1)
    n_keys = int(lens.sum()) + B
    nbytes = (n_keys * KVH * D * 2 * 2 + 2 * q.numel() * 2
              + bt.numel() * 4 + pos.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = 4.0 * D * H * n_keys / PEAK_BF16_FLOPS * 1e3
    line = dict(softcap=kw.get("logit_softcap"), window=kw.get("window"), ms=ms,
                eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_flops),
                bytes=nbytes,
                bound_by="bytes" if t_bytes >= t_flops else "operations")
    if library:
        # SDPA over the layer's keys gathered dense with the new token
        # concatenated, length-masked.
        idx = bt.long().clamp(min=0)
        kd = torch.cat([kp[layer][idx].reshape(B, L, KVH, D), kn[:, None]], 1)
        vd = torch.cat([vp[layer][idx].reshape(B, L, KVH, D), vn[:, None]], 1)
        kd, vd = (x.transpose(1, 2).contiguous() for x in (kd, vd))
        col = torch.arange(L + 1, device="cuda")
        mask = ((col[None, :] < pos.long()[:, None]) | (col[None, :] == L))[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd, vd, attn_mask=mask, enable_gqa=True)
        line["library_ms"], line["library_eager_ms"] = graph_ms(sdpa), cuda_ms(sdpa)
    return line


def _check_fused_case(tag: str, args, kw: dict):
    """B4 against its plain version, and every slot at position 0 equal
    to its v_new bit for bit. Returns (B4's output, max |err|)."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention_fused,
        ref_paged_decode_attention_fused,
    )

    got = paged_decode_attention_fused(*args, **kw)
    torch.cuda.synchronize()
    err = compare(f"paged_fused {tag}", got, ref_paged_decode_attention_fused(*args, **kw),
                  FUSED_ATOL, FUSED_RTOL)
    q, vn, pos = args[0], args[4], args[6]
    group = q.shape[1] // vn.shape[1]
    for b in (pos == 0).nonzero().flatten().tolist():
        if not torch.equal(got[b], vn[b].repeat_interleave(group, 0)):
            fail(f"paged_fused {tag}: slot {b} at position 0 is not v_new")
    return got, err


def check_fused_split_edges(q, kp, vp, kn, vn, layer: int, gen) -> None:
    """Old lengths at the edges of the kernel's splits (a boundary, one
    either side, twice over), 1 and 0, on the kernel phase's pool, with a
    window that masks whole splits. No timing."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import fused_split

    B, page, mp = q.shape[0], kp.shape[2], 32
    _, per = fused_split(B, kp.shape[3], mp, page)
    edge = per * page  # tokens in a split
    positions = torch.tensor([edge, edge - 1, edge + 1, 1, 0, 2 * edge,
                              2 * edge - 1, 2 * edge + 1][:B])
    bt = _table((positions + 1).tolist(), page, mp, gen).to("cuda")
    pos = positions.to("cuda", torch.int32)
    args = (q, kp, vp, kn, vn, bt, pos, layer)
    errs = [_check_fused_case(f"split edges {edge} softcap={cap} window={win}", args,
                              dict(logit_softcap=cap, window=win))[1]
            for cap, win in ((None, None), (30.0, None), (None, edge + 10), (50.0, 100))]
    print(f"paged_fused split edges (splits of {edge} tokens; old lengths "
          f"{positions.tolist()}; plain, softcap 30, window {edge + 10}, softcap 50 + "
          f"window 100): max |err| {['%.3e' % e for e in errs]}", flush=True)


def check_fused_long_context() -> None:
    """B=1 at a 16k context: old length 16383 over 256 pages of a 2-layer
    stacked pool, the shape where one CTA per (slot, kv head) left most
    SMs idle."""
    import torch

    B, H, KVH, D, page, mp, NL, layer = 1, 32, 8, 128, 64, 256, 2, 1
    gen = torch.Generator().manual_seed(12)
    positions = torch.tensor([mp * page - 1])
    bt = _table((positions + 1).tolist(), page, mp, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(13)

    def rnd(*shape):
        return torch.randn(*shape, generator=cg, device="cuda").to(torch.bfloat16)

    shape = (NL, 1 + B * mp, page, KVH, D)
    kp, vp = rnd(*shape), rnd(*shape)
    q, kn, vn = rnd(B, H, D), rnd(B, KVH, D), rnd(B, KVH, D)
    args = (q, kp, vp, kn, vn, bt, positions.to("cuda", torch.int32), layer)
    _, err = _check_fused_case("B=1 16k", args, {})
    line = _time_fused(args, {}, library=True)
    line["max_abs_err"] = err
    print("kernel paged_decode_attention_fused long context NL=%d layer=%d B=%d H=%d "
          "KVH=%d D=%d page=%d positions=%d %s" % (NL, layer, B, H, KVH, D, page,
                                                  int(positions[0]), json.dumps(line)),
          flush=True)
    del kp, vp
    torch.cuda.empty_cache()


def check_head_dim_64() -> None:
    """The kernels' head_dim-64 builds (Llama-3.2-1B's head size), which
    the 8B-shape checks above do not run: B1, B3 and B4 against their
    plain versions at their own limits, at a smaller size, with and
    without softcap and window; B2 at a ragged and a whole-block S. No
    timing."""
    import torch

    from kubeai_tpu_torch.ops.attention import causal_prefill_attention
    from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_fused,
        paged_verify_attention,
        ref_paged_decode_attention,
        ref_paged_decode_attention_fused,
        ref_paged_verify_attention,
    )

    B, K, H, KVH, D, page, max_len = 4, 5, 32, 8, 64, 64, 512
    mp = max_len // page
    gen = torch.Generator().manual_seed(10)
    positions = torch.randint(1, max_len - K + 1, (B,), generator=gen)
    positions[1] = 0
    bt = _table((positions + K).tolist(), page, mp, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=cg, device="cuda").to(torch.bfloat16)

    kp, vp = rnd(2, 1 + B * mp, page, KVH, D), rnd(2, 1 + B * mp, page, KVH, D)
    q, qk, kn, vn = rnd(B, H, D), rnd(B, K, H, D), rnd(B, KVH, D), rnd(B, KVH, D)
    pos = positions.to("cuda", torch.int32)
    errs = []
    for cap, win in ((None, None), (50.0, 100)):
        kw = dict(logit_softcap=cap, window=win)
        tag = f"D=64 softcap={cap} window={win}"
        got = paged_decode_attention(q, kp[1], vp[1], bt, pos + 1, **kw)
        errs.append(compare(f"paged_decode {tag}", got, ref_paged_decode_attention(
            q, kp[1], vp[1], bt, pos + 1, **kw), PAGED_ATOL, PAGED_RTOL))
        got = paged_verify_attention(qk, kp[1], vp[1], bt, pos, **kw)
        errs.append(compare(f"paged_verify {tag}", got, ref_paged_verify_attention(
            qk.float(), kp[1].float(), vp[1].float(), bt, pos, **kw),
            VERIFY_ATOL, VERIFY_RTOL))
        got = paged_decode_attention_fused(q, kp, vp, kn, vn, bt, pos, 1, **kw)
        errs.append(compare(f"paged_fused {tag}", got, ref_paged_decode_attention_fused(
            q, kp, vp, kn, vn, bt, pos, 1, **kw), FUSED_ATOL, FUSED_RTOL))
    for S in (200, 512):
        q, k, v = rnd(2, S, H, D), rnd(2, S, KVH, D), rnd(2, S, KVH, D)
        errs.append(compare(f"flash_prefill D=64 S={S}", flash_causal_prefill(q, k, v),
                            causal_prefill_attention(q, k, v), FLASH_ATOL, FLASH_RTOL))
    print(f"kernels at head_dim 64 (B1, B3, B4: plain, softcap 50 + window 100; "
          f"B2: S=200, 512): max |err| {['%.3e' % e for e in errs]}", flush=True)


def phase_kernels() -> dict:
    measured = {
        "paged_decode_attention": check_paged_decode(),
        "flash_causal_prefill": check_flash_prefill(),
        "paged_verify_attention": check_paged_verify(),
        "paged_decode_attention_fused": check_paged_fused(),
    }
    check_head_dim_64()
    return measured


# ---- phase 3: a small model through the kernels against the plain path ------


def phase_model() -> None:
    import dataclasses

    import torch

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops.paged_attention import (
        batched_scatter_sequence,
        batched_sequence_page_coords,
    )

    cfg = llama.LlamaConfig(
        vocab_size=1024, hidden_size=512, intermediate_size=1024,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
        rope_theta=10000.0, max_position_embeddings=4096,
    )
    p16 = llama.init_params(cfg, torch.Generator("cuda").manual_seed(3), device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    # The CPU side computes in f32 on the same (bf16-rounded) weights.
    p32 = {k: ({n: w.float().cpu() for n, w in v.items()} if isinstance(v, dict)
               else v.float().cpu()) for k, v in p16.items()}
    gen = torch.Generator().manual_seed(4)
    B, S, page, mp = 2, 256, 64, 8
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    lengths = torch.tensor([S, 190])
    out = {}
    for dev, params, c in (("cuda", p16, cfg), ("cpu", p32, cfg32)):
        with torch.no_grad():
            logits, k_all, v_all = llama.prefill(params, c, tokens.to(dev), lengths.to(dev))
            shape = (cfg.num_layers, 1 + B * mp, page, cfg.num_kv_heads, cfg.head_size)
            kp = torch.zeros(shape, dtype=c.dtype, device=dev)
            vp = torch.zeros(shape, dtype=c.dtype, device=dev)
            bt = torch.arange(1, 1 + B * mp, dtype=torch.int32).reshape(B, mp).to(dev)
            ids, offs = batched_sequence_page_coords(bt, lengths.to(dev), S, page)
            batched_scatter_sequence(kp, vp, k_all, v_all, ids, offs)
            step_tok = torch.tensor([7, 11], device=dev)
            kp_f, vp_f = kp.clone(), vp.clone()
            dlogits, kp, vp = llama.decode_step_paged(
                params, c, step_tok, lengths.to(dev), kp, vp, bt,
                attn_kernel="per_layer")
            # The same step in the fused layout, on a copy of the pools.
            flogits, kp_f, _ = llama.decode_step_paged(
                params, c, step_tok, lengths.to(dev), kp_f, vp_f, bt,
                attn_kernel="fused")
            # A verify window over the pools the per_layer step wrote: its
            # row 0 is that step again (same token, same position).
            window_toks = torch.cat([step_tok[:, None], tokens[:, 1:5].to(dev)], 1)
            vlogits, kp_v, _ = llama.decode_verify_paged(
                params, c, window_toks, lengths.to(dev), kp.clone(), vp.clone(), bt)
        # Page 0 is scratch: padded tail positions all write there, and
        # which duplicate write lands is unspecified.
        out[dev] = (logits, k_all, dlogits, kp[:, 1:], flogits, kp_f[:, 1:],
                    vlogits, kp_v[:, 1:])
    names = ("prefill logits", "prefill k_all", "decode logits", "decode k_pages",
             "fused decode logits", "fused decode k_pages", "verify logits",
             "verify k_pages")
    for i, name in enumerate(names):
        err = compare(f"model {name}", out["cuda"][i], out["cpu"][i], MODEL_ATOL, MODEL_RTOL)
        print(f"model {name}: cuda bf16 (kernels) vs cpu f32 (plain) max |err| {err:.3e}",
              flush=True)
    # On the card: verify row 0 (B3) against the per_layer decode step (B1),
    # and the fused step (B4) against it.
    for i, name in ((6, "verify row 0"), (4, "fused decode")):
        got = out["cuda"][i][:, 0] if i == 6 else out["cuda"][i]
        err = compare(f"model {name} vs decode on the card", got, out["cuda"][2],
                      MODEL_ATOL, MODEL_RTOL)
        print(f"model {name} vs per_layer decode logits, both on the card: max |err| "
              f"{err:.3e}", flush=True)
    x = torch.randn(4, cfg.hidden_size, generator=gen).to("cuda", torch.bfloat16)
    with torch.no_grad():
        got = llama._logits(x, p16["lm_head"])
    want = x.float().cpu() @ p16["lm_head"].float().cpu().t()
    if got.dtype != torch.float32:
        fail(f"lm_head logits are {got.dtype}, not float32")
    err = compare("model lm_head logits", got, want, LOGITS_ATOL, 0.0)
    rounded = float((want.bfloat16().float() - want).abs().max())
    print(f"model lm_head logits: cuda bf16 GEMM with f32 output vs cpu f32 max |err| "
          f"{err:.3e} (rounding them to bf16 would give {rounded:.3e})", flush=True)
    # Greedy picks, bf16 on the card against f32 on the CPU: where the two
    # differ, the card's pick must be a near-tie on the CPU side.
    for name, i in (("prefill", 0), ("decode", 2), ("fused decode", 4), ("verify", 6)):
        g = out["cuda"][i].float().cpu().reshape(-1, cfg.vocab_size)
        c = out["cpu"][i].float().reshape(-1, cfg.vocab_size)
        pick = g.argmax(-1)
        gap = c.max(-1).values - c.gather(-1, pick[:, None])[:, 0]
        if bool((gap > MODEL_ATOL).any()):
            fail(f"model greedy {name}: card picks {pick.tolist()}, cpu picks "
                 f"{c.argmax(-1).tolist()}, cpu-side gap {gap.tolist()}")
        print(f"model greedy {name}: {int((pick == c.argmax(-1)).sum())}/{len(pick)} "
              f"picks equal to the cpu's; largest cpu-side gap {float(gap.max()):.3e}",
              flush=True)


# ---- phase 4: serve on the 8B-shape model ---------------------------------------


def _post(port: int, body: dict, headers: dict | None = None,
          path: str = "/v1/chat/completions") -> tuple[int, dict, float, float]:
    """POST a chat completion. Returns (status, result, seconds to the
    first response byte, total seconds); a stream's result gathers its
    chunks, their text and their token ids."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    first = None
    if not body.get("stream"):
        data = resp.read()
        first = time.perf_counter() - t0
        conn.close()
        return resp.status, json.loads(data), first, time.perf_counter() - t0
    chunks, done = [], False
    for raw in resp:
        line = raw.decode().strip()
        if not line.startswith("data: "):
            continue
        if first is None:
            first = time.perf_counter() - t0
        if line == "data: [DONE]":
            done = True  # read on to the end of the chunked body
            continue
        chunks.append(json.loads(line[6:]))
    conn.close()
    finish = chunks[-1]["choices"][0]["finish_reason"] if chunks else None
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    token_ids = [t for c in chunks for t in c.get("token_ids", ())]
    return resp.status, {"chunks": len(chunks), "finish_reason": finish,
                         "done": done, "text": text, "token_ids": token_ids}, \
        first, time.perf_counter() - t0


def _wrappers() -> dict:
    from kubeai_tpu_torch.ops import COUNTED_KERNELS

    return dict(COUNTED_KERNELS)


SERVE_CONFIG = dict(num_slots=8, max_seq_len=2048, page_size=64, decode_chunk=8)


def _programs(engine) -> dict:
    """The engine's device programs, by name."""
    progs = {"decode chunk": engine._decode_program}
    for name, prog in (("verify window", engine._spec_program),
                       ("mid chunk", engine._stage_mid_program),
                       ("final chunk", engine._stage_last_program),
                       ("prefix gather", engine._stage_pages_program)):
        if prog is not None:
            progs[name] = prog
    return progs


# The engine's staged-chunk device functions: a serve run counts their
# calls outside the programs (an eager launch of a captured program).
STAGE_FUNCTIONS = ("_stage_mid", "_stage_last", "_stage_from_pages")


def _default_bodies() -> list[list[dict]]:
    """The first three serve runs' traffic: one wave of four chat
    completions (prompts of 28, 117, 317 and 717 tokens; one seeded, one
    streamed)."""
    text = "The quick brown fox jumps over the lazy dog. "
    max_tokens = 32
    return [[
        {"messages": [{"role": "user", "content": "Hello there"}],
         "max_tokens": max_tokens, "temperature": 0},
        {"messages": [{"role": "user", "content": (text * 7)[:300]}],
         "max_tokens": max_tokens, "temperature": 0.8, "seed": 1},
        {"messages": [{"role": "user", "content": (text * 16)[:700]}],
         "max_tokens": max_tokens, "temperature": 0},
        {"messages": [{"role": "user", "content": (text * 3)[:100]}],
         "max_tokens": max_tokens, "temperature": 0, "stream": True},
    ]]


def serve_run(params, cfg, label: str, waves=None, **extra) -> dict:
    """One EngineServer run over `params` with the engine's defaults (graphs
    and overlap): a warm-up request, then each wave of chat completions
    (default: `_default_bodies`) sent concurrently, a wave only after the
    one before it has finished, with every kernel's launch count and every
    device program's replay count set to 0 just before the first wave and
    read just after the last. `extra` adds to the smoke EngineConfig.
    Returns the launches (eager calls plus launches per replay x
    replays), each request's prompt, sampling params, engine token stream
    and TTFT, the rids of each wave, the calls of the staged-chunk
    functions made outside their programs, and the engine."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.fleet.profiler import phase_totals

    tok = ByteTokenizer()
    t0 = time.perf_counter()
    engine = Engine("llama", cfg, params, cfg=EngineConfig(**SERVE_CONFIG, **extra),
                    eos_token_ids=tok.eos_token_ids)
    if not engine._overlap:
        fail(f"serve {label}: the default engine does not overlap its steps")
    for name, prog in _programs(engine).items():
        if prog.graph is None:
            fail(f"serve {label}: the {name} is not a CUDA graph on the card")
        print(f"serve {label} {name} graph: captured at construction (engine built in "
              f"{time.perf_counter() - t0:.2f} s); pool reserved "
              f"{prog.pool_bytes / 2**20:.2f} MiB; launches per replay "
              f"{json.dumps(prog.launches_per_replay)}", flush=True)
    requests: dict[int, tuple] = {}  # rid -> (prompt, sampling params)
    add_request = engine.add_request

    def add_and_note(prompt, params, *a, **kw):
        rid = add_request(prompt, params, *a, **kw)
        requests[rid] = (list(prompt), params)
        return rid

    engine.add_request = add_and_note
    # Tokens the engine emitted per request, from its step events.
    streams: dict[int, list[int]] = {}
    engine_step = engine.step

    def step_and_count():
        events = engine_step()
        for ev in events:
            streams.setdefault(ev.rid, []).append(ev.token)
        return events

    engine.step = step_and_count
    # The engine's latency records, as the server's metrics sync drains
    # them after each step.
    timing: list[tuple] = []
    engine_drain = engine.drain_timing

    def drain_and_keep():
        records = engine_drain()
        timing.extend(records)
        return records

    engine.drain_timing = drain_and_keep
    stage_calls: dict[str, int] = {}
    for attr in STAGE_FUNCTIONS:
        def counted(fn=getattr(engine, attr), attr=attr):
            stage_calls[attr] = stage_calls.get(attr, 0) + 1
            return fn()
        setattr(engine, attr, counted)
    wrappers = _wrappers()
    server = EngineServer(engine, tok, "llama-3-8b-shape", port=0)
    server.start()
    try:
        status, _, _, _ = _post(server.port, {
            "messages": [{"role": "user", "content": "warm up"}],
            "max_tokens": 4, "temperature": 0})
        if status != 200:
            fail(f"serve {label} warm-up request: HTTP {status}")
        engine.drain_timing()
        timing.clear()
        streams.clear()
        requests.clear()
        stage_calls.clear()
        waves = waves or _default_bodies()
        bodies = [body for wave in waves for body in wave]
        max_tokens = bodies[0]["max_tokens"]
        results: list = [None] * len(bodies)

        def run(i):
            results[i] = _post(server.port, bodies[i])

        _zero_launches(engine)
        first_step = engine.profiler.steps_completed
        wave_rids: list[list[int]] = []
        t_start = time.perf_counter()
        first = 0
        for wave in waves:
            before = set(requests)
            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(first, first + len(wave))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            first += len(wave)
            wave_rids.append(sorted(set(requests) - before))
        wall = time.perf_counter() - t_start
        eager = {name: fn.launches for name, fn in wrappers.items()}
        replayed = {name: 0 for name in wrappers}
        for prog in _programs(engine).values():
            for name, n in prog.launches().items():
                replayed[name] += n
        dispatches = {name: prog.dispatches for name, prog in _programs(engine).items()}
    finally:
        server.stop()
    for i, (status, res, first_s, total_s) in enumerate(results):
        if status != 200:
            fail(f"serve {label} request {i}: HTTP {status} {res}")
        if bodies[i].get("stream"):
            # Tokens without text send no chunk: the count is the engine's.
            if not res["done"] or res["finish_reason"] != "length":
                fail(f"serve {label} stream {i}: {res}")
            got = f"sse_chunks={res['chunks']}"
        else:
            n = res["usage"]["completion_tokens"]
            if n != max_tokens or res["choices"][0]["finish_reason"] != "length":
                fail(f"serve {label} request {i}: {n} tokens, {res['choices'][0]}")
            got = f"completion_tokens={n}"
        print(f"serve {label} request {i}: stream={bool(bodies[i].get('stream'))} "
              f"{got} client_first_byte_s={first_s:.4f} "
              f"client_total_s={total_s:.4f}", flush=True)
    # Every request of the run, the streamed one included, got its tokens.
    counts = {rid: len(toks) for rid, toks in streams.items()}
    if sorted(counts.values()) != [max_tokens] * len(bodies):
        fail(f"serve {label}: engine emitted {counts} tokens per request, "
             f"not {max_tokens} each")
    print(f"serve {label} engine-side tokens per request: {json.dumps(counts)}", flush=True)
    engine.drain_timing()  # what the last sync left
    # The warm-up's records may land after the clear: keep this run's.
    ttft = {int(t[2][4:]): t[1] for t in timing
            if t[0] == "ttft" and int(t[2][4:]) in requests}
    for rid in sorted(ttft):
        print(f"serve {label} TTFT rid={rid} prompt_tokens={len(requests[rid][0])} "
              f"ttft_s={ttft[rid]:.4f}", flush=True)
    e2e = [t[1] for t in timing if t[0] == "e2e"]
    decode_tokens = len(bodies) * (max_tokens - 1)
    decode_s = max(e2e) - min(ttft.values())
    print(f"serve {label} decode tok/s={decode_tokens / decode_s:.2f} "
          f"({decode_tokens} tokens after the first, {decode_s:.4f} s from the "
          f"first first-token to the last completion; wall {wall:.4f} s)", flush=True)
    records = [r for r in engine.profiler.recent() if r["step"] > first_step]
    totals = phase_totals(records)
    print(f"serve {label} step phases over {len(records)} steps, total s: "
          f"{json.dumps({k: round(v, 6) for k, v in sorted(totals.items())})}", flush=True)
    launches = {name: eager[name] + replayed[name] for name in wrappers}
    print(f"serve {label} launches on the main path: {json.dumps(launches)} "
          f"(eager calls {json.dumps(eager)}; from graph replays {json.dumps(replayed)}, "
          f"dispatches {json.dumps(dispatches)})", flush=True)
    for name in ("paged_decode_attention", "paged_verify_attention",
                 "paged_decode_attention_fused"):
        if eager[name]:
            fail(f"serve {label}: {name} launched {eager[name]} times outside the "
                 "graph replays")
    # Each request's prompt length is distinct: it names the request.
    index_of = {len(tok.apply_chat_template(b["messages"])): i for i, b in enumerate(bodies)}
    rid_of = {index_of[len(prompt)]: rid for rid, (prompt, _) in requests.items()}
    return {"launches": launches, "requests": requests, "streams": streams,
            "engine": engine, "bodies": bodies, "rid_of": rid_of, "ttft": ttft,
            "waves": wave_rids, "stage_calls": dict(stage_calls),
            "dispatches": dispatches}


def check_streams_equal_eager(params, cfg, label: str, run: dict, **extra):
    """The serve run's streams, greedy and seeded, against an eager
    synchronous engine (no graphs, step_overlap="off") on the same weights
    fed the same prompts, sampling params and continuation prefixes (a
    request's optional third item), wave by wave as the run sent them.
    Any difference fails, with the first differing step. Returns the
    reference engine."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig

    class EagerEngine(Engine):
        _capture_graphs = False

    ref = EagerEngine("llama", cfg, params, cfg=EngineConfig(
        **SERVE_CONFIG, step_overlap="off", **extra),
        eos_token_ids=run["engine"].eos_token_ids)
    if ref._overlap or ref._decode_program.graph is not None:
        fail(f"serve {label}: the reference engine is not eager and synchronous")
    rids: dict[int, int] = {}
    got: dict[int, list[int]] = {rid: [] for wave in run["waves"] for rid in wave}
    t0 = time.perf_counter()
    for wave in run["waves"]:
        for rid in wave:
            prompt, sp, *resume = run["requests"][rid]
            rids[ref.add_request(prompt, sp, resume_tokens=resume[0] if resume else None)] = rid
        while ref.has_work():
            for ev in ref.step():
                got[rids[ev.rid]].append(ev.token)
    for rid, want in sorted(got.items()):
        have = run["streams"][rid]
        _, sp, *resume = run["requests"][rid]
        kind = "greedy" if sp.temperature == 0 else f"seeded (seed {sp.seed})"
        if resume and resume[0]:
            kind += f", resumed after {len(resume[0])}"
        if have != want:
            step = next((j for j, (x, y) in enumerate(zip(have, want)) if x != y),
                        min(len(have), len(want)))
            fail(f"serve {label} rid={rid} ({kind}): graph + overlap stream differs "
                 f"from the eager synchronous engine's at token {step}: "
                 f"{have[step:step + 4]} vs {want[step:step + 4]}")
        print(f"serve {label} rid={rid} ({kind}): {len(have)} tokens equal to the eager "
              f"synchronous engine's", flush=True)
    print(f"serve {label} eager synchronous reference took "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return ref


def serve_weights():
    """(random Llama-3-8B-shape weights on cuda, all 32 layers; the
    config), after one prefill's shapes and finite logits are checked."""
    import torch

    from kubeai_tpu_torch.models import llama

    cfg = llama.LlamaConfig()  # Llama-3-8B shapes, all 32 layers
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"serve: random Llama-3-8B-shape weights on cuda in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # Outputs are finite and of the expected shape.
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
        logits, k_all, _ = llama.prefill(params, cfg, toks, torch.tensor([64], device="cuda"))
    want_k = (cfg.num_layers, 1, 64, cfg.num_kv_heads, cfg.head_size)
    if tuple(logits.shape) != (1, cfg.vocab_size) or tuple(k_all.shape) != want_k:
        fail(f"8B prefill shapes {tuple(logits.shape)} {tuple(k_all.shape)}")
    if not torch.isfinite(logits).all():
        fail("8B prefill logits are not finite")
    del logits, k_all
    return params, cfg


def free(run: dict) -> None:
    """Clear a serve run's dict: its engine's pools and graphs go once
    nothing else holds the engine; the weights stay for the next run."""
    import gc

    import torch

    run.clear()
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve() -> dict:
    params, cfg = serve_weights()
    layout_gaps(params, cfg)
    launches = {}
    # Run 1: the per_layer layout, passed explicitly so that the env var
    # cannot flip it. B1 and B2 must launch.
    extra = dict(decode_kernel="per_layer")
    run = serve_run(params, cfg, "per_layer", **extra)
    for name in ("paged_decode_attention", "flash_causal_prefill"):
        if run["launches"][name] <= 0:
            fail(f"serve per_layer: main path never launched {name}")
        launches[name] = run["launches"][name]
    check_streams_equal_eager(params, cfg, "per_layer", run, **extra)
    base = {i: run["streams"][rid] for i, rid in run["rid_of"].items()}
    profile_program(run["engine"], "decode step", "decode chunk")
    profile_prefill(params, cfg)
    free(run)
    serve_resume(params, cfg)
    # Run 2: prompt-lookup speculation in every decode call. B3 launches,
    # B1 does not.
    extra = dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False)
    run = serve_run(params, cfg, "speculate", **extra)
    if run["launches"]["paged_verify_attention"] <= 0:
        fail("serve speculate: main path never launched paged_verify_attention")
    if run["launches"]["paged_decode_attention"] != 0:
        fail("serve speculate: paged_decode_attention launched in a speculative run")
    launches["paged_verify_attention"] = run["launches"]["paged_verify_attention"]
    stats = run["engine"].spec_stats
    print(f"serve speculate spec_stats {json.dumps(stats)} acceptance "
          f"{stats['accepted'] / max(1, stats['proposed']):.4f}", flush=True)
    check_streams_equal_eager(params, cfg, "speculate", run, **extra)
    report_agreement("speculate", base, run)
    profile_program(run["engine"], "verify window", "verify window")
    free(run)
    # Run 3: the fused layout. B4 launches, B1 does not.
    extra = dict(decode_kernel="fused")
    run = serve_run(params, cfg, "fused", **extra)
    if run["launches"]["paged_decode_attention_fused"] <= 0:
        fail("serve fused: main path never launched paged_decode_attention_fused")
    if run["launches"]["paged_decode_attention"] != 0:
        fail("serve fused: paged_decode_attention launched in a fused run")
    launches["paged_decode_attention_fused"] = run["launches"]["paged_decode_attention_fused"]
    check_streams_equal_eager(params, cfg, "fused", run, **extra)
    report_agreement("fused", base, run)
    profile_program(run["engine"], "fused decode step", "decode chunk")
    free(run)
    # Run 4: chunked prefill and the prefix cache. B1 and B2 launch.
    serve_prefix(params, cfg)
    return launches


# ---- serve_resume: the continuation request on the 8B-shape model ----------------


class IdTokenizer:
    """ByteTokenizer's encoding (the prompts are bytes) with a decoding in
    which every token id has text of its own ("[id]"). Random weights over
    a 128k vocabulary almost never emit one of the 256 byte tokens, so
    ByteTokenizer would stream empty text and the SSE chunks would carry
    no token ids; with this decoding every token reaches the client as
    text and as an id, and `emitted` counts real characters."""

    def __init__(self):
        from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

        self._bytes = ByteTokenizer()
        self.eos_token_ids = self._bytes.eos_token_ids

    def encode(self, text: str) -> list[int]:
        return self._bytes.encode(text)

    def apply_chat_template(self, messages: list[dict]) -> list[int]:
        return self._bytes.apply_chat_template(messages)

    def decode(self, ids) -> str:
        return "".join(f"[{int(i)}]" for i in ids if int(i) not in self.eos_token_ids)


# The continuation's cuts (tokens the dead replica emitted) and sampling
# modes: greedy, and tests/unit/test_preemption.py's seeded mode.
RESUME_CUTS = (1, 5, 17)
RESUME_SAMPLING = {
    "greedy": dict(temperature=0),
    "seeded": dict(temperature=0.8, top_k=8, seed=11),
}


def _resume_bodies() -> list[tuple[str, dict]]:
    """The four default bodies, each greedy and seeded, all streamed."""
    out = []
    for body in _default_bodies()[0]:
        base = {k: v for k, v in body.items() if k not in ("temperature", "seed", "stream")}
        for mode, sp in RESUME_SAMPLING.items():
            out.append((mode, {**base, **sp, "stream": True}))
    return out


def _resume_server(params, cfg, label: str, **extra):
    """An EngineServer over `params` with the engine's defaults (graphs
    and overlap) and IdTokenizer, its engine wrapped to keep each
    request's token stream and the times of its enqueue and first
    token, and the arguments of each request. Returns (server, engine,
    streams, t_add, t_first, requests)."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer

    tok = IdTokenizer()
    engine = Engine("llama", cfg, params, cfg=EngineConfig(**SERVE_CONFIG, **extra),
                    eos_token_ids=tok.eos_token_ids)
    if not engine._overlap or engine._decode_program.graph is None:
        fail(f"serve_resume {label}: the engine does not overlap or replay graphs")
    streams: dict[int, list[int]] = {}
    t_add: dict[int, float] = {}
    t_first: dict[int, float] = {}
    requests: dict[int, tuple] = {}
    add_request, step = engine.add_request, engine.step

    def add_and_note(prompt, sp, *a, **kw):
        t = time.perf_counter()
        rid = add_request(prompt, sp, *a, **kw)
        t_add[rid] = t
        requests[rid] = (list(prompt), sp, list(kw.get("resume_tokens") or ()))
        return rid

    def step_and_keep():
        events = step()
        now = time.perf_counter()
        for ev in events:
            streams.setdefault(ev.rid, []).append(ev.token)
            t_first.setdefault(ev.rid, now)
        return events

    engine.add_request, engine.step = add_and_note, step_and_keep
    server = EngineServer(engine, tok, "llama-3-8b-shape", port=0)
    server.start()
    return server, engine, streams, t_add, t_first, requests


def _post_all(port: int, bodies: list[dict]) -> list:
    """POST the bodies concurrently; fail on any status but 200."""
    results: list = [None] * len(bodies)

    def run(i):
        results[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (status, res, _, _) in enumerate(results):
        if status != 200 or not res["done"]:
            fail(f"serve_resume request {i}: HTTP {status} {res}")
    return results


def _post_waves(port: int, bodies: list[tuple[str, dict]], streams: dict,
                waves: list) -> list:
    """POST (mode, body) pairs one sampling mode at a time, each mode's
    bodies together. Their prompts lie in distinct prefill buckets, so
    every admission is a batch of one, as in the eager reference that
    replays the waves: admission batches of another make-up round
    differently in bf16. Appends each wave's rids to `waves`; returns the
    results in the order of `bodies`."""
    results: list = [None] * len(bodies)
    for mode in RESUME_SAMPLING:
        idx = [i for i, (m, _) in enumerate(bodies) if m == mode]
        if not idx:
            continue
        known = set(streams)
        for i, res in zip(idx, _post_all(port, [bodies[i][1] for i in idx])):
            results[i] = res
        waves.append(sorted(set(streams) - known))
    return results


def _launches(engine) -> dict:
    """Kernel launches since the counts were set to 0: eager calls plus
    launches per replay x replays."""
    launches = {name: fn.launches for name, fn in _wrappers().items()}
    for prog in _programs(engine).values():
        for name, n in prog.launches().items():
            launches[name] += n
    return launches


def _zero_launches(engine) -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    for prog in _programs(engine).values():
        prog.dispatches = 0


def _leading_equal(a: list, b: list) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def resume_run(params, cfg, label: str, bodies: list[tuple[str, dict]], cuts,
               must_launch: tuple, **extra) -> dict:
    """One layout's continuation check: serve each body once (the
    uninterrupted stream), then POST it again with `kubeai_resume` cut
    after k tokens for each k in `cuts`, in waves of one sampling mode
    (`_post_waves`). `emitted` is the characters of the first k tokens'
    text, less two for half the bodies (characters the dead stream never
    delivered). Fails unless every continuation's SSE token ids are its
    engine tokens and its SSE text is the text of prefix + those tokens
    past `emitted`, a continuation after one token (which recomputes the
    prompt's own prefill) continues the uninterrupted stream exactly,
    every stream equals an eager synchronous engine's fed the same
    requests wave by wave (`check_streams_equal_eager`), and each kernel
    of `must_launch` launched while the continuations ran. Reports how
    many tokens past longer cuts each continuation shares with the
    uninterrupted stream. Returns the engine-side TTFT (enqueue to first
    token) of both kinds and those agreement counts."""
    server, engine, streams, t_add, t_first, requests = _resume_server(
        params, cfg, label, **extra)
    tok = IdTokenizer()
    waves: list[list[int]] = []
    agreement: list[tuple] = []
    try:
        known = set(streams)
        plain = _post_waves(server.port, bodies, streams, waves)
        base_rids = sorted(set(streams) - known)
        ttft_plain = {rid: t_first[rid] - t_add[rid] for rid in base_rids}
        # The threads added the requests in an order of their own: match
        # each body to its rid through the tokens its stream carried.
        rid_of = {}
        for i, (_, res, _, _) in enumerate(plain):
            match = [rid for rid in base_rids if streams[rid] == res["token_ids"]]
            if len(match) != 1:
                fail(f"serve_resume {label} body {i}: SSE token ids match "
                     f"{len(match)} engine streams")
            rid_of[i] = match[0]
        _zero_launches(engine)
        ttft_resumed = []
        checked = 0
        for k in cuts:
            posts, meta = [], []
            for i, (mode, body) in enumerate(bodies):
                full = streams[rid_of[i]]
                if len(full) <= k or full[k - 1] in tok.eos_token_ids:
                    print(f"serve_resume {label} body {i} ({mode}): {len(full)} tokens, "
                          f"no continuation after {k}", flush=True)
                    continue
                emitted = len(tok.decode(full[:k])) - (2 if i % 2 else 0)
                posts.append((mode, {**body, "kubeai_resume": {"token_ids": full[:k],
                                                               "emitted": emitted}}))
                meta.append((i, mode, full, emitted))
            known = set(streams)
            results = _post_waves(server.port, posts, streams, waves)
            new = sorted(set(streams) - known)
            for (i, mode, full, emitted), (_, res, _, _) in zip(meta, results):
                tag = f"serve_resume {label} body {i} ({mode}) k={k}"
                match = [rid for rid in new
                         if requests[rid][2] == full[:k] and streams[rid] == res["token_ids"]]
                if len(match) != 1:
                    fail(f"{tag}: the streamed token ids {res['token_ids'][:6]} are not the "
                         "engine tokens of the continuation")
                got = streams[match[0]]
                want_text = tok.decode(full[:k] + got)[emitted:]
                if res["text"] != want_text:
                    fail(f"{tag}: resumed text {res['text'][:60]!r} is not the text of "
                         f"prefix + continuation past {emitted} characters {want_text[:60]!r}")
                same = _leading_equal(got, full[k:])
                agreement.append((i, mode, k, same, len(full) - k))
                if same < len(full) - k:
                    print(f"{tag}: continuation leaves the uninterrupted stream after "
                          f"{same} of {len(full) - k} tokens: {got[same:same + 3]} vs "
                          f"{full[k + same:k + same + 3]}", flush=True)
                    if k == 1:  # the prompt's own prefill, recomputed alike
                        fail(f"{tag}: a continuation after one token must continue the "
                             "uninterrupted stream")
                ttft_resumed.append(t_first[match[0]] - t_add[match[0]])
                checked += 1
        launches = _launches(engine)
        equal = sum(a[3] == a[4] for a in agreement)
        print(f"serve_resume {label}: {checked} continuations (cuts {list(cuts)}): SSE ids = "
              f"engine tokens, SSE text = text past emitted; {equal} equal to the "
              f"uninterrupted stream past the cut, {sum(a[3] for a in agreement)} of "
              f"{sum(a[4] for a in agreement)} tokens before the first difference; "
              f"launches while they ran {json.dumps(launches)}", flush=True)
        for name in must_launch:
            if launches[name] <= 0:
                fail(f"serve_resume {label}: {name} did not launch for the continuations")
        if label == "per_layer":
            resume_alone(server.port, label, bodies, streams, requests, waves)
            status, res, _, _ = _post(server.port, {**bodies[0][1], "stream": False,
                                                    "kubeai_resume": "nope"})
            if status != 400:
                fail(f"serve_resume: kubeai_resume \"nope\" got HTTP {status}, not 400")
            print(f"serve_resume per_layer: kubeai_resume \"nope\" -> 400 "
                  f"{res['error']['message']!r}", flush=True)
            profile_endpoint(server.port)
    finally:
        server.stop()
    check_streams_equal_eager(params, cfg, f"resume {label}", {
        "engine": engine, "requests": requests, "waves": waves, "streams": streams}, **extra)
    out = {"plain": sorted(ttft_plain.values()), "resumed": sorted(ttft_resumed)}
    for kind, times in out.items():
        print(f"serve_resume {label} TTFT {kind} (engine side, enqueue to first token, "
              f"{len(times)} requests): median {times[len(times) // 2]:.4f} s, min "
              f"{times[0]:.4f} s, max {times[-1]:.4f} s", flush=True)
    del engine
    out["agreement"] = agreement
    return out


def resume_alone(port: int, label: str, bodies, streams, requests, waves) -> None:
    """Each body alone: its uninterrupted stream, then its continuations
    cut after 1 and 5 tokens, one request at a time, so every admission
    is a batch of one and decodes beside idle slots. A cut after 1 token
    recomputes exactly the prompt's prefill: its continuation must equal
    the uninterrupted stream. A cut after 5 recomputes 4 generated tokens
    through the prefill (B2, P rounded to bf16) where the uninterrupted
    stream wrote their K/V while decoding (B1, P in f32): reported."""
    tok = IdTokenizer()
    report = {1: [], 5: []}
    for i, (mode, body) in enumerate(bodies):
        known = set(streams)
        _post_all(port, [body])
        (rid,) = sorted(set(streams) - known)
        full = streams[rid]
        waves.append([rid])
        for k in report:
            if len(full) <= k:
                continue
            known = set(streams)
            _post_all(port, [{**body, "kubeai_resume": {
                "token_ids": full[:k], "emitted": len(tok.decode(full[:k]))}}])
            (cont,) = sorted(set(streams) - known)
            waves.append([cont])
            same = _leading_equal(streams[cont], full[k:])
            report[k].append((same, len(full) - k))
            if k == 1 and same < len(full) - k:
                fail(f"serve_resume {label} body {i} ({mode}) alone, k=1: the continuation "
                     f"leaves the uninterrupted stream after {same} of {len(full) - k} "
                     f"tokens: {streams[cont][same:same + 3]} vs {full[k + same:k + same + 3]}")
    for k, rows in report.items():
        print(f"serve_resume {label} alone, k={k}: {sum(a == b for a, b in rows)} of "
              f"{len(rows)} continuations equal to the uninterrupted stream; leading tokens "
              f"equal {[a for a, _ in rows]} of {[b for _, b in rows]}", flush=True)


def profile_endpoint(port: int) -> None:
    """POST /v1/profile {"steps": 16, "fresh": true, "jax_trace": true}
    while generates of 256 tokens run back to back (the profiler takes a
    while to start: one generate could end before the window opens).
    Fails unless 16 or more steps were captured and the torch.profiler
    trace it names holds B1's combine kernel."""
    import os
    import shutil

    gen = {"messages": [{"role": "user", "content": "profile me"}], "max_tokens": 256,
           "temperature": 0, "stream": True}
    done = threading.Event()
    statuses: list[int] = []

    def generate():
        while not done.is_set():
            statuses.append(_post(port, gen)[0])

    t = threading.Thread(target=generate)
    t.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    try:
        status, res, _, _ = _post(port, {"steps": 16, "fresh": True, "timeout_s": 60,
                                         "jax_trace": True}, path="/v1/profile")
    finally:
        window_s = time.perf_counter() - t0
        done.set()
        t.join()
    if status != 200 or set(statuses) != {200}:
        fail(f"/v1/profile: HTTP {status} {res}, generates HTTP {statuses}")
    trace_dir = res["jax_trace_dir"]
    if res["steps_captured"] < 16 or not trace_dir:
        fail(f"/v1/profile: steps_captured {res['steps_captured']}, trace dir {trace_dir}")
    try:
        path = os.path.join(trace_dir, "trace.json")
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    b1 = [e for e in events if "paged_decode_combine_kernel" in str(e.get("name", ""))]
    if not b1:
        fail(f"/v1/profile: the trace ({len(events)} events) names no "
             "paged_decode_combine_kernel (B1)")
    totals = {k: round(v, 6) for k, v in sorted(res["phase_totals_s"].items())}
    print(f"/v1/profile: steps_captured {res['steps_captured']}, window {window_s:.4f} s "
          f"with the trace on; phase totals s {json.dumps(totals)}; trace {size / 2**20:.1f} "
          f"MiB, {len(events)} events, {len(b1)} of B1's combine kernel", flush=True)


def serve_resume(params, cfg) -> None:
    """The continuation request (`kubeai_resume`) at full width: the four
    default bodies, greedy and seeded, cut after 1, 5 and 17 tokens, in
    the per_layer layout (B1 and B2 must launch), with `{"kubeai_resume":
    "nope"}` refused and /v1/profile's torch.profiler trace naming B1;
    then one greedy and one seeded body cut after 5 tokens with
    speculation (B3 must launch) and in the fused layout (B4 must
    launch). Prints the continuations' TTFT beside the uninterrupted
    requests' and the card."""
    bodies = _resume_bodies()
    resume_run(params, cfg, "per_layer", bodies, RESUME_CUTS,
               ("paged_decode_attention", "flash_causal_prefill"),
               decode_kernel="per_layer")
    free({})
    two = bodies[2:4]  # the 317-token prompt, greedy and seeded
    resume_run(params, cfg, "speculate", two, (5,), ("paged_verify_attention",),
               decode_kernel="per_layer", speculate=4, spec_adaptive=False)
    free({})
    resume_run(params, cfg, "fused", two, (5,), ("paged_decode_attention_fused",),
               decode_kernel="fused")
    free({})
    print(f"serve_resume card: {gpu_line()}", flush=True)


# The JAX server's prefill_chunk at max_seq_len 2048:
# max(32, min(512, max_seq_len // 4)).
PREFIX_CHUNK = 512


def _prefix_waves() -> list[list[dict]]:
    """The prefix run's traffic: two waves of four chat completions over
    one system prompt that fills the first 1,024 tokens (16 pages), each
    with its own user turn of 28-317 characters (one token each) that
    starts with its own number, one seeded a wave; and in wave 1 a
    117-token prompt of its own, which the batched path admits (B2).
    Every prompt length differs: it names the request."""
    system = ("You are a careful assistant for a support desk. Answer in plain "
              "words and keep every step short. " * 12)[:1016]  # + "system: "
    filler = "Please explain how the kernels are scheduled across the card. " * 6
    waves = []
    for w, lengths in enumerate(((28, 95, 203, 317), (41, 150, 260, 301))):
        wave = []
        for j, n in enumerate(lengths):
            body = {"messages": [{"role": "system", "content": system},
                                 {"role": "user", "content": (f"Question {w}{j}: " + filler)[:n]}],
                    "max_tokens": 32, "temperature": 0}
            if j == 1:
                body.update(temperature=0.8, seed=w + 1)
            wave.append(body)
        waves.append(wave)
    waves[0].append({"messages": [{"role": "user", "content": filler[:100]}],
                     "max_tokens": 32, "temperature": 0})
    return waves


def expected_hits(prompts: list[list[int]], page: int, chunk: int, max_len: int) -> list[int]:
    """Cached tokens each prompt's admission must find, in admission
    order, by the engine's rule: the longest run of full pages it shares
    from the start with a prompt admitted before it (every admission
    registers its full pages), capped at (length - 1) // page pages and at
    (max_len - chunk) // page."""
    out = []
    for i, p in enumerate(prompts):
        cap = min((len(p) - 1) // page, max(0, (max_len - chunk) // page))
        best = 0
        for q in prompts[:i]:
            n = 0
            while n < cap and q[: (n + 1) * page] == p[: (n + 1) * page] and (n + 1) * page <= len(q):
                n += 1
            best = max(best, n)
        out.append(best * page)
    return out


def serve_prefix(params=None, cfg=None) -> dict:
    """Run 4: `prefill_chunk=512, prefix_cache=True` over two waves of
    traffic that share a 1,024-token system prompt (`_prefix_waves`), in
    the per_layer layout. Gates: B1 and B2 launch; the staged-chunk programs
    (mid chunk, final chunk, prefix gather) dispatch, only as CUDA-graph
    replays; prefix_stats["hit_tokens"] reaches the count of the cache
    rule (`expected_hits`, with wave 2 at least 4 x 1,024); the streams
    and hit tokens equal an eager synchronous engine's with the same
    settings. Reports: TTFT of hits and misses, greedy agreement with a
    whole-prompt engine's streams on the same prompts, and
    `profile_admissions`. Builds the weights when not given. Returns the
    run's launches."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig

    if params is None:
        params, cfg = serve_weights()
    label = "prefix"
    extra = dict(decode_kernel="per_layer", prefill_chunk=PREFIX_CHUNK, prefix_cache=True)
    run = serve_run(params, cfg, label, waves=_prefix_waves(), **extra)
    engine = run["engine"]
    for name in ("paged_decode_attention", "flash_causal_prefill"):
        if run["launches"][name] <= 0:
            fail(f"serve {label}: main path never launched {name}")
    if run["stage_calls"]:
        fail(f"serve {label}: staged-chunk functions ran outside their graphs: "
             f"{run['stage_calls']}")
    for name in ("mid chunk", "final chunk", "prefix gather"):
        if run["dispatches"].get(name, 0) <= 0:
            fail(f"serve {label}: the {name} program was never dispatched")
    order = sorted(run["requests"])
    per = expected_hits([run["requests"][rid][0] for rid in order],
                        SERVE_CONFIG["page_size"], PREFIX_CHUNK, SERVE_CONFIG["max_seq_len"])
    hit_of = dict(zip(order, per))
    wave2 = sum(hit_of[rid] for rid in run["waves"][1])
    if wave2 < 4 * 1024:
        fail(f"serve {label}: the traffic gives wave 2 only {wave2} cacheable tokens")
    stats = dict(engine.prefix_stats)
    print(f"serve {label} prefix_stats {json.dumps(stats)}; the cache rule gives "
          f"{sum(per)} hit tokens ({wave2} in wave 2)", flush=True)
    if stats["hit_tokens"] < sum(per):
        fail(f"serve {label}: {stats['hit_tokens']} hit tokens, the rule gives {sum(per)}")
    for kind, rids in (("hit", [r for r in order if hit_of[r]]),
                       ("miss", [r for r in order if not hit_of[r]])):
        ttfts = [run["ttft"][r] for r in rids]
        print(f"serve {label} TTFT {kind}: {len(rids)} requests, prompt tokens "
              f"{[len(run['requests'][r][0]) for r in rids]}, cached "
              f"{[hit_of[r] for r in rids]}, ttft_s {[round(t, 4) for t in ttfts]}, "
              f"mean {sum(ttfts) / max(1, len(ttfts)):.4f} s", flush=True)
    ref = check_streams_equal_eager(params, cfg, label, run, **extra)
    if ref.prefix_stats["hit_tokens"] != stats["hit_tokens"]:
        fail(f"serve {label}: eager engine hit {ref.prefix_stats['hit_tokens']} tokens, "
             f"the served engine {stats['hit_tokens']}")
    # Whole-prompt admission (no chunks, no cache) on the same prompts.
    whole = Engine("llama", cfg, params, cfg=EngineConfig(
        **SERVE_CONFIG, decode_kernel="per_layer"), eos_token_ids=engine.eos_token_ids)
    rids = {whole.add_request(*run["requests"][rid]): rid for rid in order}
    got: dict[int, list[int]] = {rid: [] for rid in order}
    while whole.has_work():
        for ev in whole.step():
            got[rids[ev.rid]].append(ev.token)
    report_agreement(label, {i: got[rid] for i, rid in run["rid_of"].items()}, run,
                     "a whole-prompt engine's (per_layer, no chunks, no cache)")
    del whole
    profile_admissions(engine, ref, cfg)
    launches = run["launches"]
    del engine, ref
    free(run)
    return launches


def profile_admissions(engine, ref, cfg) -> None:
    """One prefill admission through the staged-chunk path, on the served
    engine (CUDA graphs) and on its eager reference, through `profile`:
    a 1,300-token miss (chunks at 0, 512 and 788) and a hit over a
    registered 1,024-token prefix with a 276-token suffix (the gather,
    then one padded chunk). Each call admits a fresh prompt that finishes
    on its first token. Wall and device time and the idle share per
    admission, side by side."""
    import numpy as np

    from kubeai_tpu_torch.engine import SamplingParams

    rng = np.random.default_rng(17)
    prefix = rng.integers(0, cfg.vocab_size, 1024).tolist()
    sp = SamplingParams(temperature=0.0, max_tokens=1)

    def fresh(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    cases = {
        "miss": lambda eng: eng.generate([fresh(1300)], sp),
        "hit": lambda eng: eng.generate([prefix + fresh(276)], sp),
    }
    out = {}
    for kind, eng in (("graph", engine), ("eager", ref)):
        eng.generate([prefix + fresh(276)], sp)  # registers the prefix
        for case, call in cases.items():
            before = eng.prefix_stats["hit_tokens"]
            out[case, kind] = profile(eng, f"{case} admission {kind}", call, e_steps=1)
            hits = eng.prefix_stats["hit_tokens"] - before
            # profile() runs its calls three times (warm-up, timed, profiled).
            if hits != (3 * 2 * 1024 if case == "hit" else 0):
                fail(f"profile {case} admission {kind}: {hits} hit tokens")
    for case in cases:
        graph, eager = out[case, "graph"], out[case, "eager"]
        device, source = graph["device_ms"], "torch.profiler"
        if device < 0.5 * eager["device_ms"]:
            device = graph["event_ms"]
            source = ("CUDA events (torch.profiler attributed "
                      f"{graph['device_ms']:.3f} ms to the replays)")
        tag = f"{case}_admission"
        print(f"profile {tag} graph vs eager: wall {graph['wall_ms']:.3f} vs "
              f"{eager['wall_ms']:.3f} ms/{tag}; device {device:.3f} [{source}] vs "
              f"{eager['device_ms']:.3f} ms/{tag}; idle share "
              f"{max(0.0, 1 - device / graph['wall_ms']):.3f} vs "
              f"{max(0.0, 1 - eager['device_ms'] / eager['wall_ms']):.3f}", flush=True)


def layout_gaps(params, cfg) -> None:
    """One decode step at the 8B shapes in each layout from the same
    state (4 slots after a 128-token prefill): how far the fused step's
    and the verify window's row-0 logits lie from the per_layer step's,
    beside the gap between each row's two best logits. Random weights give
    near-flat logits, so a difference above the gap flips a greedy pick:
    this says why the serve runs' greedy streams part. A report, not a
    gate."""
    import torch

    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops.paged_attention import (
        batched_scatter_sequence,
        batched_sequence_page_coords,
    )

    B, S, page, mp = 4, 128, 64, 4
    gen = torch.Generator("cuda").manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    lengths = torch.full((B,), S, device="cuda")
    with torch.no_grad():
        logits, k_all, v_all = llama.prefill(params, cfg, tokens, lengths)
        shape = (cfg.num_layers, 1 + B * mp, page, cfg.num_kv_heads, cfg.head_size)
        kp = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
        vp = torch.zeros(shape, dtype=cfg.dtype, device="cuda")
        bt = torch.arange(1, 1 + B * mp, dtype=torch.int32, device="cuda").reshape(B, mp)
        ids, offs = batched_sequence_page_coords(bt, lengths, S, page)
        batched_scatter_sequence(kp, vp, k_all, v_all, ids, offs)
        del k_all, v_all
        step = logits.argmax(-1)
        out = {}
        for layout in ("per_layer", "fused"):
            out[layout] = llama.decode_step_paged(
                params, cfg, step, lengths, kp.clone(), vp.clone(), bt,
                attn_kernel=layout)[0]
        window = torch.cat([step[:, None], tokens[:, :4]], 1)
        out["verify"] = llama.decode_verify_paged(
            params, cfg, window, lengths, kp, vp, bt)[0][:, 0]
    base = out["per_layer"]
    top2 = base.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu()
    for name in ("fused", "verify"):
        diff = float((out[name] - base).abs().max())
        same = int((out[name].argmax(-1) == base.argmax(-1)).sum())
        print(f"serve layouts: {name} vs per_layer logits at one 8B step max |diff| "
              f"{diff:.3e}; greedy picks equal {same}/{B}; top-2 logit gaps of the "
              f"per_layer rows {[float(f'{g:.3e}') for g in gap.tolist()]}", flush=True)


def report_agreement(label: str, base: dict, run: dict,
                     against: str = "the per_layer run's") -> None:
    """How many leading greedy tokens equal `base`'s (by default the
    per_layer run's), per request (the i-th request of each run): a
    report, not a gate (the kernels sum in other orders and can flip a
    near-tie)."""
    got = {i: run["streams"][rid] for i, rid in run["rid_of"].items()}
    for i in sorted(base):
        if run["bodies"][i]["temperature"] != 0:
            continue
        a, b = base[i], got.get(i, [])
        same = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        print(f"serve {label} greedy request {i}: {same}/{len(a)} leading tokens "
              f"equal to {against}", flush=True)


def profile(engine, unit: str, call, e_steps: int, calls: int = 2) -> dict:
    """torch.profiler over `calls` calls of `call(engine)` (two decode
    calls at the serving shapes: all num_slots rows; the requests have
    finished, so the rows write scratch page 0): device time per `unit`
    (a call covers e_steps of them) by kernel, and the device's idle share
    against the wall time of the same calls run without the profiler
    (whose own host overhead would swamp it). Returns the device rows, the
    number of units they cover, and per unit: the unprofiled wall ms, the
    profiler's device ms and the ms between CUDA events recorded around
    the unprofiled calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    def run():
        for _ in range(calls):
            call(engine)
        torch.cuda.synchronize()

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        run()  # warm-up
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    torch.cuda.synchronize()
    steps = calls * e_steps
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_total_us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
    tag = unit.replace(" ", "_")
    out = {"rows": rows, "steps": steps, "wall_ms": wall_ms / steps,
           "device_ms": dev_total_us / 1e3 / steps,
           "event_ms": start.elapsed_time(end) / steps}
    print(f"profile {tag}: {steps} x {unit}, unprofiled wall {out['wall_ms']:.3f} "
          f"ms/{tag}, device {out['device_ms']:.3f} ms/{tag}, idle share "
          f"{max(0.0, 1 - out['device_ms'] / out['wall_ms']):.3f}; CUDA events "
          f"{out['event_ms']:.3f} ms/{tag}", flush=True)
    rows.sort(key=lambda e: getattr(e, "self_device_time_total", 0), reverse=True)
    for e in rows[:12]:
        t = getattr(e, "self_device_time_total", 0)
        print(f"profile {tag} kernel {t / 1e3 / steps:.4f} ms/{tag} "
              f"count/{tag} {e.count / steps:.1f} {e.key[:90]}", flush=True)
    return out


def profile_program(engine, unit: str, program: str, calls: int = 2) -> None:
    """One device program of `engine` ("decode chunk" or "verify window")
    replayed from its CUDA graph `calls` times back to back, each dispatch
    read back before the next as a synchronous step does, and the same
    calls run eagerly (the program's function, through the same buffers),
    in one call: wall time, device time and idle share per `unit`, side by
    side, and the graph pool's memory. Where torch.profiler does not see
    the kernels inside a replay, the device time is the CUDA-event span."""
    prog = _programs(engine)[program]
    e_steps = engine._chunk_out.shape[0] if program == "decode chunk" else 1

    def replay(_):
        prog.read(prog.dispatch())

    def eager(_):
        prog.fn()

    graph = profile(engine, f"{unit} graph", replay, e_steps, calls)
    eager_run = profile(engine, f"{unit} eager", eager, e_steps, calls)
    if eager_run["device_ms"] <= 0:
        fail(f"profile {unit}: torch.profiler recorded no device kernels")
    device, source = graph["device_ms"], "torch.profiler"
    if device < 0.5 * eager_run["device_ms"]:
        device = graph["event_ms"]
        source = ("CUDA events (torch.profiler attributed "
                  f"{graph['device_ms']:.3f} ms to the replay)")
    tag = unit.replace(" ", "_")
    print(f"profile {tag} graph vs eager: wall {graph['wall_ms']:.3f} vs "
          f"{eager_run['wall_ms']:.3f} ms/{tag}; device {device:.3f} [{source}] vs "
          f"{eager_run['device_ms']:.3f} ms/{tag}; idle share "
          f"{max(0.0, 1 - device / graph['wall_ms']):.3f} vs "
          f"{max(0.0, 1 - eager_run['device_ms'] / eager_run['wall_ms']):.3f}; graph pool "
          f"{prog.pool_bytes / 2**20:.2f} MiB", flush=True)


def profile_prefill(params, cfg) -> None:
    """torch.profiler over llama.prefill, the function
    Engine._prefill_admit calls, at B=1 for the serve phase's two long
    buckets (512 and 1024) on the 8B-shape weights: device time by kernel,
    the idle share, and B2's device ms and launches per admission. This is
    the layer number that ties B2 to TTFT."""
    import torch

    from kubeai_tpu_torch.models import llama

    gen = torch.Generator("cuda").manual_seed(12)
    for S in (512, 1024):
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device="cuda")
        lengths = torch.tensor([S], device="cuda")
        prof = profile(None, f"prefill S={S}",
                       lambda _: llama.prefill(params, cfg, toks, lengths),
                       e_steps=1, calls=1)
        rows, steps = prof["rows"], prof["steps"]
        total = sum(getattr(e, "self_device_time_total", 0) for e in rows)
        b2 = [e for e in rows if "flash_prefill_kernel" in e.key]
        if not b2:
            fail(f"prefill S={S}: the profile shows no flash_prefill_kernel")
        b2_us = sum(getattr(e, "self_device_time_total", 0) for e in b2)
        print(f"profile prefill_S={S} B2 {b2_us / 1e3 / steps:.4f} ms in "
              f"{sum(e.count for e in b2) / steps:.0f} launches per admission, "
              f"{b2_us / max(total, 1):.3f} of its device time", flush=True)


# ---- phase 5: the engine Pod's entry point -------------------------------------

# A Llama-3-8B-width checkpoint (bench.py:59-74) cut to CLI_LAYERS layers:
# the embedding and the head take 1.05 GB each, a layer 0.436 GB. The full
# depth is served by the serve runs above.
CLI_LAYERS = 4
CLI_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": CLI_LAYERS, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 500000.0,
    "rms_norm_eps": 1e-5, "max_position_embeddings": 4096,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
# The head's rows of the printable ASCII bytes (32-126) are drawn this many
# times larger, so that greedy picks are bytes that ByteTokenizer decodes
# one to one: a unary response's text then pins its token stream.
ASCII_HEAD_SCALE = 8.0
CLI_READY_S = 300  # from the process start to /health 200
CLI_DRAIN_S = 30  # --drain-timeout
# (model leaf, HF tensor name, stored transposed in the port's layout)
CLI_LEAVES = (("embed", "model.embed_tokens.weight", False),
              ("final_norm", "model.norm.weight", False),
              ("lm_head", "lm_head.weight", False))
CLI_LAYER_LEAVES = (("input_norm", "input_layernorm.weight", False),
                    ("wq", "self_attn.q_proj.weight", True),
                    ("wk", "self_attn.k_proj.weight", True),
                    ("wv", "self_attn.v_proj.weight", True),
                    ("wo", "self_attn.o_proj.weight", True),
                    ("post_attn_norm", "post_attention_layernorm.weight", False),
                    ("w_gate", "mlp.gate_proj.weight", True),
                    ("w_up", "mlp.up_proj.weight", True),
                    ("w_down", "mlp.down_proj.weight", True))


def cli_tensors() -> dict:
    """Random bf16 tensors under their Hugging Face names, drawn on the card
    from a seed as `llama.init_params` draws them (N(0, 0.02), norms 1) and
    kept on the host for the writer."""
    import torch

    c = CLI_CONFIG
    E, M, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    HD, KD = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    gen = torch.Generator("cuda").manual_seed(1)

    def rnd(*shape, scale_ascii=False):
        w = torch.randn(shape, generator=gen, device="cuda") * 0.02
        if scale_ascii:
            w[32:127] *= ASCII_HEAD_SCALE
        return w.to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    shapes = {"input_layernorm.weight": None, "self_attn.q_proj.weight": (HD, E),
              "self_attn.k_proj.weight": (KD, E), "self_attn.v_proj.weight": (KD, E),
              "self_attn.o_proj.weight": (E, HD), "post_attention_layernorm.weight": None,
              "mlp.gate_proj.weight": (M, E), "mlp.up_proj.weight": (M, E),
              "mlp.down_proj.weight": (E, M)}
    out = {"model.embed_tokens.weight": rnd(V, E)}
    for i in range(c["num_hidden_layers"]):
        for name, shape in shapes.items():
            out[f"model.layers.{i}.{name}"] = ones(E) if shape is None else rnd(*shape)
    out["model.norm.weight"] = ones(E)
    out["lm_head.weight"] = rnd(V, E, scale_ascii=True)
    return out


def check_loaded_bits(params: dict, tensors: dict) -> int:
    """Fails unless every leaf `load_params` put on the card is bit-equal
    to the tensor written (transposed where the port's layout is
    [in, out]). Returns the leaves checked."""
    import torch

    pairs = [(params[leaf], name, t) for leaf, name, t in CLI_LEAVES]
    for i in range(CLI_LAYERS):
        pairs += [(params["layers"][leaf][i], f"model.layers.{i}.{name}", t)
                  for leaf, name, t in CLI_LAYER_LEAVES]
    for got, name, transposed in pairs:
        want = tensors[name].to(got.device)
        want = want.T if transposed else want
        if got.dtype != torch.bfloat16 or got.shape != want.shape or not torch.equal(
                got.view(torch.int16), want.view(torch.int16)):
            fail(f"serve_cli: loaded {name} ({got.dtype}, {tuple(got.shape)}) is not "
                 "bit-equal to the tensor written")
    return len(pairs)


def _parse_metrics(text: str) -> dict:
    """Prometheus text -> {(sample name, sorted label pairs): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = re.match(r'^([a-zA-Z_:][\w:]*)(?:\{(.*)\})? (\S+)$', line)
        if m is None:
            fail(f"serve_cli: malformed exposition line {line!r}")
        labels = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


def _get(port: int, path: str) -> tuple[int, str]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read().decode()
    conn.close()
    return resp.status, body


# The CLI runs of serve_cli: (label, extra flags, extra environment, the
# in-process engine's EngineConfig settings for the same run). The default
# runs B1 and B2; speculation runs B3 in every decode call; the fused
# layout, chosen by the environment as an engine Pod would, runs B4.
CLI_RUNS = (
    ("default", [], {}, dict(decode_kernel="per_layer")),
    ("speculate", ["--speculate", "4", "--spec-adaptive", "off"], {},
     dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False)),
    ("fused", [], {"KUBEAI_TPU_DECODE_KERNEL": "fused"}, dict(decode_kernel="fused")),
)


class OtlpSink:
    """A stdlib OTLP/HTTP collector on 127.0.0.1: keeps the spans of every
    JSON POST to /v1/traces."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sink = self
        self.spans: list[dict] = []
        self._lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.path == "/v1/traces":
                    payload = json.loads(body)
                    with sink._lock:
                        sink.spans += [sp for rs in payload["resourceSpans"]
                                       for ss in rs["scopeSpans"] for sp in ss["spans"]]
                self.send_response(200)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def wait_span(self, trace_id: str, timeout_s: float) -> dict | None:
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline:
            with self._lock:
                for sp in self.spans:
                    if sp["traceId"] == trace_id:
                        return sp
            time.sleep(0.1)
        return None

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def check_trace(port: int, sink: OtlpSink, label: str) -> None:
    """One request with a client's traceparent and an X-Request-Id: fails
    unless the engine's server span reaches the sink with the client's
    trace id, the client's span as its parent and the request id."""
    import os

    trace_id, parent = os.urandom(16).hex(), os.urandom(8).hex()
    req_id = f"chip-smoke-{label}"
    status = _post(port, {"messages": [{"role": "user", "content": "trace me"}],
                          "max_tokens": 4, "temperature": 0},
                   headers={"traceparent": f"00-{trace_id}-{parent}-01",
                            "X-Request-Id": req_id})[0]
    if status != 200:
        fail(f"serve_cli {label}: the traced request got HTTP {status}")
    t0 = time.perf_counter()
    span = sink.wait_span(trace_id, 15.0)
    if span is None:
        fail(f"serve_cli {label}: no span of trace {trace_id} reached the OTLP sink")
    attrs = {a["key"]: a["value"] for a in span.get("attributes", ())}
    if span.get("parentSpanId") != parent or attrs.get("request.id") != {"stringValue": req_id}:
        fail(f"serve_cli {label}: span {span} lacks the client's parent or request id")
    print(f"serve_cli {label} trace: span {span['name']!r} of the client's trace reached the "
          f"OTLP sink {time.perf_counter() - t0:.2f} s after the response; parent "
          f"{span['parentSpanId']}, request.id {req_id}, http.status_code "
          f"{attrs.get('http.status_code')}", flush=True)


def cli_run(model_dir: str, label: str, flags: list, env_extra: dict,
            ckpt_bytes: int, sink: OtlpSink) -> dict:
    """One `python -m kubeai_tpu_torch.engine.server` run over `model_dir`
    in a subprocess of its own session: ready within CLI_READY_S, the
    four requests of `_default_bodies` sent together (all 200), /metrics
    and /v1/state read, then /v1/drain (a new request gets 503, no slot
    stays active) and SIGTERM (exit 0 within the drain budget). Returns
    the responses' texts, the streamed token ids, the completion tokens
    the responses report, the state read before the drain and the
    /metrics values the phase gates. The server exports its spans to
    `sink` (OTEL_EXPORTER_OTLP_TRACES_ENDPOINT); `check_trace` runs
    before the drain."""
    import os
    import signal
    import socket
    import tempfile

    from kubeai_tpu_torch.metrics.registry import hist_buckets

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "kubeai_tpu_torch.engine.server",
           "--model-url", model_dir, "--port", str(port), "--num-slots", "8",
           "--max-seq-len", "2048", "--drain-timeout", str(CLI_DRAIN_S),
           "--watchdog-timeout", "60", *flags]
    env_text = " ".join(f"{k}={v}" for k, v in env_extra.items())
    print(f"serve_cli {label} command: {env_text} {' '.join(cmd[1:])}".replace("  ", " "),
          flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "KUBEAI_TPU_DECODE_KERNEL"}
    env.update(env_extra, PYTHONPATH=here, OTEL_EXPORTER_OTLP_TRACES_ENDPOINT=sink.endpoint)
    log_fd, log_path = tempfile.mkstemp(prefix="kubeai-serve-cli-", suffix=".log")
    proc = None

    def tail() -> str:
        with open(log_path) as f:
            return "".join(f.readlines()[-30:])

    try:
        t_start = time.perf_counter()
        # Its own session, so that a failure can kill timeout and the server.
        proc = subprocess.Popen(["timeout", "-k", "10", str(CLI_READY_S + 300), *cmd],
                                cwd=here, env=env, stdout=log_fd, stderr=subprocess.STDOUT,
                                start_new_session=True)
        while True:
            if proc.poll() is not None:
                fail(f"serve_cli {label}: the server exited {proc.returncode} before it "
                     f"was ready:\n{tail()}")
            try:
                if _get(port, "/health")[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t_start > CLI_READY_S:
                fail(f"serve_cli {label}: not ready within {CLI_READY_S} s:\n{tail()}")
            time.sleep(0.25)
        ready_s = time.perf_counter() - t_start
        bodies = _default_bodies()[0]
        results: list = [None] * len(bodies)

        def run(i):
            results[i] = _post(port, bodies[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        texts, completion, streamed_ids, streamed_first = [], 0, None, None
        for i, (status, res, first_s, total_s) in enumerate(results):
            if status != 200:
                fail(f"serve_cli {label} request {i}: HTTP {status} {res}")
            if bodies[i].get("stream"):
                if not res["done"]:
                    fail(f"serve_cli {label} stream {i}: no [DONE]: {res}")
                n, text = len(res["token_ids"]), res["text"]
                streamed_ids, streamed_first = res["token_ids"], first_s
            else:
                n, text = res["usage"]["completion_tokens"], res["choices"][0]["message"]["content"]
            texts.append(text)
            completion += n
            print(f"serve_cli {label} request {i}: stream={bool(bodies[i].get('stream'))} "
                  f"completion_tokens={n} client_first_byte_s={first_s:.4f} "
                  f"client_total_s={total_s:.4f} text={text[:40]!r}", flush=True)
        metrics = _parse_metrics(_get(port, "/metrics")[1])
        state = json.loads(_get(port, "/v1/state")[1])
        _, ttft_count, ttft_sum = hist_buckets(metrics, "kubeai_engine_ttft_seconds")
        cold = state["cold_start"]
        load_s = cold["phases"]["load"]
        print(f"serve_cli {label} cold start (/v1/state): phases_s "
              f"{json.dumps({k: round(v, 4) for k, v in cold['phases'].items()})} total_s "
              f"{cold['total_s']:.4f}; ready {ready_s:.2f} s after the process started; load "
              f"{ckpt_bytes / 1e9:.3f} GB in {load_s:.4f} s = "
              f"{ckpt_bytes / 1e9 / load_s:.3f} GB/s", flush=True)
        print(f"serve_cli {label} TTFT (/metrics): count {ttft_count:.0f}, mean "
              f"{ttft_sum / max(1, ttft_count):.4f} s; bucket upper bound -> rid "
              f"{json.dumps(state['exemplars']['ttft'])}; the streamed request's first "
              f"chunk at {streamed_first:.4f} s (client); spec_stats "
              f"{json.dumps(state['spec_stats'])}", flush=True)
        # After /metrics and /v1/state were read: the gates count the
        # four requests above.
        check_trace(port, sink, label)
        # Drain: /v1/drain refuses new work, then SIGTERM exits 0.
        if _post_status(port, "/v1/drain") != 202:
            fail(f"serve_cli {label}: POST /v1/drain did not answer 202")
        status = _post(port, bodies[0])[0]
        if status != 503:
            fail(f"serve_cli {label}: a request during the drain got HTTP {status}, not 503")
        deadline = time.perf_counter() + CLI_DRAIN_S
        while True:
            drained = json.loads(_get(port, "/v1/state")[1])
            if (drained["draining"] and drained["slots_active"] == 0
                    and drained["requests_pending"] == 0):
                break
            if time.perf_counter() > deadline:
                fail(f"serve_cli {label}: after the drain slots_active="
                     f"{drained['slots_active']} requests_pending="
                     f"{drained['requests_pending']}")
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=CLI_DRAIN_S + 5)
        except subprocess.TimeoutExpired:
            fail(f"serve_cli {label}: no exit within the drain budget after SIGTERM:\n{tail()}")
        if rc != 0:
            fail(f"serve_cli {label}: the server exited {rc} after SIGTERM:\n{tail()}")
        with open(log_path) as f:
            for line in f:
                if "tokenizer:" in line or "drain complete" in line:
                    print(f"serve_cli {label} log: {line.strip()}", flush=True)
        print(f"serve_cli {label}: exit 0 after SIGTERM", flush=True)
    finally:
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        os.close(log_fd)
        os.unlink(log_path)
    metric_values = {
        "requests": sum(v for (n, _), v in metrics.items()
                        if n == "kubeai_engine_requests_total"),
        "generated": metrics[("kubeai_engine_generated_tokens_total", ())],
        "ttft_count": ttft_count,
    }
    return {"texts": texts, "streamed_ids": streamed_ids, "completion": completion,
            "state": state, "metrics": metric_values, "bodies": bodies}


def serve_cli() -> None:
    """Phase 5: the engine Pod's entry point. Writes a random-weight Llama
    checkpoint at Llama-3-8B width (CLI_LAYERS layers, bf16) with
    `weights.save_safetensors` into a temporary directory and serves it
    with `python -m kubeai_tpu_torch.engine.server` three times
    (`cli_run`, CLI_RUNS: default, `--speculate 4`, and the fused layout
    from the environment), then loads the same checkpoint in-process with
    `weights.load_params` on the card and builds an engine of each run's
    configuration on it. Gates, besides `cli_run`'s: the loaded tensors
    bit-equal to those written; each run's greedy streams over HTTP equal
    to its in-process engine's; on /metrics 4 requests, a TTFT count of 4
    and the generated tokens the responses report; speculation windows in
    the speculative run; the same token capacity as in-process. Reports
    the load rate, the cold-start phases, TTFT and the card."""
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.engine.weights import load_hf_config, load_params, save_safetensors
    from kubeai_tpu_torch.models import llama

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="kubeai-serve-cli-")
    try:
        t0 = time.perf_counter()
        tensors = cli_tensors()
        model_dir = os.path.join(root, "model")
        save_safetensors(model_dir, tensors, CLI_CONFIG)
        ckpt_bytes = os.path.getsize(os.path.join(model_dir, "model.safetensors"))
        print(f"serve_cli checkpoint: {CLI_LAYERS} layers at Llama-3-8B width, bf16, "
              f"{ckpt_bytes / 1e9:.3f} GB in {len(tensors)} tensors, drawn and written in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        sink = OtlpSink()
        try:
            runs = {label: cli_run(model_dir, label, flags, env, ckpt_bytes, sink)
                    for label, flags, env, _ in CLI_RUNS}
        finally:
            sink.stop()

        # The same checkpoint in-process, on the card.
        tok = ByteTokenizer()
        cfg = llama.LlamaConfig.from_hf_dict(load_hf_config(model_dir))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = load_params("llama", model_dir, cfg, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n = check_loaded_bits(params, tensors)
        del tensors
        print(f"serve_cli load_params in-process: {n} leaves bit-equal to the tensors "
              f"written; {ckpt_bytes / 1e9:.3f} GB in {load_s:.4f} s = "
              f"{ckpt_bytes / 1e9 / load_s:.3f} GB/s", flush=True)
        for label, _, _, extra in CLI_RUNS:
            run = runs[label]
            bodies = run["bodies"]
            engine = Engine("llama", cfg, params, cfg=EngineConfig(
                num_slots=8, max_seq_len=2048, **extra), eos_token_ids=tok.eos_token_ids)
            capacity = engine.kv_cache_info()["token_capacity"]
            if capacity != run["state"]["kv_cache"]["token_capacity"]:
                fail(f"serve_cli {label}: token capacity "
                     f"{run['state']['kv_cache']['token_capacity']} on the CLI, {capacity} "
                     "in-process")
            rids = [engine.add_request(tok.apply_chat_template(b["messages"]), SamplingParams(
                temperature=b["temperature"], max_tokens=b["max_tokens"], seed=b.get("seed")))
                for b in bodies]
            streams = {rid: [] for rid in rids}
            while engine.has_work():
                for ev in engine.step():
                    streams[ev.rid].append(ev.token)
            ttft = {int(t[2][4:]): t[1] for t in engine.drain_timing() if t[0] == "ttft"}
            for i, rid in enumerate(rids):
                want = streams[rid]
                same = tok.decode(want) == run["texts"][i]
                if bodies[i].get("stream"):
                    same = same and run["streamed_ids"] == want
                printable = sum(32 <= t < 127 for t in want) / max(1, len(want))
                kind = "greedy" if bodies[i]["temperature"] == 0 else "seeded"
                print(f"serve_cli {label} request {i} ({kind}): HTTP stream "
                      f"{'equals' if same else 'DIFFERS FROM'} the in-process engine's "
                      f"({len(want)} tokens, {printable:.2f} printable bytes); in-process "
                      f"ttft_s={ttft[rid]:.4f}", flush=True)
                if kind == "greedy" and not same:
                    fail(f"serve_cli {label} request {i}: the greedy stream served over "
                         f"HTTP differs from the in-process engine's: "
                         f"{run['texts'][i]!r} vs {tok.decode(want)!r}")
            del engine
            m = run["metrics"]
            print(f"serve_cli {label} /metrics: kubeai_engine_requests_total "
                  f"{m['requests']:.0f}, kubeai_engine_generated_tokens_total "
                  f"{m['generated']:.0f} (responses: {run['completion']}), TTFT count "
                  f"{m['ttft_count']:.0f}", flush=True)
            if m["requests"] != len(bodies):
                fail(f"serve_cli {label}: kubeai_engine_requests_total {m['requests']}, "
                     f"sent {len(bodies)}")
            if m["generated"] != run["completion"]:
                fail(f"serve_cli {label}: kubeai_engine_generated_tokens_total "
                     f"{m['generated']}, the responses report {run['completion']}")
            if m["ttft_count"] != len(bodies):
                fail(f"serve_cli {label}: TTFT histogram count {m['ttft_count']}, sent "
                     f"{len(bodies)}")
        if runs["speculate"]["state"]["spec_stats"]["windows"] <= 0:
            fail("serve_cli speculate: the CLI ran no speculation window")
        print(f"serve_cli card: {gpu_line()}", flush=True)
        del params
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def _post_status(port: int, path: str) -> int:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path, b"{}", {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


# ---- entry --------------------------------------------------------------------


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stdout.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on the card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    phase_build()
    measured = phase_kernels()
    phase_model()
    launches = phase_serve()
    serve_cli()
    kernels = []
    for name, m in measured.items():
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
