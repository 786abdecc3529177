"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check it.

    python3 chip_smoke.py            # every phase, one card

Phases, each fatal on failure:
  1. build   — compile the CUDA kernels of kubeai_tpu_torch/csrc with nvcc
               for sm_90a and print the build seconds;
  2. kernels — each kernel against its plain PyTorch version on the card,
               in bf16 at the serving path's Llama-3-8B shapes, with times,
               the plain version's and one PyTorch library call's times,
               and the least time the card could take (bound);
  3. model   — a small model (head_dim 128) on the card through the kernels
               against the same weights in f32 on the CPU through the plain
               versions: prefill and paged-decode logits, greedy picks, and
               lm_head logits kept in f32;
  4. serve   — EngineServer over Engine with random Llama-3-8B-shape weights
               on cuda answers concurrent /v1/chat/completions requests
               (one streamed); every request gets its tokens and both
               kernels' launch counters must move. Then torch.profiler
               over two decode chunks: device time by kernel, idle share.

The last lines are the kernel JSON line, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}. Without a CUDA device, or
without the kubeai_tpu_torch package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
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
            if "registers" in line or "spill" in line or line.startswith("=="):
                print(f"  {line.strip()}")


# ---- phase 2: kernels against their plain versions ---------------------------


def _paged_inputs(gen, B=8, H=32, KVH=8, D=128, page=64, max_len=2048):
    import torch

    mp = max_len // page
    n_pages = 1 + B * mp
    lengths = torch.randint(1, max_len + 1, (B,), generator=gen, device="cpu")
    lengths[0] = max_len  # one full-length slot, one single-token slot
    lengths[1] = 1
    perm = torch.randperm(n_pages - 1, generator=gen, device="cpu") + 1
    bt = torch.full((B, mp), -1, dtype=torch.int32)
    used = 0
    for b in range(B):
        need = -(-int(lengths[b]) // page)
        bt[b, :need] = perm[used:used + need].to(torch.int32)
        used += need
    dev = "cuda"
    q = torch.randn(B, H, D, generator=gen, device="cpu").to(dev, torch.bfloat16)
    kp = torch.randn(n_pages, page, KVH, D, generator=gen, device="cpu").to(dev, torch.bfloat16)
    vp = torch.randn(n_pages, page, KVH, D, generator=gen, device="cpu").to(dev, torch.bfloat16)
    return q, kp, vp, bt.to(dev), lengths.to(dev, torch.int32)


def check_paged_decode() -> dict:
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        ref_paged_decode_attention,
    )

    gen = torch.Generator().manual_seed(1)
    q, kp, vp, bt, lengths = _paged_inputs(gen)
    B, H, D = q.shape
    KVH, page = kp.shape[2], kp.shape[1]
    result = None
    for cap, win in ((None, None), (30.0, None), (None, 500), (50.0, 100)):
        got = paged_decode_attention(q, kp, vp, bt, lengths, logit_softcap=cap, window=win)
        torch.cuda.synchronize()
        want = ref_paged_decode_attention(q, kp, vp, bt, lengths, logit_softcap=cap, window=win)
        err = compare(f"paged_decode softcap={cap} window={win}", got, want,
                      PAGED_ATOL, PAGED_RTOL)
        if cap is None and win is None:
            # The limit has teeth: the plain version with one page of the
            # full-length slot 0 read from slot 2's first page must fail it.
            bad_bt = bt.clone()
            bad_bt[0, 5] = bt[2, 0]
            bad = ref_paged_decode_attention(q, kp, vp, bad_bt, lengths)
            ok, bad_err = within(got, bad, PAGED_ATOL, PAGED_RTOL)
            if ok:
                fail(f"paged_decode: one wrong page stays within the limit "
                     f"(max |err| {bad_err:.3e})")
            print(f"paged_decode: one wrong page in slot 0 gives max |err| "
                  f"{bad_err:.3e}, beyond atol {PAGED_ATOL} rtol {PAGED_RTOL}",
                  flush=True)
        ms = cuda_ms(lambda: paged_decode_attention(
            q, kp, vp, bt, lengths, logit_softcap=cap, window=win))
        plain_ms = cuda_ms(lambda: ref_paged_decode_attention(
            q, kp, vp, bt, lengths, logit_softcap=cap, window=win), iters=5)
        # Bytes this data needs: each key/value the mask keeps, read once,
        # plus q, the output, the block tables and the lengths.
        lens = lengths.long().cpu()
        if win is not None:
            lens = torch.clamp(lens, max=win)
        kv_bytes = int(lens.sum()) * KVH * D * 2 * 2
        io_bytes = 2 * q.numel() * 2 + bt.numel() * 4 + lengths.numel() * 4
        bound_ms = (kv_bytes + io_bytes) / PEAK_BYTES_PER_S * 1e3
        line = dict(softcap=cap, window=win, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms,
                    bytes=kv_bytes + io_bytes, bound_by="bytes")
        if cap is None and win is None:
            # Library yardstick: SDPA over the same keys gathered dense.
            L = bt.shape[1] * page
            kd = kp[bt.long().clamp(min=0)].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
            vd = vp[bt.long().clamp(min=0)].reshape(B, L, KVH, D).transpose(1, 2).contiguous()
            mask = (torch.arange(L, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]
            q4 = q[:, :, None, :]
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask, enable_gqa=True))
            line["library_ms"] = lib_ms
            result = dict(line)
        print("kernel paged_decode_attention B=%d H=%d KVH=%d D=%d page=%d "
              "max_len=%d %s" % (B, H, KVH, D, page, int(lengths.max()), json.dumps(line)),
              flush=True)
    return result


def check_flash_prefill() -> dict:
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.attention import causal_prefill_attention
    from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill

    H, KVH, D = 32, 8, 128
    gen = torch.Generator().manual_seed(2)
    main = None
    # S=32 and 128 are the buckets of the serve phase's two short prompts
    # (32 is less than one 64-row block); 512 and 1024 those of its long ones.
    for B in (1, 4):
        for S in (32, 128, 200, 512, 1024):
            mk = lambda h: torch.randn(B, S, h, D, generator=gen, device="cpu").to(
                "cuda", torch.bfloat16)
            q, k, v = mk(H), mk(KVH), mk(KVH)
            got = flash_causal_prefill(q, k, v)
            torch.cuda.synchronize()
            want = causal_prefill_attention(q, k, v)
            err = compare(f"flash_prefill B={B} S={S}", got, want, FLASH_ATOL, FLASH_RTOL)
            ms = cuda_ms(lambda: flash_causal_prefill(q, k, v))
            plain_ms = cuda_ms(lambda: causal_prefill_attention(q, k, v), iters=5)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            flops = 4.0 * B * H * D * S * (S + 1) / 2
            nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D)
            t_flops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            line = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=max(t_flops, t_bytes),
                        bound_by="operations" if t_flops >= t_bytes else "bytes")
            print("kernel flash_causal_prefill B=%d S=%d H=%d KVH=%d D=%d %s"
                  % (B, S, H, KVH, D, json.dumps(line)), flush=True)
            if (B, S) == (1, 512):
                main = line
    return main


def phase_kernels() -> dict:
    return {
        "paged_decode_attention": check_paged_decode(),
        "flash_causal_prefill": check_flash_prefill(),
    }


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
            dlogits, kp, vp = llama.decode_step_paged(
                params, c, step_tok, lengths.to(dev), kp, vp, bt)
        # Page 0 is scratch: padded tail positions all write there, and
        # which duplicate write lands is unspecified.
        out[dev] = (logits, k_all, dlogits, kp[:, 1:])
    for i, name in enumerate(("prefill logits", "prefill k_all", "decode logits",
                              "decode k_pages")):
        err = compare(f"model {name}", out["cuda"][i], out["cpu"][i], MODEL_ATOL, MODEL_RTOL)
        print(f"model {name}: cuda bf16 (kernels) vs cpu f32 (plain) max |err| {err:.3e}",
              flush=True)
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
    for name, i in (("prefill", 0), ("decode", 2)):
        g, c = out["cuda"][i].float().cpu(), out["cpu"][i].float()
        pick = g.argmax(-1)
        gap = c.max(-1).values - c.gather(-1, pick[:, None])[:, 0]
        if bool((gap > MODEL_ATOL).any()):
            fail(f"model greedy {name}: card picks {pick.tolist()}, cpu picks "
                 f"{c.argmax(-1).tolist()}, cpu-side gap {gap.tolist()}")
        print(f"model greedy {name}: {int((pick == c.argmax(-1)).sum())}/{len(pick)} "
              f"picks equal to the cpu's; largest cpu-side gap {float(gap.max()):.3e}",
              flush=True)


# ---- phase 4: serve on the 8B-shape model ---------------------------------------


def _post(port: int, body: dict) -> tuple[int, dict, float, float]:
    """POST a chat completion. Returns (status, result, seconds to the
    first response byte, total seconds); a stream's result gathers its
    chunks."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
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
    return resp.status, {"chunks": len(chunks), "finish_reason": finish,
                         "done": done}, first, time.perf_counter() - t0


def phase_serve() -> dict:
    import torch

    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill
    from kubeai_tpu_torch.ops.paged_attention import paged_decode_attention

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

    tok = ByteTokenizer()
    engine = Engine("llama", cfg, params, cfg=EngineConfig(
        num_slots=8, max_seq_len=2048, page_size=64, decode_chunk=8,
    ), eos_token_ids=tok.eos_token_ids)
    prompt_len: dict[int, int] = {}
    add_request = engine.add_request

    def add_and_note(prompt, *a, **kw):
        rid = add_request(prompt, *a, **kw)
        prompt_len[rid] = len(prompt)
        return rid

    engine.add_request = add_and_note
    # Tokens the engine emitted per request, counted from its step events.
    emitted: dict[int, int] = {}
    engine_step = engine.step

    def step_and_count():
        events = engine_step()
        for ev in events:
            emitted[ev.rid] = emitted.get(ev.rid, 0) + 1
        return events

    engine.step = step_and_count
    server = EngineServer(engine, tok, "llama-3-8b-shape", port=0)
    server.start()
    try:
        status, _, _, _ = _post(server.port, {
            "messages": [{"role": "user", "content": "warm up"}],
            "max_tokens": 4, "temperature": 0})
        if status != 200:
            fail(f"warm-up request: HTTP {status}")
        engine.drain_timing()
        emitted.clear()
        text = "The quick brown fox jumps over the lazy dog. "
        max_tokens = 32
        bodies = [
            {"messages": [{"role": "user", "content": "Hello there"}],
             "max_tokens": max_tokens, "temperature": 0},
            {"messages": [{"role": "user", "content": (text * 7)[:300]}],
             "max_tokens": max_tokens, "temperature": 0.8, "seed": 1},
            {"messages": [{"role": "user", "content": (text * 16)[:700]}],
             "max_tokens": max_tokens, "temperature": 0},
            {"messages": [{"role": "user", "content": (text * 3)[:100]}],
             "max_tokens": max_tokens, "temperature": 0, "stream": True},
        ]
        results: list = [None] * len(bodies)

        def run(i):
            results[i] = _post(server.port, bodies[i])

        paged_decode_attention.launches = 0
        flash_causal_prefill.launches = 0
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(bodies))]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
        launches = {
            "paged_decode_attention": paged_decode_attention.launches,
            "flash_causal_prefill": flash_causal_prefill.launches,
        }
    finally:
        server.stop()
    for i, (status, res, first_s, total_s) in enumerate(results):
        if status != 200:
            fail(f"request {i}: HTTP {status} {res}")
        if bodies[i].get("stream"):
            # Tokens without text send no chunk: the count is the engine's.
            if not res["done"] or res["finish_reason"] != "length":
                fail(f"stream {i}: {res}")
            got = f"sse_chunks={res['chunks']}"
        else:
            n = res["usage"]["completion_tokens"]
            if n != max_tokens or res["choices"][0]["finish_reason"] != "length":
                fail(f"request {i}: {n} tokens, {res['choices'][0]}")
            got = f"completion_tokens={n}"
        print(f"serve request {i}: stream={bool(bodies[i].get('stream'))} "
              f"{got} client_first_byte_s={first_s:.4f} "
              f"client_total_s={total_s:.4f}", flush=True)
    # Every request of the run, the streamed one included, got its tokens.
    if sorted(emitted.values()) != [max_tokens] * len(bodies):
        fail(f"engine emitted {emitted} tokens per request, not {max_tokens} each")
    print(f"serve engine-side tokens per request: {json.dumps(emitted)}", flush=True)
    timing = engine.drain_timing()
    ttft = {int(t[2][4:]): t[1] for t in timing if t[0] == "ttft"}
    for rid in sorted(ttft):
        print(f"serve TTFT rid={rid} prompt_tokens={prompt_len.get(rid)} "
              f"ttft_s={ttft[rid]:.4f}", flush=True)
    e2e = [t[1] for t in timing if t[0] == "e2e"]
    decode_tokens = len(bodies) * (max_tokens - 1)
    decode_s = max(e2e) - min(ttft.values())
    print(f"serve decode tok/s={decode_tokens / decode_s:.2f} "
          f"({decode_tokens} tokens after the first, {decode_s:.4f} s from the "
          f"first first-token to the last completion; wall {wall:.4f} s)", flush=True)
    print(f"serve launches on the main path: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path never launched {name}")
    profile_decode(engine)
    return launches


def profile_decode(engine) -> None:
    """torch.profiler over decode chunks at the serving shapes (all
    num_slots rows; the requests have finished, so the rows write scratch
    page 0): device time by kernel, and the device's idle share against
    the wall time of the same chunks run without the profiler (whose own
    host overhead would swamp it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    chunks = 2

    def run():
        for _ in range(chunks):
            engine._decode_chunk()
        torch.cuda.synchronize()

    with torch.no_grad():
        run()  # warm-up
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
    steps = chunks * engine.cfg.decode_chunk
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not rows:
        fail("torch.profiler recorded no device kernels")
    dev_total_us = sum(getattr(e, "self_device_time_total", 0) for e in rows)
    print(f"profile decode: {steps} steps, unprofiled wall {wall_ms / steps:.3f} "
          f"ms/step, device {dev_total_us / 1e3 / steps:.3f} ms/step, idle share "
          f"{max(0.0, 1 - dev_total_us / 1e3 / wall_ms):.3f}", flush=True)
    rows.sort(key=lambda e: getattr(e, "self_device_time_total", 0), reverse=True)
    for e in rows[:12]:
        t = getattr(e, "self_device_time_total", 0)
        print(f"profile decode kernel {t / 1e3 / steps:.4f} ms/step "
              f"count/step {e.count / steps:.1f} {e.key[:90]}", flush=True)


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
