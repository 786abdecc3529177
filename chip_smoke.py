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
               spills. B1's int8 read (B1-int8) runs B1's cases on the
               same pools quantized by kv_quant.quantize_kv, against the
               plain version on the same int8 pages and scales, at B1's
               limits, with its own walk's registers and spills. B1 and
               B1-int8 also: group sizes 1, 2, 7 and 8 at D 128 and 64,
               the split and combine kernels' times (torch.profiler) and a
               cold-L2 time (calls rotating over copies of the pools)
               beside the warm one. B1 and B4 at head_dim 256 (Gemma),
               entries of their own in the kernels line: at Gemma-2-9B's
               shape (B=8, H=16, KVH=8, lengths to 8192), plain and with
               window 4096 + softcap 50, timed beside SDPA; the same bits
               from two calls and a graph replay; B1's split edges and
               slots past the table, B4's split edges; G 1, 2 and 8 with
               plain, softcap 50, window 100, window 4096 and softcap +
               window. B2 at head_dim 256 (Gemma-1), an entry of its own:
               Gemma-7B's heads (H=16, KVH=16) at B=1 over S 32-8192 and
               B=4 at 1024, Gemma-2B's (H=8, KVH=1) at 512 and 8192,
               against the plain version, timed beside SDPA and the
               bound; the same bits from two calls and a graph replay; no
               spills. B1-int8 at head_dim 256 (gemma on int8 pools), an
               entry of its own: B1's Gemma-2-9B case on the same pools
               quantized, plain and with window 4096 + softcap 50, timed
               (graph, eager, cold L2) beside SDPA on the dequantized
               view; the same bits from two calls and a graph replay; its
               split edges and slots past the table; its splits' CTA
               target and token cap measured on the kernel case and the
               served contexts; G 1, 2 and 8 with the five cases. At
               Qwen2.5-0.5B's heads (H=14 over KVH=2, a group of 7, D=64;
               `check_qwen_heads`): B2 at B=1 over S 32-2048 and B=8 at
               128 and 2048, timed beside SDPA and the bound, the same
               bits from two calls and a graph replay (an entry of its
               own in the kernels line, B=8 S=2048); B1, B1-int8 and B4
               against their plain versions, plain and softcap + window.
               At Llama-3.2-1B's heads (H=32 over KVH=8, G=4, D=64;
               `check_draft_heads`, the draft model's prefill): B2 at B=1
               over S 512 and 2048 and B=8 at 128, timed beside SDPA and
               the bound, the same bits from two calls and a graph replay
               (an entry of its own in the kernels line, B=1 S=512).
               The W8A16 GEMM of int8 weights (`check_int8_gemm`; an
               entry each for its skinny kernel, M=8 at w_gate's shape,
               and its wgmma kernel, M=512): Llama-3-8B's four weight
               shapes at every M of GEMM_ROWS (1 to 4096), each kernel
               that takes M against the plain version (GEMM_ATOL /
               GEMM_RTOL) and timed from a graph of 20 calls beside the
               plain version, cuBLAS on the dequantized bf16 weight and
               the bound; where both kernels take M (M <= 8) the routed
               one within ROUTE_SLACK of the faster over a layer, each
               timed ROUTE_ROUNDS times in turns (median); a dead channel exactly 0 from
               each kernel; Qwen2.5-0.5B's shapes; the same bits from two
               calls and a graph replay (M 8, 40, 512, and split K);
               registers and spills;
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
               buckets, with B2's device ms and launches. Then
               `serve_int8_weights` quantizes the same weights on the
               card (int8 layer weights, GiB before and after) and serves
               the three layouts again with quantization="int8": the
               W8A16 kernel `route` sends the replay's rows to (the
               skinny one in the decode chunk, the wgmma one in the verify
               window) must launch 7 x 32 times a model step in every
               replay and the other never, the wgmma one in the
               admissions, every stream must equal an eager engine's on the
               int8 weights; each step is profiled beside its bf16 one
               with the weight GEMMs' shares, the greedy streams'
               agreement with bf16 is reported, and one 512-bucket
               prefill is profiled on bf16 and int8 weights. A fourth run
               (`serve_prefix`) turns on chunked prefill (prefill_chunk=512)
               and the prefix cache and sends two waves of chat requests
               over one 1,024-token system prompt: B1 and B2 must launch,
               the staged-chunk programs must dispatch only as graph
               replays, the cache must hit the tokens its rule gives, and
               the streams must equal an eager synchronous engine's; it
               reports TTFT of hits and misses, agreement with whole-prompt
               streams, and a miss and a hit admission from the graphs and
               eagerly. A fifth run (`serve_draft`) serves the same
               32-layer weights as Llama-3.1-8B (its rope scaling) with a
               random Llama-3.2-1B draft (16 layers, 32 heads over 8 at
               head_dim 64, tied embeddings), speculate=4,
               spec_adaptive=False: B3 must launch 32 times a verify
               window and B1 never, each admission must launch B2 32
               times for the target and 16 for the draft, and the streams
               must equal an eager engine's with the same draft; it prints
               acceptance, the propose chain and verify window from their
               graphs (the chain's kernels from an eager pass) and the
               draft cache's MiB; each draft row must hold, at layer 0,
               the K/V of the draft's own prefill of its tokens within
               2e-2. Then the 1B with itself as the draft on the four
               requests made greedy (acceptance at least 0.8, streams
               equal an eager engine's) and the same with
               spec_adaptive=True and spec_probe_every=2 (chunk-mode
               windows must run, and the verify windows after the first
               keep acceptance at least 0.8: the catch-up program keeps
               the draft in step). The
               phases after it serve the same width at
               SHALLOW_LAYERS (8) layers, with their bf16 decode step and
               verify window profiled at that depth first
               (`shallow_baselines`). `serve_slot` serves the four
               requests from the slot cache (cache_mode="slot"),
               whole-prompt and with prefill_chunk=256: B2 once a layer in
               every whole-prompt admission, the two long prompts chunked,
               no paged kernel, streams equal an eager slot engine's; the
               slot decode step from its graph beside the paged per_layer
               step at the same depth. `serve_resume` sends the
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
               beside the uninterrupted requests'. `serve_disagg`: a
               prefill-role and a decode-role EngineServer on the same
               weights; eight bodies (four prompts, greedy and seeded, one
               streamed) go to the decode server alone and then through
               the two hops (X-Disagg-Transfer, X-Disagg-Handoff): every
               two-hop stream must equal the decode server's own answer,
               the exported pages must be the prefill pool's bits and each
               import must write the handoff's bits, B2 must launch on the
               prefill side only and B1 on the decode side only from graph
               replays; a fused decode-role server takes two bodies (B4).
               Prints export (prefill, gather), serialize, push, receive
               and import ms and two-hop against direct TTFT.
               `serve_kv_share` (prefill_chunk=512, prefix_cache=True):
               replica B fetches the 1,024-token prefix that replica A
               holds over /v1/kv/export (X-KV-Source): B's hit tokens,
               its 16 imported pages, their bits and its stream must be
               A's; an eviction of A's idle pages spills into A's
               in-memory KVSpillStore and fills back bit-equal, and the
               same on B, whose store is a gs:// bucket on a fake GCS
               server on 127.0.0.1. Int8 KV pools last:
               `serve_int8` serves the four prompts greedy, then seeded,
               on int8 pools (B1-int8 must launch, only from replays, and
               B1 not at all; streams equal an eager int8 engine's) and
               prints the pools' GiB against bf16 and the decode step
               against the bf16 one; the prefix run again on int8 pools
               (hits by the rule, streams equal an eager engine's); and
               an int8 prefill/decode pair on the 717-token prompt, greedy
               and seeded (exported int8 pages and scales are the pool's
               bits, imports write the handoff's, streams equal the
               decode server's own). LoRA last: `serve_lora` writes three
               rank-16 PEFT adapters over wq/wk/wv/wo (bf16, numpy from
               a seed), loads them with `lora_weights.load_peft_adapter`
               and serves three waves in which base, a1 and a2 requests
               share every decode batch, with max_adapters=4 and the
               adapters loaded after capture: per_layer (B1, B2),
               speculate=4 (B3), fused (B4) and int8 pools (B1-int8).
               Every stream must equal an eager engine's with the same
               adapters and a greedy adapter stream must differ from its
               base stream; then, on the per_layer engine, an unload
               while an a2 request waits or decodes must raise the
               in-flight error, a2 is swapped for a third adapter in its
               row, and the streams that follow must equal an eager
               engine that loaded it from the start, with every graph
               and graph pool unchanged. It profiles the LoRA decode
               step, verify window and prefill against the bf16 ones and
               prints the adapter buffers' MiB;
  4b. serve_gemma — Gemma-2 on random Gemma-2-9B-shape weights, cut to
               GEMMA_9B_LAYERS (8) of its 42 layers (head_dim 256, window
               4096 on alternate layers,
               softcaps 50 and 30), num_slots=8, max_seq_len=8192: four
               chat requests of 28-4,200 prompt tokens (one seeded, one
               streamed; the longest passes the window) served per_layer
               (B1 at head_dim 256 must launch), fused (B4), per_layer on
               int8 pools (B1-int8 at head_dim 256 must launch once a layer
               a step, only from replays, B1 never; the pools' GiB against
               bf16's) and with prefill_chunk=512 and the prefix cache
               over two waves (hits by the cache rule), on bf16 and on
               int8 pools; B2 must not launch (Gemma-2's prefill is the
               plain attention). Every stream must equal an eager
               synchronous engine's (an int8 one on int8 pools); the
               decode step is profiled from its graph in each run
               (eagerly too per_layer);
  4c. serve_gemma1 — `serve_gemma(GEMMA_7B, ...)`: Gemma-1 on random
               Gemma-7B-shape weights, GEMMA_7B_LAYERS (8) of its 28
               layers (16 heads over 16 kv heads at head_dim 256, no
               softcap, no window), the same four requests and config:
               per_layer (B1 at G=1), fused (B4) and on int8 pools
               (B1-int8 at G=1, with the int8 gates), where B2 at head_dim
               256 must launch once a layer in every prefill admission, then
               the prefix run; every stream equal to an eager engine's,
               hits by the rule; the decode step from its graph and B2's
               device ms in one 8192-bucket admission;
  4d. serve_embed — /v1/embeddings on the catalog's embedder: random
               Qwen2.5-0.5B weights at full width and depth (24 layers,
               14 heads over 2 at head_dim 64, q/k/v biases, tied
               embeddings; bf16), written as a checkpoint and loaded back
               bit-equal. In-process EngineServer: greedy and seeded chat
               (one streamed) while batches of 8 embeddings (5 to 1,500
               tokens) land between its steps; B2 must launch 24 times a
               batch and an admission, every vector must be bit-equal to
               in-process hidden_states and the streams equal an eager
               engine's; each batch's time on the serve loop (the delay it
               adds to the next step). torch.profiler over one batch (24
               B2 launches, B2's share); the vectors against the plain f32
               path (max |err|, least cosine). Then `main` in a subprocess:
               batches of 8 and of 1 (5, 200, 1,500 tokens), each
               bit-equal to in-process hidden_states, ms per request and
               tokens/s, the prompt tokens on /metrics, exit 0 on SIGINT;
  4e. serve_whisper — whisper-small at full width and depth (12 + 12
               layers, d_model 768; f32, random), written in the HF
               layout and loaded back bit-equal; encode and
               decoder_logits on the card within 1e-3 of the port on the
               CPU; transcribe_tokens over a 5-second 16 kHz WAV made
               here (encode ms, ms a token, tokens, real-time factor);
               then `main` in a subprocess on the card: the served ids
               (twice) equal the in-process ones, /metrics counts the
               requests and the audio seconds, exit 0 on SIGINT;
  4f. serve_mixtral — Mixtral-8x7B's width (32 heads over 8 at head_dim
               128, 8 experts of 14336, top-2; random bf16 weights from a
               seed) at MIXTRAL_LAYERS (8) of its 32 layers, max_seq_len
               4096: first the router's top-k on the card with forced ties
               (the lower index first, as a stable host sort), then four
               chat requests of 28-1,100 prompt tokens (one seeded, one
               streamed) served per_layer (B1), fused (B4), on int8 pools
               (B1-int8) and with speculate=2 (vanilla decode, logged; no
               B3), then chunked prefill and the prefix cache over two
               waves (hits by the rule). Each run: its decode kernel 8
               times a step in every replay, B2 8 times in every
               whole-prompt admission, every stream equal to an eager
               synchronous engine's; each layout's decode step profiled
               (the walk 8 times a step by torch.profiler, and no kernel
               but a GEMM as slow a launch as moving one expert stack, so
               no weight is copied). Prints the step's device ms against
               its bytes bound, a 512-bucket admission's device ms (B2 8
               launches), the MoE blocks' share of each, the weights' GiB
               and the peak memory;
  4g. serve_sharded_cli — the entry point over ranks: checkpoints at the
               8B width (4 of 32 layers) and Mixtral-8x7B's (2 layers);
               `--tpu-topology 1x1` (world 1 over NCCL, graphs) bit-equal
               to no topology, both in the fused layout from
               KUBEAI_TPU_DECODE_KERNEL (B4 must launch); `--tpu-topology
               2x2` (four gloo ranks sharing the card, default flags: an
               adapter loaded through the lockstep broadcast and used)
               and Mixtral over `1x2`, each one request at a time (unary
               and streamed, greedy and seeded), with the lockstep
               refusals of /v1/embeddings and kubeai_resume, /v1/state's
               slice and SIGTERM ending every rank with exit 0. Gates:
               every rank's stream digest equal; each rank's heads (H=8,
               KVH=2 at 2x2), and its B2 and B1 launches (its wrappers'
               counts in its log); rank 0's streams equal to in-process
               engines over the same ranks (`sharded_ref_rank`, at 2x2
               also in the fused layout and at speculate=4: ranks'
               streams identical, B4 and B3 launching at the rank's
               heads), whose torch.profiler shows B2 and B1 at those
               heads. Then world 1 over NCCL in-process (per_layer and
               speculate=4 in graphs, bit-equal to no mesh, the
               collectives' device ms), whose first prefill logits and
               an f32 CPU reference hold the 2x2 ranks' logits (max
               |err| against f32 within 2x world 1's). Prints seconds to
               Ready, each rank's weight GiB and peak host RSS and ms a
               served token (the gloo parts' are time-sliced ranks on
               one card, not a speed);
  5. serve_cli — the engine Pod's entry point: a random-weight Llama
               checkpoint at Llama-3-8B width (4 layers, bf16) written with
               `weights.save_safetensors`, uploaded to a fake S3 on
               127.0.0.1 and served by `python -m
               kubeai_tpu_torch.engine.server` in a subprocess six times.
               First the object-store boots, `--model-url s3://...` with
               `--snapshot-url gs://...` (a fake GCS): `--speculate 4`
               loads in full and publishes its snapshot after the
               warm-up; the same flags again from a copy of the package
               whose build/ is empty must restore (the tree bit-equal to
               the tensors written, the kernel library put in place so no
               nvcc runs) and load an adapter through lora_url s3://; the
               default config with --snapshot-no-publish must miss and
               load in full (events published, restored, absent; seconds
               to Ready, every phase, restore GB/s against load GB/s
               through the fake S3). Then `--speculate 4 --draft-url`
               with a 2-layer draft checkpoint at the same width written
               beside it, and `--quantization int8`, which must log the
               weights' GiB; each run: the four chat requests
               of the serve runs (one streamed), /metrics and /v1/state,
               /v1/drain and SIGTERM, which must exit 0 within the drain
               budget. The same checkpoint loaded in-process through
               `weights.load_params` must be bit-equal to the tensors
               written, and an in-process engine of each run's
               configuration on it must give the greedy streams served over
               HTTP. Each run also sends one request with a traceparent
               and an X-Request-Id: its server span must reach a local
               OTLP/HTTP sink (OTEL_EXPORTER_OTLP_TRACES_ENDPOINT) with the
               client's trace id, parent and request id. The default run
               (`--max-adapters 4`, the default) then runs the LoRA admin
               round: a PEFT adapter loaded from a local directory,
               listed on /v1/models and /v1/state, a request naming it
               served, "already loaded" for the same path, a reload from
               another, 404 for an unknown model and for a second
               unload. Reports the load
               rate, the cold-start phases and TTFT. Then a `--role
               prefill` and a `--role decode` process side by side: one
               greedy body through the two hops must give the decode
               process's direct text. Then a 2-layer Gemma-2 checkpoint at
               Gemma-2-9B width and a 2-layer Gemma-1 (GemmaForCausalLM)
               checkpoint at Gemma-7B width, each served by the CLI once
               with its defaults, and the Gemma-2 one again with
               `--kv-dtype int8` (/v1/state must report int8 pools):
               /v1/load_lora_adapter must answer 400 (ROADMAP fault C10),
               the loaded tensors must be the ones written and the greedy
               streams an in-process engine's. Last a 2-layer Mixtral
               checkpoint at Mixtral-8x7B width (6.3 GB) with its defaults:
               /v1/load_lora_adapter 400 (C10), /v1/embeddings 400, every
               tensor and expert slot loaded bit-equal, the greedy streams
               an in-process engine's; `--quantization int8` must exit at
               boot naming ROADMAP fault C15.

Each phase prints its seconds on a line of its own ("phase <name>: s"),
and its start and end on stderr. A run still going after WATCHDOG_S
prints every thread's stack to stderr and exits 1.

The last lines are the kernel JSON line, the card's name and power limit
(nvidia-smi), and {"ok": true, "device": {...}}. Without a CUDA device, or
without the kubeai_tpu_torch package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import statistics
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
# Kernel name -> (its CUDA source, the TPU kernel's pallas_call it replaces,
# or for the W8A16 GEMM the JAX line whose fused dequantize it stands for).
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
    # B1's int8 read: the same pallas_call's function over an int8 pool,
    # which the JAX package computes on its reference path.
    "paged_decode_attention_int8": (
        "kubeai_tpu_torch/csrc/paged_decode.cu",
        "kubeai_tpu/ops/paged_attention.py:309",
    ),
    # The head_dim-256 builds of B1 and B4 (Gemma), which serve_gemma
    # drives: entries of their own in the kernels line.
    "paged_decode_attention_d256": (
        "kubeai_tpu_torch/csrc/paged_decode.cu",
        "kubeai_tpu/ops/paged_attention.py:309",
    ),
    "paged_decode_attention_fused_d256": (
        "kubeai_tpu_torch/csrc/paged_decode_fused.cu",
        "kubeai_tpu/ops/paged_attention.py:837",
    ),
    # B2's head_dim-64 build at Qwen2.5-0.5B's heads (G=7), which
    # serve_embed's /v1/embeddings drives: 24 launches a batch.
    "flash_causal_prefill_d64": (
        "kubeai_tpu_torch/csrc/flash_prefill.cu",
        "kubeai_tpu/ops/pallas_attention.py:108",
    ),
    # B2's head_dim-64 build at Llama-3.2-1B's heads (G=4), which the
    # draft model's admissions in serve_draft drive: 16 launches each.
    "flash_causal_prefill_d64_g4": (
        "kubeai_tpu_torch/csrc/flash_prefill.cu",
        "kubeai_tpu/ops/pallas_attention.py:108",
    ),
    # B2's head_dim-256 build (Gemma-1), which serve_gemma1 drives.
    "flash_causal_prefill_d256": (
        "kubeai_tpu_torch/csrc/flash_prefill.cu",
        "kubeai_tpu/ops/pallas_attention.py:108",
    ),
    # B1-int8's head_dim-256 build (gemma on int8 pools), which
    # serve_gemma's int8 run drives.
    "paged_decode_attention_int8_d256": (
        "kubeai_tpu_torch/csrc/paged_decode.cu",
        "kubeai_tpu/ops/paged_attention.py:309",
    ),
    # The W8A16 GEMM of int8 weights, which serve_int8_weights drives: its
    # skinny kernel (decode steps) and its wgmma kernel (admissions and
    # verify windows). Not a pallas_call: it stands for XLA's fused
    # dequantize-into-dot, `_w` in the JAX llama forward.
    "w8a16_skinny": (
        "kubeai_tpu_torch/csrc/w8a16_gemm.cu",
        "kubeai_tpu/models/llama.py:39",
    ),
    "w8a16_wgmma": (
        "kubeai_tpu_torch/csrc/w8a16_gemm.cu",
        "kubeai_tpu/models/llama.py:39",
    ),
}


# The run must end within 1200 s: past WATCHDOG_S it prints every
# thread's stack to stderr and exits 1. A request that gets no answer
# within REQUEST_TIMEOUT_S fails its phase.
WATCHDOG_S = 1140
REQUEST_TIMEOUT_S = 180


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


def cold_graph_ms(calls, rounds: int = 4, replays: int = 5) -> float:
    """Device time per call with a cold L2: `calls` read disjoint copies of
    their inputs, and one CUDA graph runs them in turn `rounds` times, so
    each call finds its inputs evicted by the others' traffic (the caller
    makes that traffic pass the 50 MB L2)."""
    def run():
        for call in calls:
            out = call()
        return out

    return graph_ms(run, iters=rounds, replays=replays) / len(calls)


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
                    or "warning" in line or line.startswith("==")):
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


def _clone_pool(pages):
    """A copy of a bf16 pool or an int8 QuantizedPool, in new memory."""
    from kubeai_tpu_torch.ops.kv_quant import QuantizedPool

    if isinstance(pages, QuantizedPool):
        return QuantizedPool(pages.q8.clone(), pages.scale.clone())
    return pages.clone()


def _quantize_pool(pages):
    """A bf16 [P, page, KVH, D] pool as an int8 QuantizedPool."""
    from kubeai_tpu_torch.ops.kv_quant import QuantizedPool, quantize_kv

    return QuantizedPool(*quantize_kv(pages))


def check_paged_decode(int8: bool = False) -> dict:
    """B1 at the serving shapes: 8 slots, lengths ragged up to 2048 (slot 0
    the whole table, slot 1 one token), four cases and one wrong page; then
    two calls and a CUDA-graph replay that must give the same bits, the
    split edges, slots past the block table, B=1 at a 16k context, and
    B1's registers and spills from the build log. With `int8`, B1's int8
    read (paged_decode_attention_int8) on the same random pools quantized
    by kv_quant.quantize_kv, against the plain version on the same int8
    pages and scales, at B1's limits."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import ref_paged_decode_attention

    gen = torch.Generator().manual_seed(1)
    q, kp, vp, bt, lengths = _paged_inputs(gen)
    if int8:
        kp, vp = _quantize_pool(kp), _quantize_pool(vp)
    name, kernel = _decode_kernel(kp)
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
            _wrong_page_fails(name, got,
                              ref_paged_decode_attention(q, kp, vp, bad_bt, lengths),
                              PAGED_ATOL, PAGED_RTOL)
        line = _time_decode(args, kw, library=cap is None and win is None)
        line["max_abs_err"] = err
        if cap is None and win is None:
            result = dict(line)
        print("kernel %s B=%d H=%d KVH=%d D=%d page=%d max_len=%d %s" % (
            kernel.__name__, B, H, KVH, D, page, int(lengths.max()), json.dumps(line)),
            flush=True)

    # The combine merges the splits in a fixed order: two calls, same bits.
    first = kernel(*args)
    if not torch.equal(first, kernel(*args)):
        fail(f"{name}: two calls on the same inputs differ")
    # The wrapper reads no device value: one call captured in a CUDA graph
    # and replayed gives the eager call's output.
    graph, captured = capture(lambda: kernel(*args))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, first):
        fail(f"{name}: the CUDA-graph replay differs from the eager call")
    print(f"{name}: two eager calls bit-identical; CUDA-graph replay equals "
          "the eager call", flush=True)
    check_decode_split_edges(q, kp, vp, gen)
    check_decode_past_table(q, kp, vp, gen)
    check_decode_long_context(int8)
    check_decode_groups(int8)
    # paged_decode.cu builds both walks: each check reads its own.
    check_ptxas("paged_decode.cu", lambda n: ("int8" in n) == int8)
    return result


def _decode_kernel(kp):
    """(label, wrapper) of the B1 kernel a pool goes to: B1's int8 read for
    an int8 QuantizedPool, else B1."""
    from kubeai_tpu_torch.ops.kv_quant import QuantizedPool
    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_int8,
    )

    if isinstance(kp, QuantizedPool):
        return "paged_decode_int8", paged_decode_attention_int8
    return "paged_decode", paged_decode_attention


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
    does). An int8 pool goes to B1's int8 read, whose own launch count
    must move, and is held against the plain version on the same int8
    pages and scales. Returns (the kernel's output, max |err|)."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        ref_paged_decode_attention,
    )

    _, kp, _, bt, lengths = args
    name, kernel = _decode_kernel(kp)
    before = kernel.launches
    got = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail(f"{name} {tag}: paged_decode_attention did not launch {kernel.__name__}")
    want = ref_paged_decode_attention(*args, **kw)
    masked = _decode_masked_slots(lengths, bt.shape[1] * kp.shape[1], kw.get("window"))
    if bool(masked.any()):
        if not bool((got[masked] == 0).all()):
            fail(f"{name} {tag}: a slot that keeps no key is not 0")
        want = torch.where(masked[:, None, None], torch.zeros_like(want), want)
    return got, compare(f"{name} {tag}", got, want, PAGED_ATOL, PAGED_RTOL)


def _time_decode(args, kw: dict, library: bool) -> dict:
    """B1's time, its plain version's, its bound for this data and, where
    asked, SDPA's on the same keys gathered dense and length-masked (its
    yardstick). B1 and SDPA are timed from a CUDA graph (`ms`,
    `library_ms`: device time per call) and eagerly (`eager_ms`,
    `library_eager_ms`: back-to-back calls from Python, which the host's
    launch overhead can bound); `split_ms` and `combine_ms` are B1's two
    kernels from torch.profiler. Where asked, `cold_ms` is the graph time
    with a cold L2: the calls rotate over copies of q and the pools whose
    reads pass 100 MB between two calls on one copy (`ms` replays calls on
    the same pools, which the 50 MB L2 may hold). An int8 pool reads D int8
    values and one f32 scale a kept row; its `library_ms` is SDPA on the
    dequantized bf16 view of the same pages, a yardstick only (no PyTorch
    call attends over int8 pages)."""
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.kv_quant import QuantizedPool, dequantize_kv
    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        ref_paged_decode_attention,
    )

    q, kp, vp, bt, lengths = args
    B, H, D = q.shape
    KVH, page = kp.shape[2], kp.shape[1]
    L = bt.shape[1] * page
    win = kw.get("window")
    int8 = isinstance(kp, QuantizedPool)
    row_bytes = D + 4 if int8 else 2 * D
    call = lambda: paged_decode_attention(*args, **kw)  # noqa: E731
    ms, eager_ms = graph_ms(call), cuda_ms(call)
    plain_ms = cuda_ms(lambda: ref_paged_decode_attention(*args, **kw), iters=5)
    # "split_walk" names both walks: paged_split_walk_kernel (bf16) and
    # paged_split_walk_int8_kernel.
    kernel_ms = device_ms_by_kernel(call, ("split_walk", "combine_kernel"))
    # This data's work: the keys the mask keeps inside the table, read
    # once; 4 * D flops per head per kept key; q and the output, the block
    # tables and the lengths.
    n_keys = sum(max(min(n, L) - (max(n - win, 0) if win else 0), 0)
                 for n in lengths.tolist())
    nbytes = (n_keys * KVH * row_bytes * 2 + 2 * q.numel() * 2
              + bt.numel() * 4 + lengths.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = 4.0 * D * H * n_keys / PEAK_BF16_FLOPS * 1e3
    line = dict(softcap=kw.get("logit_softcap"), window=win, ms=ms, eager_ms=eager_ms,
                split_ms=kernel_ms["split_walk"],
                combine_ms=kernel_ms["combine_kernel"], plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_flops), bytes=nbytes,
                bound_by="bytes" if t_bytes >= t_flops else "operations")
    if library:
        copies = [args] + [(q.clone(), _clone_pool(kp), _clone_pool(vp), bt, lengths)
                           for _ in range(-(-100_000_000 // nbytes))]
        line["cold_ms"] = cold_graph_ms(
            [lambda a=a: paged_decode_attention(*a, **kw) for a in copies])
        line["cold_copies"] = len(copies)
        del copies
        idx = bt.long().clamp(min=0)
        if int8:
            kp, vp = (dequantize_kv(p.q8[idx], p.scale[idx]) for p in (kp, vp))
        else:
            kp, vp = kp[idx], vp[idx]
        kd = kp.reshape(B, L, KVH, D).transpose(1, 2).contiguous()
        vd = vp.reshape(B, L, KVH, D).transpose(1, 2).contiguous()
        col, n = torch.arange(L, device="cuda")[None, :], lengths[:, None].long()
        # The window masks as B1 does; SDPA has no softcap, so with one
        # its yardstick skips the tanh.
        mask = ((col < n) & ((col >= n - win) if win else True))[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd, vd, attn_mask=mask, enable_gqa=True)
        line["library_ms"], line["library_eager_ms"] = graph_ms(sdpa), cuda_ms(sdpa)
        del kd, vd
    return line


def check_decode_split_edges(q, kp, vp, gen) -> None:
    """Lengths at the edges of B1's splits (a boundary, one either side,
    twice over), 1 and 0 (which must write 0), on the kernel phase's pool,
    with a window that masks whole splits; an int8 pool at the edges of
    int8_split's. No timing."""
    import torch

    from kubeai_tpu_torch.ops.kv_quant import QuantizedPool
    from kubeai_tpu_torch.ops.paged_attention import fused_split, int8_split

    B, page, mp = q.shape[0], kp.shape[1], 32
    if isinstance(kp, QuantizedPool):
        _, per = int8_split(B, kp.shape[2], mp, page, kp.shape[3])
    else:
        _, per = fused_split(B, kp.shape[2], mp, page, kp.shape[3])
    edge = per * page  # tokens in a split
    lengths = torch.tensor([edge, edge - 1, edge + 1, 1, 0, 2 * edge,
                            2 * edge - 1, 2 * edge + 1][:B])
    bt = _table(lengths.tolist(), page, mp, gen).to("cuda")
    args = (q, kp, vp, bt, lengths.to("cuda", torch.int32))
    errs = [_check_decode_case(f"split edges {edge} softcap={cap} window={win}", args,
                               dict(logit_softcap=cap, window=win))[1]
            for cap, win in ((None, None), (30.0, None), (None, edge + 10), (50.0, 100))]
    print(f"{_decode_kernel(kp)[0]} split edges (splits of {edge} tokens; lengths "
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
    print(f"{_decode_kernel(kp)[0]} past the table ({L} keys; lengths {lengths.tolist()}; plain, "
          f"softcap 30, window 500, softcap 50 + window 100, window 2; slots keeping no "
          f"key, all 0: {n_masked}): max |err| {['%.3e' % e for e in errs]}", flush=True)


def check_decode_groups(int8: bool = False) -> None:
    """The group sizes the 8B case does not run (G = 4 there): 1, 2, 7 and
    8 query heads per kv head, at D = 128 and 64, plain and with softcap
    50 + window 100, at a small size. No timing."""
    import torch

    B, KVH, page, max_len = 4, 4, 64, 512
    gen = torch.Generator().manual_seed(12)
    lengths = torch.randint(1, max_len + 1, (B,), generator=gen)
    bt = _table(lengths.tolist(), page, max_len // page, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(13)

    def rnd(*shape):
        return torch.randn(*shape, generator=cg, device="cuda").to(torch.bfloat16)

    errs = []
    for D in (128, 64):
        kp, vp = rnd(1 + B * max_len // page, page, KVH, D), rnd(1 + B * max_len // page,
                                                                   page, KVH, D)
        if int8:
            kp, vp = _quantize_pool(kp), _quantize_pool(vp)
        for G in (1, 2, 7, 8):
            args = (rnd(B, G * KVH, D), kp, vp, bt, lengths.to("cuda", torch.int32))
            for cap, win in ((None, None), (50.0, 100)):
                errs.append(_check_decode_case(f"D={D} G={G} softcap={cap} window={win}",
                                               args, dict(logit_softcap=cap, window=win))[1])
    print(f"{_decode_kernel(kp)[0]} groups (D 128, 64 x G 1, 2, 7, 8 x plain, softcap 50 + "
          f"window 100): max |err| {['%.3e' % e for e in errs]}", flush=True)


def check_decode_long_context(int8: bool = False) -> None:
    """B=1 at a 16k context: length 16384 over 256 pages, the shape where
    one CTA per (slot, kv head) left most SMs idle; int8 pools quantized
    from the same random pages with `int8`."""
    import torch

    B, H, KVH, D, page, mp = 1, 32, 8, 128, 64, 256
    gen = torch.Generator().manual_seed(16)
    lengths = torch.tensor([mp * page])
    bt = _table(lengths.tolist(), page, mp, gen).to("cuda")
    cg = torch.Generator("cuda").manual_seed(17)

    def rnd(*shape):
        return torch.randn(*shape, generator=cg, device="cuda").to(torch.bfloat16)

    kp, vp = rnd(1 + B * mp, page, KVH, D), rnd(1 + B * mp, page, KVH, D)
    if int8:
        kp, vp = _quantize_pool(kp), _quantize_pool(vp)
    args = (rnd(B, H, D), kp, vp, bt, lengths.to("cuda", torch.int32))
    _, err = _check_decode_case("B=1 16k", args, {})
    line = _time_decode(args, {}, library=True)
    line["max_abs_err"] = err
    print("kernel %s long context B=%d H=%d KVH=%d D=%d page=%d length=%d %s" % (
        _decode_kernel(kp)[1].__name__, B, H, KVH, D, page, int(lengths[0]),
        json.dumps(line)), flush=True)
    del kp, vp, args
    torch.cuda.empty_cache()


def _flash_case(B: int, S: int, H: int, KVH: int, D: int, gen) -> tuple[dict, object]:
    """One B2 case on inputs drawn from `gen`: the kernel against the
    plain version at FLASH_ATOL / FLASH_RTOL, timed from a CUDA graph and
    eagerly (back-to-back calls from Python, which the host's launch
    overhead can bound at the small shapes) beside SDPA (enable_gqa) and
    the bound. Prints the case's line; returns it and the kernel's call on
    the case's inputs."""
    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops.attention import causal_prefill_attention
    from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill

    mk = lambda h: torch.randn(B, S, h, D, generator=gen, device="cpu").to(  # noqa: E731
        "cuda", torch.bfloat16)
    q, k, v = mk(H), mk(KVH), mk(KVH)
    got = flash_causal_prefill(q, k, v)
    torch.cuda.synchronize()
    want = causal_prefill_attention(q, k, v)
    err = compare(f"flash_prefill B={B} S={S} H={H} KVH={KVH} D={D}", got, want,
                  FLASH_ATOL, FLASH_RTOL)
    del got, want
    call = lambda: flash_causal_prefill(q, k, v)  # noqa: E731
    ms, eager_ms = graph_ms(call), cuda_ms(call)
    # The plain version's f32 logits take 8.6 GB at H=32, S=8192: few
    # calls there.
    few = S >= 4096
    plain_ms = cuda_ms(lambda: causal_prefill_attention(q, k, v),
                       iters=1 if few else 5, warmup=1 if few else 3)
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_ms, lib_eager_ms = graph_ms(sdpa), cuda_ms(sdpa)
    del qt, kt, vt
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
    return line, call


def check_flash_prefill() -> dict:
    """B2 at the serving widths (H=32, KVH=8, D=128): B=1 and 4 over the
    serve phase's buckets and a ragged 200, and B=1 at 2048 and 8192
    (`_flash_case`); then two calls and a CUDA-graph replay that must give
    the same bits, and B2's registers and spills from the build log.
    Returns the B=1 S=512 line for the kernels line."""
    import torch

    gen = torch.Generator().manual_seed(2)
    main = None
    # S=32 and 128 are the buckets of the serve phase's two short prompts
    # (32 is less than one 128-row block); 512 and 1024 those of its long
    # ones; 2048 is its max_seq_len; 8192 a long prompt.
    cases = [(B, S) for B in (1, 4) for S in (32, 128, 200, 512, 1024)]
    for B, S in cases + [(1, 2048), (1, 8192)]:
        line, call = _flash_case(B, S, 32, 8, 128, gen)
        if (B, S) == (1, 512):
            main = line
        if (B, S) == (4, 1024):
            # Every CTA writes its own rows, in one order. The wrapper
            # reads no device value and builds its TMA maps on the host.
            _same_bits("flash_prefill", call)
        del call
        torch.cuda.empty_cache()
    check_ptxas("flash_prefill.cu")
    return main


def check_flash_prefill_d256() -> dict:
    """B2's head_dim-256 build (Gemma-1; 128-row blocks, each consumer
    warpgroup's 64 rows with O whole, 64-key K/V tiles): Gemma-7B's heads
    (H=16, KVH=16) at B=1 over the serve_gemma1 buckets (32, 512, 2048,
    8192), 128, 1024, and a ragged 160 and 200 (the second block's second
    consumer has no row below S, or 8), and at B=4 for S=1024; Gemma-2B's
    (H=8 over KVH=1, G=8) at B=1 for S 512 and 8192 (`_flash_case`, whose
    lines carry tflops); then two calls and a graph replay that must give
    the same bits, and the D=256 instantiation's registers, spills and
    setmaxnreg warnings. Returns the B=1 S=8192 Gemma-7B line (the bucket
    of serve_gemma1's longest prompt) for the kernels line."""
    import torch

    gen = torch.Generator().manual_seed(25)
    main = None
    cases = [(16, 16, 1, S) for S in (32, 128, 160, 200, 512, 1024, 2048, 8192)]
    cases += [(16, 16, 4, 1024), (8, 1, 1, 512), (8, 1, 1, 8192)]
    for H, KVH, B, S in cases:
        line, call = _flash_case(B, S, H, KVH, 256, gen)
        if (H, B, S) == (16, 1, 8192):
            main = line
        if (H, B, S) == (16, 4, 1024):
            _same_bits("flash_prefill D=256", call)
        del call
        torch.cuda.empty_cache()
    check_ptxas("flash_prefill.cu", select=lambda name: name.endswith("<256>"))
    print(f"flash_prefill D=256 card: {gpu_line()}", flush=True)
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


def ptxas_warnings(source: str) -> list[str]:
    """The warning lines of `source`'s section of the build log."""
    from kubeai_tpu_torch.ops import _build

    log = _build.build_dir() / "build.log"
    lines, in_source = [], False
    for line in log.read_text().splitlines():
        line = line.strip()
        if line.startswith("== "):
            in_source = line[3:] == source
        elif in_source and "warning" in line.lower():
            lines.append(line)
    return lines


def check_ptxas(source: str, select=None) -> None:
    """Print the registers and spills of every kernel ptxas compiled from
    `source` (those whose readable name `select` accepts, if given); fail
    if there is no report, any of them spills, or ptxas says it ignored a
    setmaxnreg of the source (the consumers would then run on the
    launch's registers)."""
    ignored = [w for w in ptxas_warnings(source) if "setmaxnreg" in w]
    if ignored:
        fail(f"{source}: ptxas ignored setmaxnreg: {ignored}")
    rows = []
    for entry, regs, spills in ptxas_report(source):
        # _ZN...paged_split_walk_kernelILi128ELi4ELb0EEEv... ->
        # paged_split_walk_kernel<128, 4, 0>
        m = re.search(r"([a-z][a-z_]*(?:_int8)?_kernel)I((?:L[ib]\d+E)+)", entry)
        name = (f"{m.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                if m else entry)
        if select is None or select(name):
            rows.append((entry, regs, spills))
            print(f"ptxas {source} {name}: {regs} registers, {spills} bytes spilled",
                  flush=True)
    if not rows:
        fail(f"{source}: no ptxas report in the build log")
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
        col = torch.arange(L + 1, device="cuda")[None, :]
        old = col < pos.long()[:, None]
        if kw.get("window"):  # B4's window, the new column always kept
            old = old & (col >= pos.long()[:, None] + 1 - kw["window"])
        mask = (old | (col == L))[:, None, None, :]
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
    _, per = fused_split(B, kp.shape[3], mp, page, kp.shape[4])
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
        k8, v8 = _quantize_pool(kp[1]), _quantize_pool(vp[1])
        errs.append(_check_decode_case(tag, (q, k8, v8, bt, pos + 1), kw)[1])
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
    print(f"kernels at head_dim 64 (B1, B1-int8, B3, B4: plain, softcap 50 + window 100; "
          f"B2: S=200, 512): max |err| {['%.3e' % e for e in errs]}", flush=True)


# Qwen2.5-0.5B's attention heads (the catalog's embedder, and its
# qwen2.5-0.5b-instruct): 14 query heads over 2 kv heads, a group of 7, at
# head_dim 64.
QWEN_H, QWEN_KVH, QWEN_D = 14, 2, 64


def check_qwen_heads() -> dict:
    """The kernels at Qwen2.5-0.5B's heads (H=14 over KVH=2, G=7, D=64),
    which no other case runs. B2 at B=1 over S 32, 200, 512 and 2048 and at
    B=8 over S 128 and 2048 (`_flash_case`: against the plain version at
    FLASH_ATOL / FLASH_RTOL, timed beside SDPA and the bound), with two
    calls and a graph replay that must give the same bits; B1 on bf16 and
    int8 pools and B4 (a 2-layer stacked pool at layer 1) against their
    plain versions at their limits: B=8, lengths ragged to 2048 (one full,
    one of a single token), plain and with softcap 50 + window 100. Returns
    B2's B=8 S=2048 line (serve_embed's batch of 8 in its largest bucket)
    for the kernels line."""
    import torch

    gen = torch.Generator().manual_seed(64)
    main = None
    for B, S in ((1, 32), (1, 200), (1, 512), (1, 2048), (8, 128), (8, 2048)):
        line, call = _flash_case(B, S, QWEN_H, QWEN_KVH, QWEN_D, gen)
        if (B, S) == (8, 2048):
            main = line
        if (B, S) == (8, 128):
            _same_bits("flash_prefill qwen heads", call)
        del call
        torch.cuda.empty_cache()
    q, kp, vp, bt, lengths = _paged_inputs(gen, H=QWEN_H, KVH=QWEN_KVH, D=QWEN_D)
    mk = lambda *shape: torch.randn(*shape, generator=gen).to(  # noqa: E731
        "cuda", torch.bfloat16)
    kps, vps = torch.stack([mk(*kp.shape), kp]), torch.stack([mk(*vp.shape), vp])
    kn, vn = mk(q.shape[0], QWEN_KVH, QWEN_D), mk(q.shape[0], QWEN_KVH, QWEN_D)
    k8, v8 = _quantize_pool(kp), _quantize_pool(vp)
    errs = []
    for cap, win in ((None, None), (50.0, 100)):
        kw = dict(logit_softcap=cap, window=win)
        tag = f"qwen heads softcap={cap} window={win}"
        errs.append(_check_decode_case(tag, (q, kp, vp, bt, lengths), kw)[1])
        errs.append(_check_decode_case(tag, (q, k8, v8, bt, lengths), kw)[1])
        errs.append(_check_fused_case(tag, (q, kps, vps, kn, vn, bt, lengths - 1, 1), kw)[1])
    print(f"kernels at Qwen2.5-0.5B's heads (H={QWEN_H}, KVH={QWEN_KVH}, D={QWEN_D}): B1, "
          f"B1-int8, B4 (plain, softcap 50 + window 100): max |err| "
          f"{['%.3e' % e for e in errs]}; card: {gpu_line()}", flush=True)
    return main


# Llama-3.2-1B-Instruct (meta-llama/Llama-3.2-1B-Instruct config.json), the
# catalog's draft for Llama-3.1-8B: its heads are B2's group of 4 at
# head_dim 64.
DRAFT_1B = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                num_layers=16, num_heads=32, num_kv_heads=8, head_dim=64,
                rope_theta=500000.0, rms_norm_eps=1e-5,
                rope_scaling={"rope_type": "llama3", "factor": 32.0,
                              "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                              "original_max_position_embeddings": 8192},
                max_position_embeddings=131072, tie_word_embeddings=True)
# Llama-3.1-8B's rope scaling (meta-llama/Llama-3.1-8B-Instruct
# config.json), over serve_weights' Llama-3-8B shapes: the draft run's
# target.
LLAMA31_ROPE = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}


def check_draft_heads() -> dict:
    """B2 at Llama-3.2-1B's heads (H=32 over KVH=8, G=4, D=64), the draft
    model's prefill in serve_draft, which no other case runs: B=1 at S 512
    and 2048 and B=8 at 128 (`_flash_case`: against the plain version at
    FLASH_ATOL / FLASH_RTOL, timed beside SDPA and the bound), and two
    calls and a graph replay that must give the same bits. Returns the B=1
    S=512 line (a draft admission of a 317-token prompt in its bucket)
    for the kernels line."""
    import torch

    gen = torch.Generator().manual_seed(65)
    main = None
    H, KVH, D = DRAFT_1B["num_heads"], DRAFT_1B["num_kv_heads"], DRAFT_1B["head_dim"]
    for B, S in ((1, 512), (1, 2048), (8, 128)):
        line, call = _flash_case(B, S, H, KVH, D, gen)
        if (B, S) == (1, 512):
            main = line
            _same_bits("flash_prefill draft heads", call)
        del call
        torch.cuda.empty_cache()
    print(f"kernels at Llama-3.2-1B's heads (H={H}, KVH={KVH}, D={D}): B2 checked; card: "
          f"{gpu_line()}", flush=True)
    return main


# ---- the W8A16 GEMM (int8 weights) ------------------------------------------

# W8A16 GEMM against its plain version, both on the card in bf16 on the same
# int8 weights and scales: each weight is formed as the same bf16 value, so
# the two differ only in the order of the f32 sums and in where each bf16
# output rounds: one bf16 step of the output (2^-8 to 2^-7 of it, under
# GEMM_RTOL), plus the sum order and cuBLAS's split-K rounding near zero
# (under GEMM_ATOL; the outputs are O(1)). A misplaced fragment or a wrong
# scale moves outputs by O(1).
GEMM_ATOL = 1e-2
GEMM_RTOL = 1e-2
# (K, N) of Llama-3-8B's four layer-weight shapes: wq and wo, wk and wv,
# w_gate and w_up, w_down; then Qwen2.5-0.5B's (E=896, KVH*D=128, FFN 4864).
GEMM_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
QWEN_GEMM_SHAPES = ((896, 896), (896, 128), (896, 4864), (4864, 896))
# How often each shape of GEMM_SHAPES runs in a layer (wq and wo, wk and
# wv, w_gate and w_up, w_down): the weights of a layer's time.
LAYER_USES = (2, 2, 2, 1)
# Rows: one slot, a decode step of 8 slots, 16, 24 and 32 about the
# crossover, ragged 37, a verify window of 8 x 5, 48, the skinny kernel's
# limit and one past it, prefills of 96 and 128 rows, the 512 bucket, 1024,
# a batch of 4 x 1024.
GEMM_ROWS = (1, 8, 16, 24, 32, 37, 40, 48, 64, 65, 96, 128, 512, 1024, 4096)
# Where both kernels take M (M <= SKINNY_MAX_M), the one `route` sends it
# to may be this share slower than the other over a layer's seven products
# before the smoke fails. Each kernel is timed ROUTE_ROUNDS times, the two
# in turns, and its median kept: two single timings of one kernel in one
# run differed by up to ~10%, the medians of such rounds by a few percent.
ROUTE_SLACK = 0.05
ROUTE_ROUNDS = 5


def _int8_leaf(K: int, N: int, gen, dead: int | None = None) -> dict:
    """A quantized [K, N] leaf (quantization.quantize_tensor, N-major, on
    the card) of weights drawn at the smoke's scale (0.02); channel `dead`
    all zero (its scale at the 1e-8 floor)."""
    import torch

    from kubeai_tpu_torch.engine.quantization import quantize_tensor

    w = (torch.randn(K, N, generator=gen) * 0.02).to("cuda", torch.bfloat16)
    if dead is not None:
        w[:, dead] = 0
    return quantize_tensor(w)


def _gemm_kernels(x, leaf) -> dict:
    """The W8A16 kernels that take x's rows, by name: the wgmma kernel at
    any M (gemm_plan's rows a CTA and K splits), the skinny one up to
    SKINNY_MAX_M."""
    from kubeai_tpu_torch.ops.int8_matmul import SKINNY_MAX_M, w8a16_skinny, w8a16_wgmma

    kernels = {"w8a16_wgmma": lambda: w8a16_wgmma(x, leaf)}
    if x.shape[0] <= SKINNY_MAX_M:
        kernels["w8a16_skinny"] = lambda: w8a16_skinny(x, leaf)
    return kernels


def _alternating_ms(calls: dict, rounds: int) -> dict:
    """Each call's median ms from CUDA graphs (graph_ms) over `rounds`
    rounds, the calls timed in turns within each round; one timing each
    when there is one call."""
    if len(calls) == 1:
        return {name: graph_ms(fn) for name, fn in calls.items()}
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            times[name].append(graph_ms(fn))
    return {name: statistics.median(t) for name, t in times.items()}


def _plan(M: int, N: int, K: int) -> str:
    """What int8_linear runs for M rows of a [K, N] weight."""
    from kubeai_tpu_torch.ops.int8_matmul import gemm_plan, route, w8a16_wgmma

    fn = route(M)
    if fn is w8a16_wgmma:
        return "w8a16_wgmma, {} rows a CTA, K in {}".format(*gemm_plan(M, N, K))
    return fn.__name__


def _gemm_case(M: int, K: int, N: int, leaf: dict, gen, timed: bool) -> dict:
    """One W8A16 case: each kernel that takes M (`_gemm_kernels`) against
    the plain version on the card at GEMM_ATOL / GEMM_RTOL, int8_linear
    equal to the kernel `route` sends M to, and against an f32 product of
    the same operands (reported); with `timed`, each kernel's ms from CUDA
    graphs of 20 calls (medians of ROUTE_ROUNDS in turns where two take
    M), int8_linear's eagerly, the plain version's, cuBLAS's (torch.matmul
    on a bf16 copy of the dequantized weight, from a graph) and the bound.
    `kernel` names the routed kernel and `ms`, `max_abs_err` are its."""
    import torch

    from kubeai_tpu_torch.ops.int8_matmul import dequantize_as, int8_linear, route

    x = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
    plain = lambda: torch.matmul(x, dequantize_as(leaf, torch.bfloat16))  # noqa: E731
    want = plain()
    kernels = _gemm_kernels(x, leaf)
    routed = route(M).__name__
    errs = {name: compare(f"{name} M={M} K={K} N={N}", fn(), want, GEMM_ATOL, GEMM_RTOL)
            for name, fn in kernels.items()}
    got = int8_linear(x, leaf)
    if not torch.equal(got, kernels[routed]()):
        fail(f"int8_linear M={M} K={K} N={N}: not the bits of {routed}, its route")
    deq = dequantize_as(leaf, torch.bfloat16)
    err32 = float((got.float() - x.float() @ deq.float()).abs().max())
    line = dict(kernel=routed, plan=_plan(M, N, K), max_abs_err=errs[routed],
                max_abs_err_f32=err32, errs={k: v for k, v in errs.items() if k != routed})
    if timed:
        times = _alternating_ms(kernels, ROUTE_ROUNDS)
        line.update(ms=times[routed], eager_ms=cuda_ms(lambda: int8_linear(x, leaf)),
                    plain_ms=cuda_ms(plain), library_ms=graph_ms(lambda: torch.matmul(x, deq)))
        line["other_ms"] = {k: v for k, v in times.items() if k != routed}
        nbytes = K * N + 4 * N + 2 * M * K + 2 * M * N
        flops = 2.0 * M * K * N
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_BF16_FLOPS * 1e3
        line.update(bound_ms=max(t_bytes, t_flops),
                    bound_by="operations" if t_flops >= t_bytes else "bytes",
                    weight_gb_s=K * N / line["ms"] * 1e-6, tflops=flops / line["ms"] * 1e-9)
    print(f"kernel int8_linear M={M} K={K} N={N} {json.dumps(line)}", flush=True)
    line["times"] = times if timed else {}
    return line


def check_int8_gemm() -> dict:
    """The W8A16 GEMM (`ops.int8_matmul.int8_linear`, csrc/w8a16_gemm.cu):
    at Llama-3-8B's four weight shapes for every M of GEMM_ROWS, each
    kernel that takes M against the plain version and timed
    (`_gemm_case`); where both take M, the routed kernel within
    ROUTE_SLACK of the faster over a layer's seven products (LAYER_USES),
    from medians of ROUTE_ROUNDS timings in turns; a dead output
    channel (scale at the 1e-8 floor) that must come out exactly 0 from
    each kernel; Qwen2.5-0.5B's four shapes at M 8, 40 and 512; two calls
    and a graph replay that must give the same bits (the skinny kernel at
    M=8; the wgmma kernel at M=40 and 512, at w_gate's shape and at wk's,
    whose tiles are few enough that K is split); f32 activations and a
    weight not packed N-major must
    raise; registers and spills. Returns the lines of the decode step's
    w_gate (M=8, the skinny kernel) and of the 512 bucket's (M=512, the
    wgmma kernel) for the kernels line, by kernel."""
    import torch

    from kubeai_tpu_torch.ops.int8_matmul import int8_linear, route

    gen = torch.Generator().manual_seed(81)
    main = {}
    layer: dict[int, dict[str, float]] = {M: {} for M in GEMM_ROWS}
    for (K, N), uses in zip(GEMM_SHAPES, LAYER_USES):
        leaf = _int8_leaf(K, N, gen)
        for M in GEMM_ROWS:
            line = _gemm_case(M, K, N, leaf, gen, timed=True)
            for name, ms in line["times"].items():
                layer[M][name] = layer[M].get(name, 0.0) + uses * ms
            if (M, K, N) in ((8, 4096, 14336), (512, 4096, 14336)):
                main[line["kernel"]] = line
        del leaf
        torch.cuda.empty_cache()
    for M in GEMM_ROWS:
        routed = route(M).__name__
        best = min(layer[M], key=layer[M].get)
        print(f"int8_linear M={M}: a layer's seven products (ms) "
              f"{json.dumps({k: round(v, 5) for k, v in layer[M].items()})}; routed to "
              f"{routed}, the faster: {best}", flush=True)
        if layer[M][routed] > layer[M][best] * (1 + ROUTE_SLACK):
            fail(f"int8_linear M={M}: routed to {routed} ({layer[M][routed]:.5f} ms a layer), "
                 f"{best} takes {layer[M][best]:.5f}")
    leaf = _int8_leaf(4096, 1024, gen, dead=77)
    if float(leaf["scale"].reshape(-1)[77]) != torch.tensor(1e-8).item():
        fail("int8_linear: the dead channel's scale is not the 1e-8 floor")
    for M in (8, 40, 512):
        x = torch.randn(M, 4096, generator=gen).to("cuda", torch.bfloat16)
        for name, call in _gemm_kernels(x, leaf).items():
            if call()[:, 77].any():
                fail(f"{name} M={M}: the dead channel is not exactly 0")
        _same_bits(f"int8_linear M={M} ({_plan(M, 1024, 4096)})",
                   lambda: int8_linear(x, leaf))
        _gemm_case(M, 4096, 1024, leaf, gen, timed=False)
    x = torch.randn(40, 4096, generator=gen).to("cuda", torch.bfloat16)
    big = _int8_leaf(4096, 14336, gen)
    _same_bits(f"int8_linear M=40 N=14336 ({_plan(40, 14336, 4096)})",
               lambda: int8_linear(x, big))
    x = torch.randn(512, 4096, generator=gen).to("cuda", torch.bfloat16)
    _same_bits(f"int8_linear M=512 N=14336 ({_plan(512, 14336, 4096)})",
               lambda: int8_linear(x, big))
    del big
    for exc, bad in ((TypeError, lambda: int8_linear(x.float(), leaf)),
                     (ValueError, lambda: int8_linear(x, {
                         "w8": leaf["w8"].contiguous(), "scale": leaf["scale"]}))):
        try:
            bad()
        except exc as e:
            print(f"int8_linear refuses: {e}", flush=True)
        else:
            fail(f"int8_linear did not raise {exc.__name__}")
    for K, N in QWEN_GEMM_SHAPES:
        leaf = _int8_leaf(K, N, gen)
        for M in (8, 40, 512):
            _gemm_case(M, K, N, leaf, gen, timed=False)
    del leaf
    torch.cuda.empty_cache()
    check_ptxas("w8a16_gemm.cu")
    print(f"int8_linear checked; card: {gpu_line()}", flush=True)
    return main


# Builds of w8a16_gemm.cu that report_w8a16_variants times beside the
# repo's, each without one part of the wgmma kernel's work (wrong sums;
# timing only): name -> (text, replacement) pairs.
_W8_FRAGMENT = """  a[0] = deq2_bf16(lds32(ra) ^ 0x80808080u, sel_lo, sel_hi, s0);
  a[1] = deq2_bf16(lds32(rb) ^ 0x80808080u, sel_lo, sel_hi, s1);
  a[2] = deq2_bf16(lds32(ra + 8) ^ 0x80808080u, sel_lo, sel_hi, s0);
  a[3] = deq2_bf16(lds32(rb + 8) ^ 0x80808080u, sel_lo, sel_hi, s1);
"""
_W8_RAW = "  a[0] = ra; a[1] = rb; a[2] = s0 ^ sel_lo; a[3] = s1 ^ sel_hi;\n"
_W8_MMA = "      wgmma_rs<BM>(acc, a[j & 1], desc(xs + 32 * j, 16, 1024));\n"
_W8_LOADS = """      tma_load(base + L::w + st * kWTileBytes, &w_map, full + 8 * st, k, n0);
      tma_load(base + L::x + st * L::kXBytes, &x_map, full + 8 * st, k, m0);
"""
W8A16_VARIANTS = {
    "no fragment loads or conversion": ((_W8_FRAGMENT, _W8_RAW),),
    "no TMA loads": ((_W8_LOADS, ""), ("mbar_expect_tx(full + 8 * st, kWTileBytes + L::kXBytes);",
                                       "mbar_arrive(full + 8 * st);")),
    "TMA loads only": ((_W8_FRAGMENT, _W8_RAW),
                       (_W8_MMA, "      acc[0] += __uint_as_float(a[j & 1][0]);\n")),
    "no wait in the loop": (("      wgmma_wait<1>();\n      fence_regs(acc);\n",
                             "      fence_regs(acc);\n"),),
}


def report_w8a16_variants() -> None:
    """The wgmma kernel against builds of w8a16_gemm.cu that each drop one
    part of its work (W8A16_VARIANTS: the A fragments' shared-memory loads
    and conversion, the TMA loads, everything but the TMA loads, the wait
    for the previous step's wgmma), at w_gate's shape for M 40, 512 and
    4096 and w_down's for 4096, timed from CUDA graphs in one process in
    turns (repo, variants, repo): how the card showed what bounds the
    kernel, where no profiler reads stalls. The variants' sums are wrong
    and not checked. Not part of the smoke's own run. Prints one line."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from kubeai_tpu_torch.ops import _build
    from kubeai_tpu_torch.ops.int8_matmul import w8a16_wgmma

    gen = torch.Generator().manual_seed(13)
    cases = {}
    for M, K, N in ((40, 4096, 14336), (512, 4096, 14336), (4096, 4096, 14336),
                    (4096, 14336, 4096)):
        leaf = _int8_leaf(K, N, gen)
        cases[f"M={M} K={K} N={N}"] = (torch.randn(M, K, generator=gen).to(
            "cuda", torch.bfloat16), leaf)
    kept = _build.CSRC, _build.BUILD_ROOT, _build._lib
    libs = {"repo": kept[2] or _build.load()}
    tmp = Path(tempfile.mkdtemp(prefix="w8a16_variants_"))
    try:
        for n, (name, edits) in enumerate(W8A16_VARIANTS.items()):
            src = tmp / str(n) / "csrc"
            shutil.copytree(kept[0], src)
            f = src / "w8a16_gemm.cu"
            text = f.read_text()
            for old, new in edits:
                if old not in text:
                    fail(f"w8a16 variant {name}: {old!r} not in the kernel's source")
                text = text.replace(old, new)
            f.write_text(text)
            _build.CSRC, _build.BUILD_ROOT, _build._lib = src, src.parent / "build", None
            libs[name] = _build.load()
        times: dict[str, dict[str, float]] = {}
        for name in ["repo", *W8A16_VARIANTS, "repo again"]:
            _build._lib = libs[name.replace(" again", "")]
            for key, (x, leaf) in cases.items():
                times.setdefault(key, {})[name] = graph_ms(lambda: w8a16_wgmma(x, leaf))
        print(f"w8a16_wgmma variants, ms from CUDA graphs: {json.dumps(times)}; card: "
              f"{gpu_line()}", flush=True)
    finally:
        _build.CSRC, _build.BUILD_ROOT, _build._lib = kept
        shutil.rmtree(tmp, ignore_errors=True)


# Rows at which report_w8a16_tiles sweeps the wgmma kernel's plans.
TILE_SWEEP_ROWS = (16, 40, 64, 96, 128, 200, 512, 1024)


def report_w8a16_tiles() -> None:
    """The wgmma kernel at every rows a CTA of WGMMA_ROWS up to the
    smallest that holds M (256 above) and every K split of SPLITS that
    leaves MIN_SPLIT_CHUNKS chunks a split, on Llama-3-8B's and
    Qwen2.5-0.5B's weight shapes at TILE_SWEEP_ROWS, each timed from CUDA
    graphs in three rounds in turns (median), beside the plan gemm_plan
    chooses: the data gemm_plan's cost model was fitted to. Not part of
    the smoke's own run. One line a case."""
    import torch

    from kubeai_tpu_torch.ops.int8_matmul import (
        K_MULTIPLE,
        MIN_SPLIT_CHUNKS,
        SPLITS,
        WGMMA,
        WGMMA_ROWS,
        _launch,
        gemm_plan,
    )

    gen = torch.Generator().manual_seed(17)
    for K, N in GEMM_SHAPES + QWEN_GEMM_SHAPES:
        leaf = _int8_leaf(K, N, gen)
        for M in TILE_SWEEP_ROWS:
            x = torch.randn(M, K, generator=gen).to("cuda", torch.bfloat16)
            top = next((b for b in WGMMA_ROWS if b >= M), WGMMA_ROWS[-1])
            plans = {(bm, z) for bm in WGMMA_ROWS if bm <= top for z in SPLITS
                     if z == 1 or K // K_MULTIPLE // z >= MIN_SPLIT_CHUNKS}
            calls = {f"{bm}/{z}": (lambda bm=bm, z=z: _launch(WGMMA, x, leaf, bm, z))
                     for bm, z in sorted(plans)}
            times = _alternating_ms(calls, 3)
            plan = "{}/{}".format(*gemm_plan(M, N, K))
            best = min(times, key=times.get)
            print(f"w8a16_wgmma tiles M={M} K={K} N={N}: plan {plan} {times[plan]:.5f} ms, "
                  f"best {best} {times[best]:.5f}; all {json.dumps(times)}", flush=True)
            del x, calls
        del leaf
        torch.cuda.empty_cache()
    print(f"w8a16_wgmma tiles swept; card: {gpu_line()}", flush=True)


def check_head_dim_256() -> dict:
    """B1, B4 and B1-int8 at head_dim 256 (Gemma), which no Llama shape
    runs: at Gemma-2-9B's shape (B=8, H=16, KVH=8, page 64, ragged lengths
    up to 8192, slot 0 the whole table, slot 1 one token) plain and with
    Gemma-2's window 4096 and softcap 50, timed as the 128 cases are, SDPA
    beside them on the same keys (with the window's mask; for B1-int8 on
    the dequantized pages, with a cold-L2 time); two calls and a
    CUDA-graph replay that must give the same bits; B1's and B1-int8's
    split edges and slots past the table and B4's split edges on the same
    pools (B1-int8's quantized by kv_quant.quantize_kv); then
    `check_head_dim_256_groups`. Returns the three plain cases' lines for
    the kernels line, keyed by KERNELS' head_dim-256 names."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_fused,
    )

    gen = torch.Generator().manual_seed(21)
    q, kp, vp, bt, lengths = _paged_inputs(gen, B=8, H=16, KVH=8, D=256, page=64,
                                           max_len=8192)
    B, H, D = q.shape
    measured = {}
    for cap, win in ((None, None), (50.0, 4096)):
        kw = dict(logit_softcap=cap, window=win)
        _, err = _check_decode_case(f"D=256 softcap={cap} window={win}",
                                    (q, kp, vp, bt, lengths), kw)
        line = _time_decode((q, kp, vp, bt, lengths), kw, library=True)
        line["max_abs_err"] = err
        measured.setdefault("paged_decode_attention_d256", dict(line))
        print("kernel paged_decode_attention B=%d H=%d KVH=8 D=%d page=64 max_len=%d %s" % (
            B, H, D, int(lengths.max()), json.dumps(line)), flush=True)
    args = (q, kp, vp, bt, lengths)
    _same_bits("paged_decode D=256", lambda: paged_decode_attention(
        *args, logit_softcap=50.0, window=4096))
    report_d256_split_caps(q, kp, vp, bt, lengths, gen)
    check_decode_split_edges(q, kp, vp, gen)
    check_decode_past_table(q, kp, vp, gen)

    # B1-int8 on the same pools quantized by kv_quant.quantize_kv, against
    # the plain version on the same int8 pages and scales.
    kq, vq = _quantize_pool(kp), _quantize_pool(vp)
    args = (q, kq, vq, bt, lengths)
    for cap, win in ((None, None), (50.0, 4096)):
        kw = dict(logit_softcap=cap, window=win)
        _, err = _check_decode_case(f"D=256 softcap={cap} window={win}", args, kw)
        line = _time_decode(args, kw, library=True)
        line["max_abs_err"] = err
        measured.setdefault("paged_decode_attention_int8_d256", dict(line))
        print("kernel paged_decode_attention_int8 B=%d H=%d KVH=8 D=%d page=64 max_len=%d %s"
              % (B, H, D, int(lengths.max()), json.dumps(line)), flush=True)
    _same_bits("paged_decode_int8 D=256", lambda: paged_decode_attention(
        *args, logit_softcap=50.0, window=4096))
    report_int8_d256_splits(q, kq, vq, bt, lengths, gen)
    check_decode_split_edges(q, kq, vq, gen)
    check_decode_past_table(q, kq, vq, gen)
    del kq, vq, args

    # B4 on a 2-layer stacked pool (layer 1) of the same keys: old lengths
    # are B1's lengths less the new token.
    kp2, vp2 = torch.stack([vp, kp]), torch.stack([kp, vp])
    del kp, vp
    cg = torch.Generator("cuda").manual_seed(22)
    kn, vn = (torch.randn(B, 8, D, generator=cg, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    pos = (lengths - 1).to(torch.int32)
    args = (q, kp2, vp2, kn, vn, bt, pos, 1)
    for cap, win in ((None, None), (50.0, 4096)):
        kw = dict(logit_softcap=cap, window=win)
        _, err = _check_fused_case(f"D=256 softcap={cap} window={win}", args, kw)
        line = _time_fused(args, kw, library=True)
        line["max_abs_err"] = err
        measured.setdefault("paged_decode_attention_fused_d256", dict(line))
        print("kernel paged_decode_attention_fused NL=2 layer=1 B=%d H=%d KVH=8 D=%d "
              "page=64 positions<=%d %s" % (B, H, D, int(pos.max()), json.dumps(line)),
              flush=True)
    _same_bits("paged_fused D=256", lambda: paged_decode_attention_fused(
        *args, logit_softcap=50.0, window=4096))
    check_fused_split_edges(q, kp2, vp2, kn, vn, 1, gen)
    del kp2, vp2, args
    torch.cuda.empty_cache()
    check_head_dim_256_groups()
    return measured


def report_d256_split_caps(q, kp, vp, bt, lengths, gen) -> None:
    """B1 at head_dim 256 from a CUDA graph with its splits capped at 256,
    512 and 1,024 tokens (`paged_attention._D256_MAX_SPLIT_TOKENS`), plain
    and with window 4096 + softcap 50, on the kernel phase's slots (8,
    ragged up to 8192) and on the served Gemma-2-9B run's contexts (60,
    349, 1,132 and 4,232 tokens and four 1-token slots, in the same
    128-page table): the measurement the cap (512) was chosen from.
    Prints one line a shape."""
    import torch

    from kubeai_tpu_torch.ops import paged_attention as pa

    served = torch.tensor([60, 349, 1132, 4232, 1, 1, 1, 1])
    shapes = {"kernel phase": (bt, lengths),
              "served": (_table(served.tolist(), 64, bt.shape[1], gen).to("cuda"),
                         served.to("cuda", torch.int32))}
    kept = pa._D256_MAX_SPLIT_TOKENS
    try:
        for label, (table, n) in shapes.items():
            times = {}
            for cap in (256, 512, 1024):
                pa._D256_MAX_SPLIT_TOKENS = cap
                for softcap, win in ((None, None), (50.0, 4096)):
                    times[f"cap {cap} softcap={softcap} window={win}"] = graph_ms(
                        lambda: pa.paged_decode_attention(q, kp, vp, table, n,
                                                          logit_softcap=softcap, window=win))
            print(f"paged_decode D=256 split caps, {label} (lengths {n.tolist()}): ms "
                  f"{json.dumps(times)}", flush=True)
    finally:
        pa._D256_MAX_SPLIT_TOKENS = kept


def report_int8_d256_splits(q, kp, vp, bt, lengths, gen) -> None:
    """B1-int8 at head_dim 256 from a CUDA graph with the split's CTA
    target for several slots (`paged_attention._INT8_TARGET_CTAS`, which
    D = 128 shares) at 2, 4 and 8 x 132 and its cap at 128, 256, 512,
    1,024 and 4,096 tokens (`_INT8_D256_MAX_SPLIT_TOKENS`; 4,096 is the
    walk's own 64 entries), plain and with window 4096 + softcap 50, on
    the kernel phase's slots and on the served Gemma-2-9B contexts, as
    `report_d256_split_caps` does for B1: the measurement the two were
    chosen from. Prints one line a shape."""
    import torch

    from kubeai_tpu_torch.ops import paged_attention as pa

    served = torch.tensor([60, 349, 1132, 4232, 1, 1, 1, 1])
    shapes = {"kernel phase": (bt, lengths),
              "served": (_table(served.tolist(), 64, bt.shape[1], gen).to("cuda"),
                         served.to("cuda", torch.int32))}
    kept = pa._INT8_TARGET_CTAS, pa._INT8_D256_MAX_SPLIT_TOKENS
    try:
        for label, (table, n) in shapes.items():
            times = {}
            for waves in (2, 4, 8):
                for cap in (128, 256, 512, 1024, 4096):
                    pa._INT8_TARGET_CTAS, pa._INT8_D256_MAX_SPLIT_TOKENS = waves * 132, cap
                    split = pa.int8_split(table.shape[0], kp.shape[2], table.shape[1], 64, 256)
                    for softcap, win in ((None, None), (50.0, 4096)):
                        times[f"{waves}x132 cap {cap} {split} softcap={softcap} "
                              f"window={win}"] = graph_ms(
                            lambda: pa.paged_decode_attention(
                                q, kp, vp, table, n, logit_softcap=softcap, window=win))
            print(f"paged_decode_int8 D=256 splits, {label} (lengths {n.tolist()}): ms "
                  f"{json.dumps(times)}", flush=True)
    finally:
        pa._INT8_TARGET_CTAS, pa._INT8_D256_MAX_SPLIT_TOKENS = kept


# One-constant changes of csrc/paged_split_walk_int8.cuh that
# `report_int8_d256_variants` times against the repo's build.
INT8_D256_VARIANTS = {
    "K rows unswizzled at D=256": ("kSwizzle = D >= 128 ? 4 : 0", "kSwizzle = D == 128 ? 4 : 0"),
    "4-deep ring (one CTA an SM)": ("constexpr int kStagesD256 = 3;",
                                    "constexpr int kStagesD256 = 4;"),
}


def report_int8_d256_variants() -> None:
    """B1-int8 at head_dim 256 against builds of its walk that each change
    one constant of paged_split_walk_int8.cuh (INT8_D256_VARIANTS): K
    rows without the swizzle (the score's reads of rows gq and gq + 1 on
    the same banks) and a 4-deep ring. Each variant's csrc/ is a copy
    under a temporary directory, built by `_build` and loaded in place of
    the repo's library for its turn; the wrapper and its split are the
    repo's. Timed from CUDA graphs in one process, in turns (repo,
    variants, repo), on the kernel phase's Gemma-2-9B case and the
    served contexts, plain and with window 4096 + softcap 50, each
    variant's output checked against the repo build's: how the swizzle
    and the ring depth were checked on the card, where no profiler reads
    bank conflicts. Not part of the smoke's own run. Prints one line."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from kubeai_tpu_torch.ops import _build
    from kubeai_tpu_torch.ops.paged_attention import paged_decode_attention

    gen = torch.Generator().manual_seed(21)
    q, kp, vp, bt, lengths = _paged_inputs(gen, B=8, H=16, KVH=8, D=256, page=64,
                                           max_len=8192)
    kq, vq = _quantize_pool(kp), _quantize_pool(vp)
    del kp, vp
    served = torch.tensor([60, 349, 1132, 4232, 1, 1, 1, 1])
    cases = {"kernel phase": (bt, lengths),
             "served": (_table(served.tolist(), 64, bt.shape[1], gen).to("cuda"),
                        served.to("cuda", torch.int32))}
    kept = _build.CSRC, _build.BUILD_ROOT, _build._lib
    libs = {"repo": kept[2] or _build.load()}
    tmp = Path(tempfile.mkdtemp(prefix="int8_variants_"))
    try:
        for name, (old, new) in INT8_D256_VARIANTS.items():
            src = tmp / name.split()[0] / "csrc"
            shutil.copytree(kept[0], src)
            header = src / "paged_split_walk_int8.cuh"
            text = header.read_text()
            if old not in text:
                fail(f"int8 variant {name}: {old!r} not in the walk's source")
            header.write_text(text.replace(old, new))
            _build.CSRC, _build.BUILD_ROOT, _build._lib = src, src.parent / "build", None
            t0 = time.perf_counter()
            libs[name] = _build.load()
            print(f"int8 variant {name}: built in {time.perf_counter() - t0:.2f} s", flush=True)
            for entry, regs, spills in ptxas_report("paged_decode.cu"):
                if "int8" in entry and "Li256E" in entry:
                    print(f"  ptxas {entry[:60]}: {regs} registers, {spills} bytes spilled",
                          flush=True)
        times: dict[str, float] = {}
        want = {}
        for name in ["repo", *INT8_D256_VARIANTS, "repo again"]:
            _build._lib = libs[name.replace(" again", "")]
            for label, (table, n) in cases.items():
                for cap, win in ((None, None), (50.0, 4096)):
                    def call():
                        return paged_decode_attention(q, kq, vq, table, n,
                                                      logit_softcap=cap, window=win)
                    key = f"{label} softcap={cap} window={win}"
                    out = call()
                    torch.cuda.synchronize()
                    if key in want:
                        compare(f"int8 variant {name} {key}", out, want[key], PAGED_ATOL,
                                PAGED_RTOL)
                    else:
                        want[key] = out
                    times[f"{name}: {key}"] = graph_ms(call)
        print(f"paged_decode_int8 D=256 variants, ms from CUDA graphs: {json.dumps(times)}",
              flush=True)
    finally:
        _build.CSRC, _build.BUILD_ROOT, _build._lib = kept
        shutil.rmtree(tmp, ignore_errors=True)


# Builds of flash_prefill.cu that report_flash_d256_registers compiles
# beside the repo's: name -> ((text, replacement) pairs, extra nvcc flags).
_UNIFORM_WG = "const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);"
FLASH_D256_PROBES = {
    "no setmaxnreg": ((
        ('asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));', ""),
        ('asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));', ""),
    ), ()),
    "wg = threadIdx.x / 128": (((_UNIFORM_WG, "const int wg = threadIdx.x / 128;"),), ()),
    "a trap in every wait": ((("mbar_wait<false>", "mbar_wait<true>"),), ()),
    "setmaxnreg 24 / 240": ((("constexpr int kProducerRegs = 40;", "constexpr int kProducerRegs = 24;"),
                             ("constexpr int kConsumerRegs = 232;", "constexpr int kConsumerRegs = 240;")), ()),
    "__launch_bounds__(kThreads)": (
        (("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads)"),), ()),
    "-maxrregcount=232": ((), ("-maxrregcount=232",)),
    "consumer in an else branch": ((
        ("    return;\n  }\n\n  // Consumer warpgroup c", "  } else {\n  // Consumer warpgroup c"),
        ("  }\n}\n\n// ---- host", "  }\n  }\n}\n\n// ---- host")), ()),
}


def _sass_stats(obj, nvcc: str) -> dict:
    """Per kernel of an object file: the highest register its SASS names,
    its local-memory loads and stores (spills), and its USETMAXREG lines,
    from cuobjdump."""
    from pathlib import Path

    tool = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(obj)], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    stats, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            stats[name] = {"max_register": -1, "local_ld_st": 0, "setmaxreg": []}
        elif name:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            if regs:
                stats[name]["max_register"] = max(stats[name]["max_register"], *regs)
            if re.search(r"\b(LDL|STL)\b", line):
                stats[name]["local_ld_st"] += 1
            if "SETMAXREG" in line:
                stats[name]["setmaxreg"].append(line.split("*/")[1].split(";")[0].strip()
                                                if "*/" in line else line.strip())
    return stats


def report_flash_d256_registers(parent_csrc: str | None = None) -> None:
    """How ptxas gives B2's head_dim-256 consumers their registers: compiles
    csrc/flash_prefill.cu with `_build`'s flags as it is, and as each of
    FLASH_D256_PROBES changes it (and `parent_csrc`'s flash_prefill.cu,
    an earlier build, if given), all at once in a temporary directory;
    prints for every <256> kernel ptxas's registers, spills and any
    warning, and from the SASS the highest register named, the
    local-memory accesses and the setmaxnreg instructions. A consumer
    path that names registers past the launch's 168 was given them by
    setmaxnreg.inc. Not part of the smoke's own run."""
    import shutil
    import tempfile
    from pathlib import Path

    from kubeai_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    text = (_build.CSRC / "flash_prefill.cu").read_text()
    builds = {"repo": (text, ())}
    for name, (pairs, flags) in FLASH_D256_PROBES.items():
        t = text
        for old, new in pairs:
            if old not in t:
                fail(f"flash probe {name}: {old!r} not in flash_prefill.cu")
            t = t.replace(old, new)
        builds[name] = (t, flags)
    if parent_csrc:
        builds["parent"] = ((Path(parent_csrc) / "flash_prefill.cu").read_text(), ())
    tmp = Path(tempfile.mkdtemp(prefix="flash_probe_"))
    try:
        procs = {}
        for i, (name, (t, flags)) in enumerate(builds.items()):
            src = tmp / f"probe{i}.cu"
            src.write_text(t)
            cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-c", str(src),
                   "-o", str(tmp / f"probe{i}.o")]
            procs[name] = (tmp / f"probe{i}.o", subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (obj, proc) in procs.items():
            log, _ = proc.communicate()
            print(f"flash probe {name}: nvcc exit {proc.returncode}", flush=True)
            keep, in256 = [], False
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    in256 = "Li256E" in line
                if in256 or "warning" in line.lower() or "error" in line.lower():
                    keep.append(line.strip())
            for line in keep:
                print(f"  {line}", flush=True)
            if proc.returncode == 0:
                for fn, st in _sass_stats(obj, nvcc).items():
                    if "Li256E" in fn:
                        print(f"  sass {fn}: {json.dumps(st)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Builds of flash_prefill.cu that report_flash_d256_variants times beside
# the repo's: name -> (text, replacement).
FLASH_D256_VARIANTS = {
    "no ping-pong": ("constexpr bool kPingPong = D == 256;", "constexpr bool kPingPong = false;"),
}


def report_flash_d256_variants(parent_csrc: str | None = None) -> None:
    """B2 at head_dim 256 against builds of csrc/ that each change one line
    of flash_prefill.cu (FLASH_D256_VARIANTS), and against `parent_csrc`
    (an earlier csrc/, same C entry) if given, on every case of
    check_flash_prefill_d256 and three head_dim-128 ones. Each build is a
    copy under a temporary directory, built by `_build` and loaded in place
    of the repo's library for its turn. Timed from CUDA graphs in one
    process, in turns (parent, repo, variants, repo, variants, repo,
    parent), SDPA beside
    them; every build's output is held against the plain version at
    FLASH_ATOL / FLASH_RTOL. Not part of the smoke's own run. Prints one
    line a case."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch
    import torch.nn.functional as F

    from kubeai_tpu_torch.ops import _build
    from kubeai_tpu_torch.ops.attention import causal_prefill_attention
    from kubeai_tpu_torch.ops.flash_attention import flash_causal_prefill

    kept = _build.CSRC, _build.BUILD_ROOT, _build._lib
    libs = {"repo": kept[2] or _build.load()}
    tmp = Path(tempfile.mkdtemp(prefix="flash_variants_"))
    try:
        sources = {name: (old, new) for name, (old, new) in FLASH_D256_VARIANTS.items()}
        if parent_csrc:
            sources["parent"] = None
        for name, change in sources.items():
            src = tmp / name.replace(" ", "_") / "csrc"
            shutil.copytree(kept[0] if change else Path(parent_csrc), src)
            if change:
                f = src / "flash_prefill.cu"
                text = f.read_text()
                if change[0] not in text:
                    fail(f"flash variant {name}: {change[0]!r} not in flash_prefill.cu")
                f.write_text(text.replace(*change))
            _build.CSRC, _build.BUILD_ROOT, _build._lib = src, src.parent / "build", None
            t0 = time.perf_counter()
            libs[name] = _build.load()
            print(f"flash variant {name}: built in {time.perf_counter() - t0:.2f} s", flush=True)
            for entry, regs, spills in ptxas_report("flash_prefill.cu"):
                print(f"  ptxas {entry[:60]}: {regs} registers, {spills} bytes spilled",
                      flush=True)
        order = ["repo", *FLASH_D256_VARIANTS] * 2 + ["repo"]
        if parent_csrc:
            order = ["parent", *order, "parent"]
        gen = torch.Generator().manual_seed(26)
        cases = [(16, 16, 1, S, 256) for S in (32, 128, 160, 200, 512, 1024, 2048, 8192)]
        cases += [(16, 16, 4, 1024, 256), (8, 1, 1, 512, 256), (8, 1, 1, 8192, 256)]
        cases += [(32, 8, 1, 512, 128), (32, 8, 4, 1024, 128), (32, 8, 1, 8192, 128)]
        for H, KVH, B, S, D in cases:
            mk = lambda h: torch.randn(B, S, h, D, generator=gen, device="cpu").to(  # noqa: E731
                "cuda", torch.bfloat16)
            q, k, v = mk(H), mk(KVH), mk(KVH)
            want = causal_prefill_attention(q, k, v)
            times: dict[str, list] = {}
            for name in order:
                _build._lib = libs[name]
                call = lambda: flash_causal_prefill(q, k, v)  # noqa: E731
                if name not in times:
                    compare(f"flash variant {name} B={B} S={S} H={H} D={D}", call(), want,
                            FLASH_ATOL, FLASH_RTOL)
                times.setdefault(name, []).append(graph_ms(call))
            del want
            torch.cuda.empty_cache()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            times["sdpa"] = [graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))]
            flops = 4.0 * B * H * D * S * (S + 1) / 2
            print(f"flash variants B={B} S={S} H={H} KVH={KVH} D={D} "
                  f"(useful {flops:.4g} flops), ms from CUDA graphs: {json.dumps(times)}",
                  flush=True)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
        print(f"flash variants card: {gpu_line()}", flush=True)
    finally:
        _build.CSRC, _build.BUILD_ROOT, _build._lib = kept
        shutil.rmtree(tmp, ignore_errors=True)


def _same_bits(name: str, call) -> None:
    """Two eager calls, and one call captured in a CUDA graph and
    replayed, give the same bits."""
    import torch

    first = call()
    if not torch.equal(first, call()):
        fail(f"{name}: two calls on the same inputs differ")
    graph, captured = capture(call)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(captured, first):
        fail(f"{name}: the CUDA-graph replay differs from the eager call")
    print(f"{name}: two eager calls bit-identical; CUDA-graph replay equals the eager "
          "call", flush=True)


def check_head_dim_256_groups() -> None:
    """B1, B4 and B1-int8 at head_dim 256 for both group builds: G = 1
    (Gemma-7B: 16 q heads over 16 kv heads, MG 4), G = 2 (Gemma-2-9B: 16
    over 8, MG 4) and G = 8 (Gemma-2B: 8 over 1, MG 8), at B=4 with
    lengths up to 4608, plain, softcap 50, window 100, window 4096, and
    softcap 50 + window 4096; B1-int8 on the layer-0 pools quantized by
    kv_quant.quantize_kv. No timing."""
    import torch

    from kubeai_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_fused,
        ref_paged_decode_attention,
    )

    B, D, page, max_len = 4, 256, 64, 4608
    mp = max_len // page
    gen = torch.Generator().manual_seed(23)
    lengths = torch.tensor([max_len, 1, 4100, 777])
    bt = _table(lengths.tolist(), page, mp, gen).to("cuda")
    n = lengths.to("cuda", torch.int32)
    cg = torch.Generator("cuda").manual_seed(24)

    def rnd(*shape):
        return torch.randn(*shape, generator=cg, device="cuda").to(torch.bfloat16)

    errs, errs8 = [], []
    for H, KVH in ((16, 16), (16, 8), (8, 1)):
        kp, vp = rnd(2, 1 + B * mp, page, KVH, D), rnd(2, 1 + B * mp, page, KVH, D)
        kq, vq = _quantize_pool(kp[0]), _quantize_pool(vp[0])
        q, kn, vn = rnd(B, H, D), rnd(B, KVH, D), rnd(B, KVH, D)
        for cap, win in ((None, None), (50.0, None), (None, 100), (None, 4096),
                         (50.0, 4096)):
            kw = dict(logit_softcap=cap, window=win)
            tag = f"D=256 G={H // KVH} softcap={cap} window={win}"
            got = paged_decode_attention(q, kp[0], vp[0], bt, n, **kw)
            errs.append(compare(f"paged_decode {tag}", got, ref_paged_decode_attention(
                q, kp[0], vp[0], bt, n, **kw), PAGED_ATOL, PAGED_RTOL))
            errs.append(_check_fused_case(tag, (q, kp, vp, kn, vn, bt, n - 1, 1), kw)[1])
            errs8.append(_check_decode_case(tag, (q, kq, vq, bt, n), kw)[1])
    print(f"kernels at head_dim 256 (B1, B4; G 1, 2, 8 x plain, softcap 50, window 100, "
          f"window 4096, softcap 50 + window 4096): max |err| "
          f"{['%.3e' % e for e in errs]}", flush=True)
    print(f"paged_decode_int8 at head_dim 256 (G 1, 2, 8 x the same five cases): max |err| "
          f"{['%.3e' % e for e in errs8]}", flush=True)


def phase_kernels() -> dict:
    measured = {
        "paged_decode_attention": check_paged_decode(),
        "flash_causal_prefill": check_flash_prefill(),
        "paged_verify_attention": check_paged_verify(),
        "paged_decode_attention_fused": check_paged_fused(),
        "paged_decode_attention_int8": check_paged_decode(int8=True),
    }
    check_head_dim_64()
    measured["flash_causal_prefill_d64"] = check_qwen_heads()
    measured["flash_causal_prefill_d64_g4"] = check_draft_heads()
    measured.update(check_head_dim_256())
    measured["flash_causal_prefill_d256"] = check_flash_prefill_d256()
    measured.update(check_int8_gemm())
    check_rank_local_kernels()
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
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=REQUEST_TIMEOUT_S)
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
                       ("propose chain", engine._draft_propose_program),
                       ("draft catch-up", engine._draft_catchup_program),
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


# The engine's admission functions: a serve run counts each call and the
# B2 launches it made (the target's batched or slot-cache admission, its
# slot-cache chunked admission, the draft model's admission).
ADMIT_FUNCTIONS = ("_prefill_admit", "_prefill_admit_slot", "_admit_chunked", "_draft_admit")


def serve_run(params, cfg, label: str, waves=None, adapters=None, family: str = "llama",
              config: dict = SERVE_CONFIG, side=None, draft=None, **extra) -> dict:
    """One EngineServer run over `params` with the engine's defaults (graphs
    and overlap): a warm-up request, then each wave of chat completions
    (default: `_default_bodies`) sent concurrently, a wave only after the
    one before it has finished, with every kernel's launch count and every
    device program's replay count set to 0 just before the first wave and
    read just after the last. `family` names the model family and
    `config` the EngineConfig (default: the 8B smoke's), which `extra` adds to;
    `adapters` ({name: LoRA weight tree}) are loaded, in order, after the
    engine captured its programs, and a body names one in its `model`;
    `draft` ((config, params)) is the engine's draft model.
    `side(port)`, when given, runs in a thread beside the waves (started
    with the first, joined after the last), and its launches count with
    theirs; an exception in it fails the run.
    Returns the launches (eager calls plus launches per replay x
    replays), each request's prompt, sampling params, adapter, engine
    token stream and TTFT, the rids of each wave, the calls of the
    staged-chunk functions made outside their programs, the whole-prompt
    prefill admissions, the B2 launches of each call of ADMIT_FUNCTIONS,
    and the engine."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.fleet.profiler import phase_totals

    tok = ByteTokenizer()
    t0 = time.perf_counter()
    engine = Engine(family, cfg, params, cfg=EngineConfig(**config, **extra),
                    eos_token_ids=tok.eos_token_ids, draft=draft)
    if not engine._overlap:
        fail(f"serve {label}: the default engine does not overlap its steps")
    for name, prog in _programs(engine).items():
        if prog.graph is None:
            fail(f"serve {label}: the {name} is not a CUDA graph on the card")
        print(f"serve {label} {name} graph: captured at construction (engine built in "
              f"{time.perf_counter() - t0:.2f} s); pool reserved "
              f"{prog.pool_bytes / 2**20:.2f} MiB; launches per replay "
              f"{json.dumps(prog.launches_per_replay)}", flush=True)
    adapters = dict(adapters or {})
    for name, weights in adapters.items():
        engine.load_adapter(name, weights)
    requests: dict[int, tuple] = {}  # rid -> (prompt, sampling params)
    adapter_of: dict[int, str | None] = {}  # rid -> its adapter
    add_request = engine.add_request

    def add_and_note(prompt, params, *a, **kw):
        rid = add_request(prompt, params, *a, **kw)
        requests[rid] = (list(prompt), params)
        adapter_of[rid] = kw.get("adapter")
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
    # The slot each request was admitted to (the last admission's, for a
    # preempted one).
    slot_of: dict[int, int] = {}
    finish_admission = engine._finish_admission

    def admit_and_note(req, slot, *a, **kw):
        slot_of[req.rid] = slot
        return finish_admission(req, slot, *a, **kw)

    engine._finish_admission = admit_and_note
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
    # The B2 launches of each admission call, by function.
    admit_b2: dict[str, list[int]] = {}
    b2 = _wrappers()["flash_causal_prefill"]
    for attr in ADMIT_FUNCTIONS:
        def admit_and_count(*a, fn=getattr(engine, attr), attr=attr, **kw):
            before = b2.launches
            out = fn(*a, **kw)
            admit_b2.setdefault(attr, []).append(b2.launches - before)
            return out
        setattr(engine, attr, admit_and_count)
    wrappers = _wrappers()
    server = EngineServer(engine, tok, f"{family}-smoke", port=0)
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
        adapter_of.clear()
        stage_calls.clear()
        admit_b2.clear()
        waves = waves or _default_bodies()
        bodies = [body for wave in waves for body in wave]
        max_tokens = bodies[0]["max_tokens"]
        results: list = [None] * len(bodies)

        def run(i):
            results[i] = _post(server.port, bodies[i])

        _zero_launches(engine)
        first_step = engine.profiler.steps_completed
        wave_rids: list[list[int]] = []
        side_errors: list = []

        def run_side():
            try:
                side(server.port)
            except BaseException as e:  # noqa: BLE001 — failed below, on this thread
                side_errors.append(e)

        side_thread = threading.Thread(target=run_side) if side else None
        t_start = time.perf_counter()
        if side_thread:
            side_thread.start()
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
        if side_thread:
            side_thread.join()
        wall = time.perf_counter() - t_start
        eager = {name: fn.launches for name, fn in wrappers.items()}
        replayed = {name: 0 for name in wrappers}
        for prog in _programs(engine).values():
            for name, n in prog.launches().items():
                replayed[name] += n
        dispatches = {name: prog.dispatches for name, prog in _programs(engine).items()}
    finally:
        server.stop()
    if side_errors:
        fail(f"serve {label}: the traffic beside the waves failed: {side_errors[0]!r}")
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
                 "paged_decode_attention_fused", "paged_decode_attention_int8"):
        if eager[name]:
            fail(f"serve {label}: {name} launched {eager[name]} times outside the "
                 "graph replays")
    # Each request's prompt length and adapter are distinct: they name the
    # request.
    index_of = {(len(tok.apply_chat_template(b["messages"])), b.get("model")): i
                for i, b in enumerate(bodies)}
    rid_of = {index_of[len(prompt), adapter_of[rid]]: rid
              for rid, (prompt, _) in requests.items()}
    return {"launches": launches, "requests": requests, "streams": streams,
            "engine": engine, "bodies": bodies, "rid_of": rid_of, "ttft": ttft,
            "waves": wave_rids, "stage_calls": dict(stage_calls),
            "admissions": len(admit_b2.get("_prefill_admit", []))
            + len(admit_b2.get("_prefill_admit_slot", [])),
            "admit_b2": admit_b2, "draft": draft, "slot_of": dict(slot_of),
            "dispatches": dispatches, "adapters": dict(adapter_of),
            "adapter_weights": adapters, "family": family, "config": config}


def check_streams_equal_eager(params, cfg, label: str, run: dict, adapters=None, **extra):
    """The serve run's streams, greedy and seeded, against an eager
    synchronous engine (no graphs, step_overlap="off") on the same weights
    (and the run's draft model) fed the same prompts, sampling params, adapters (loaded first, in the
    run's order; `adapters` replaces them) and continuation prefixes (a
    request's optional third item), wave by wave as the run sent them.
    Any difference fails, with the first differing step. Returns the
    reference engine."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig

    class EagerEngine(Engine):
        _capture_graphs = False

    ref = EagerEngine(run.get("family", "llama"), cfg, params, cfg=EngineConfig(
        **run.get("config", SERVE_CONFIG), step_overlap="off", **extra),
        eos_token_ids=run["engine"].eos_token_ids, draft=run.get("draft"))
    if ref._overlap or ref._decode_program.graph is not None:
        fail(f"serve {label}: the reference engine is not eager and synchronous")
    if adapters is None:
        adapters = run.get("adapter_weights") or {}
    for name, weights in adapters.items():
        ref.load_adapter(name, weights)
    adapter_of = run.get("adapters") or {}
    rids: dict[int, int] = {}
    got: dict[int, list[int]] = {rid: [] for wave in run["waves"] for rid in wave}
    t0 = time.perf_counter()
    for wave in run["waves"]:
        for rid in wave:
            prompt, sp, *resume = run["requests"][rid]
            rids[ref.add_request(prompt, sp, resume_tokens=resume[0] if resume else None,
                                 adapter=adapter_of.get(rid))] = rid
        while ref.has_work():
            for ev in ref.step():
                got[rids[ev.rid]].append(ev.token)
    for rid, want in sorted(got.items()):
        have = run["streams"][rid]
        _, sp, *resume = run["requests"][rid]
        kind = "greedy" if sp.temperature == 0 else f"seeded (seed {sp.seed})"
        if adapter_of.get(rid):
            kind += f", adapter {adapter_of[rid]}"
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


def timed(name: str, fn, *args, **kw):
    """fn(*args, **kw), with its seconds printed on a line of their own;
    its start and end also go to stderr, whose tail then names the phase
    that a stalled run was in."""
    print(f"phase {name}: started", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    line = f"phase {name}: {time.perf_counter() - t0:.2f} s"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    return out


# The llama runs that PERF.md's tables do not compare against serve the
# 8B width at this depth (`shallow`): the continuations, disaggregation,
# KV sharing, int8 pools and LoRA, with their bf16 baselines
# (`shallow_baselines`) at the same depth. The per_layer, speculate, fused
# and prefix runs keep all 32 layers.
SHALLOW_LAYERS = 8


def shallow(params: dict, cfg, num_layers: int = SHALLOW_LAYERS):
    """The first `num_layers` layers of the llama `params` (views: no
    copy) and the config cut to them."""
    import dataclasses

    layers = {name: w[:num_layers] for name, w in params["layers"].items()}
    return {**params, "layers": layers}, dataclasses.replace(cfg, num_layers=num_layers)


def shallow_baselines(params, cfg) -> tuple[dict, dict]:
    """The bf16 decode step and verify window, without adapters, of
    engines at `cfg`'s depth that generated the four default prompts:
    what serve_int8 and serve_lora compare against (`profile_program`)."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    prompts = [tok.apply_chat_template(b["messages"]) for b in _default_bodies()[0]]
    out = []
    for unit, program, extra in (
            ("decode step", "decode chunk", dict(decode_kernel="per_layer")),
            ("verify window", "verify window",
             dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False))):
        engine = Engine("llama", cfg, params, cfg=EngineConfig(**SERVE_CONFIG, **extra),
                        eos_token_ids=tok.eos_token_ids)
        engine.generate(prompts, SamplingParams(temperature=0.0, max_tokens=32))
        out.append(profile_program(engine, f"{cfg.num_layers}-layer {unit}", program))
        del engine
        free({})
    return out[0], out[1]


def phase_serve() -> dict:
    params, cfg = serve_weights()
    layout_gaps(params, cfg)
    launches = {}
    # Run 1: the per_layer layout, passed explicitly so that the env var
    # cannot flip it. B1 and B2 must launch.
    t0 = time.perf_counter()
    extra = dict(decode_kernel="per_layer")
    run = serve_run(params, cfg, "per_layer", **extra)
    for name in ("paged_decode_attention", "flash_causal_prefill"):
        if run["launches"][name] <= 0:
            fail(f"serve per_layer: main path never launched {name}")
        launches[name] = run["launches"][name]
    check_streams_equal_eager(params, cfg, "per_layer", run, **extra)
    base = {i: run["streams"][rid] for i, rid in run["rid_of"].items()}
    bf16 = {"per_layer": profile_program(run["engine"], "decode step", "decode chunk")}
    profile_prefill(params, cfg)
    free(run)
    print(f"phase serve per_layer: {time.perf_counter() - t0:.2f} s", flush=True)
    # Run 2: prompt-lookup speculation in every decode call. B3 launches,
    # B1 does not.
    t0 = time.perf_counter()
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
    bf16["speculate"] = profile_program(run["engine"], "verify window", "verify window")
    free(run)
    print(f"phase serve speculate: {time.perf_counter() - t0:.2f} s", flush=True)
    # Run 3: the fused layout. B4 launches, B1 does not.
    t0 = time.perf_counter()
    extra = dict(decode_kernel="fused")
    run = serve_run(params, cfg, "fused", **extra)
    if run["launches"]["paged_decode_attention_fused"] <= 0:
        fail("serve fused: main path never launched paged_decode_attention_fused")
    if run["launches"]["paged_decode_attention"] != 0:
        fail("serve fused: paged_decode_attention launched in a fused run")
    launches["paged_decode_attention_fused"] = run["launches"]["paged_decode_attention_fused"]
    check_streams_equal_eager(params, cfg, "fused", run, **extra)
    report_agreement("fused", base, run)
    bf16["fused"] = profile_program(run["engine"], "fused decode step", "decode chunk")
    free(run)
    print(f"phase serve fused: {time.perf_counter() - t0:.2f} s", flush=True)
    # The same three runs on int8 layer weights (the W8A16 kernel).
    launches.update(timed("serve_int8_weights", serve_int8_weights, params, cfg, bf16, base))
    # Run 4: chunked prefill and the prefix cache. B1 and B2 launch.
    timed("serve_prefix", serve_prefix, params, cfg)
    # Run 5: the 8B (as Llama-3.1) with a Llama-3.2-1B draft. B3 and B2
    # (both models' admissions) launch, B1 does not.
    launches.update(timed("serve_draft", serve_draft, params, cfg))
    # The rest at SHALLOW_LAYERS, full width.
    params, cfg = shallow(params, cfg)
    bf16_step, bf16_verify = timed(f"bf16 baselines at {cfg.num_layers} layers",
                                   shallow_baselines, params, cfg)
    # The slot cache, whole-prompt and chunked. B2 launches on every
    # whole-prompt admission.
    timed("serve_slot", serve_slot, params, cfg, bf16_step)
    timed("serve_resume", serve_resume, params, cfg)
    # Disaggregated prefill/decode (B2 on the prefill side, B1 and B4 on
    # the decode side) and the KV-sharing tier.
    timed("serve_disagg", serve_disagg, params, cfg)
    timed("serve_kv_share", serve_kv_share, params, cfg)
    # Int8 KV pools: the per_layer serve run, a prefix run and a
    # prefill/decode pair, each on int8 pools. B1's int8 read launches,
    # bf16 B1 does not.
    launches["paged_decode_attention_int8"] = timed("serve_int8", serve_int8, params, cfg,
                                                    bf16_step)
    timed("serve_prefix int8", serve_prefix, params, cfg, int8=True)
    timed("serve_disagg_int8", serve_disagg_int8, params, cfg)
    # LoRA adapters through every decode, verify and prefill path, and a
    # hot swap under the captured graphs.
    timed("serve_lora", serve_lora, params, cfg, bf16_step, bf16_verify)
    return launches


# ---- serve_int8_weights: int8 layer weights on the 8B -----------------------------

# The catalog's llama-3.1-8b-instruct-int8-tpu (catalog/models.yaml:193-201)
# runs `--quantization int8`: the smoke's 32-layer 8B weights quantized on
# the card, served in each layout (label, EngineConfig additions, the
# attention kernel that must launch, the device program profiled).
INT8_WEIGHT_RUNS = (
    ("per_layer", dict(decode_kernel="per_layer"), "paged_decode_attention", "decode chunk"),
    ("fused", dict(decode_kernel="fused"), "paged_decode_attention_fused", "decode chunk"),
    ("speculate", dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False),
     "paged_verify_attention", "verify window"),
)
# Name fragments of the library's GEMM kernels in a profile (cuBLAS on
# Hopper: nvjet; older builds: gemm, xmma, cutlass).
LIBRARY_GEMMS = ("nvjet", "gemm", "xmma", "cutlass")


def weight_gemms(prof: dict) -> str:
    """The W8A16 kernels' and the library GEMMs' device ms per unit of a
    profile, and their shares of its device time."""
    rows, steps = prof["rows"], prof["steps"]
    total = sum(getattr(e, "self_device_time_total", 0) for e in rows) or 1
    w8 = sum(getattr(e, "self_device_time_total", 0) for e in rows if "w8a16" in e.key)
    lib = sum(getattr(e, "self_device_time_total", 0) for e in rows
              if "w8a16" not in e.key and any(k in e.key.lower() for k in LIBRARY_GEMMS))
    return (f"W8A16 {w8 / 1e3 / steps:.4f} ms ({w8 / total:.3f}), library GEMMs "
            f"{lib / 1e3 / steps:.4f} ms ({lib / total:.3f})")


def serve_int8_weights(params, cfg, bf16: dict, base: dict) -> dict:
    """The 32-layer 8B on int8 layer weights (quantization="int8",
    `quantization.quantize_params` on the card): weights' GiB before and
    after, then a serve run (graphs and overlap, the four default chat
    requests) per INT8_WEIGHT_RUNS. Gates: the W8A16 kernels launch as
    `route` sends them, 7 x 32 times a model step in each replay: the
    skinny kernel in the decode chunk (x decode_chunk), the wgmma kernel in
    the verify window (M = 8 x 5) and in the admissions, and neither
    kernel in the other's replays; B2 in the admissions and each layout's
    attention kernel; B1 never in the fused and speculative runs; every
    stream equals an eager synchronous engine's on the same int8 weights.
    Reports each run's step (decode step or verify window) from its graph,
    wall and device ms, beside the bf16 one of the same smoke (`bf16`),
    the weight GEMMs' share of it, and the greedy streams' agreement with
    the bf16 per_layer run's (`base`; random weights give flat logits, so
    not a gate); then one prefill at the 512 bucket on bf16 and on int8
    weights, profiled. Returns both kernels' launches on the main path
    (the per_layer run: the skinny kernel's in decode replays, the wgmma
    kernel's in the admissions)."""
    import torch

    from kubeai_tpu_torch.engine.quantization import quantize_params, weight_bytes
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops.int8_matmul import route

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    print(f"serve int8 weights: quantized on the card in {time.perf_counter() - t0:.2f} s; "
          f"weights {weight_bytes(params) / 2**30:.3f} GiB in bf16, "
          f"{weight_bytes(qparams) / 2**30:.3f} GiB with int8 layer weights", flush=True)
    per_model_step = 7 * cfg.num_layers
    launches = {}
    for label, extra, attn, program in INT8_WEIGHT_RUNS:
        tag = f"int8 weights {label}"
        extra = dict(extra, quantization="int8")
        run = serve_run(qparams, cfg, tag, **extra)
        got = run["launches"]
        engine = run["engine"]
        for name in ("w8a16_wgmma", "flash_causal_prefill", attn):
            if got[name] <= 0:
                fail(f"serve {tag}: main path never launched {name}")
        if label != "per_layer" and got["paged_decode_attention"]:
            fail(f"serve {tag}: paged_decode_attention launched")
        steps = engine.cfg.decode_chunk if program == "decode chunk" else 1
        rows = engine.cfg.num_slots * (engine.cfg.speculate + 1 if steps == 1 else 1)
        routed = route(rows).__name__
        per_replay = _programs(engine)[program].launches_per_replay
        for name in ("w8a16_skinny", "w8a16_wgmma"):
            want = per_model_step * steps if name == routed else 0
            if per_replay.get(name, 0) != want:
                fail(f"serve {tag}: {name} launches {per_replay.get(name, 0)} times a "
                     f"{program} replay of {rows} rows, not {want}")
        print(f"serve {tag}: {routed} {per_replay.get(routed, 0)} launches a {program} "
              f"replay of {rows} rows ({per_model_step} a model step); in the run: "
              f"w8a16_skinny {got['w8a16_skinny']}, w8a16_wgmma {got['w8a16_wgmma']}",
              flush=True)
        check_streams_equal_eager(qparams, cfg, tag, run, **extra)
        report_agreement(tag, base, run, against="the bf16 per_layer run's")
        unit = "decode step" if program == "decode chunk" else "verify window"
        step = profile_program(engine, f"int8-weight {label} {unit}", program)
        ref = bf16[label]
        print(f"serve {tag} {unit} from its graph: wall {step['wall_ms']:.3f} ms, device "
              f"{step['device_ms']:.3f} ms; bf16 weights in this smoke: wall "
              f"{ref['wall_ms']:.3f} ms, device {ref['device_ms']:.3f} ms; weight GEMMs: "
              f"int8 {weight_gemms(step)}; bf16 {weight_gemms(ref)}", flush=True)
        if label == "per_layer":
            launches = {name: got[name] for name in ("w8a16_skinny", "w8a16_wgmma")}
        del engine
        free(run)
    gen = torch.Generator("cuda").manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device="cuda")
    lengths = torch.tensor([512], device="cuda")
    for name, p in (("bf16", params), ("int8", qparams)):
        prof = profile(None, f"{name}-weight prefill S=512",
                       lambda _, p=p: llama.prefill(p, cfg, toks, lengths), e_steps=1, calls=1)
        print(f"profile {name}-weight prefill S=512 weight GEMMs: {weight_gemms(prof)}",
              flush=True)
    del qparams
    free({})
    print(f"serve int8 weights card: {gpu_line()}", flush=True)
    return launches


def serve_int8_weights_alone() -> dict:
    """serve_int8_weights with what it compares against, as phase_serve
    runs it: random 8B weights, the bf16 per_layer, fused and speculate=4
    serve runs with each step profiled from its graph, then the int8
    runs. Not part of the smoke's own run (phase_serve calls
    serve_int8_weights itself)."""
    params, cfg = serve_weights()
    bf16, base = {}, {}
    for label, extra, _, program in INT8_WEIGHT_RUNS:
        run = serve_run(params, cfg, label, **extra)
        if label == "per_layer":
            base = {i: run["streams"][rid] for i, rid in run["rid_of"].items()}
        unit = "decode step" if program == "decode chunk" else "verify window"
        bf16[label] = profile_program(run["engine"], f"{label} {unit}", program)
        free(run)
    return timed("serve_int8_weights", serve_int8_weights, params, cfg, bf16, base)


# ---- serve_draft: an 8B target with a 1B draft -----------------------------------


def draft_weights(shape: dict = DRAFT_1B, seed: int = 2):
    """(random bf16 weights on cuda at `shape` (default Llama-3.2-1B, all 16
    layers, tied embeddings), its config)."""
    import torch

    from kubeai_tpu_torch.models import llama

    cfg = llama.LlamaConfig(**shape)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator("cuda").manual_seed(seed), device="cuda")
    torch.cuda.synchronize()
    print(f"serve_draft: random Llama-3.2-1B-shape weights on cuda in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return params, cfg


# Greedy acceptance below this in a self-draft run means the draft cache
# is out of step with the target's: target and draft compute the same
# function, differing only in attention path (B3 against the plain
# slot-cache attention) and rounding, which flips a near-tied greedy pick
# now and then. A sampled request accepts a greedy proposal only where its
# sample lands on the argmax, so the self-draft runs are greedy.
SELF_DRAFT_MIN_ACCEPTANCE = 0.8
# A draft slot row against the draft's own prefill of the same tokens, at
# layer 0, where each position's K and V depend only on its token: the
# two differ by the bf16 rounding of two GEMM shapes (~0.3%), while a
# position the draft never wrote, or wrote with another token, reads ~1.
DRAFT_ROW_RTOL = 0.02


def check_draft_rows(label: str, engine, seqs: dict) -> float:
    """The draft cache in step: `seqs` maps each slot to the token
    sequence (prompt + emitted tokens) its request ended with; the draft's
    row must hold the K/V of every position but the last (the last token
    is the input of a window that never ran). Each row is held against
    `llama.prefill` of the draft over those tokens (B2): at layer 0 every
    position's relative L2 error of K and of V within DRAFT_ROW_RTOL. The
    largest error over all layers is printed: rounding grows with depth.
    Returns the layer-0 maximum."""
    import torch

    from kubeai_tpu_torch.models import llama

    dcfg, dparams, cache = engine._draft_cfg, engine._draft_params, engine.draft_cache
    worst0 = worst = 0.0
    positions = 0
    for slot, seq in sorted(seqs.items()):
        ctx = seq[:-1]
        L = len(ctx)
        toks = torch.zeros(1, engine._bucket(L), dtype=torch.long, device="cuda")
        toks[0, :L] = torch.tensor(ctx, device="cuda")
        with torch.no_grad():
            _, k_all, v_all = llama.prefill(dparams, dcfg, toks, torch.tensor([L], device="cuda"))
        for ref, row in ((k_all[:, 0, :L], cache.k[:, slot, :L]),
                         (v_all[:, 0, :L], cache.v[:, slot, :L])):
            ref = ref.float()
            err = ((row.float() - ref).norm(dim=(-1, -2))
                   / ref.norm(dim=(-1, -2)).clamp_min(1e-6))  # [NL, L]
            worst0 = max(worst0, float(err[0].max()))
            worst = max(worst, float(err.max()))
        positions += L
    print(f"serve {label}: the draft cache's rows against the draft's prefill of the same "
          f"tokens ({len(seqs)} rows, {positions} positions): layer-0 relative error max "
          f"{worst0:.3e} (limit {DRAFT_ROW_RTOL}), all {dcfg.num_layers} layers max "
          f"{worst:.3e}", flush=True)
    if worst0 > DRAFT_ROW_RTOL:
        fail(f"serve {label}: a draft row is out of step with its tokens (layer-0 error "
             f"{worst0:.3e} > {DRAFT_ROW_RTOL})")
    return worst0


def _run_seqs(run: dict) -> dict:
    """{slot: prompt + emitted tokens} of a serve run's requests."""
    return {run["slot_of"][rid]: list(run["requests"][rid][0]) + run["streams"][rid]
            for rid in run["requests"]}


def _acceptance(stats: dict) -> float:
    return stats["accepted"] / max(1, stats["proposed"])


def _draft_gates(label: str, run: dict, cfg, dcfg) -> None:
    """B3 launches once a layer in every verify window (only from the
    graph), B1 never; every target admission launches B2 once a target
    layer and every draft admission once a draft layer, one draft
    admission per target admission."""
    engine, launches = run["engine"], run["launches"]
    per_window = engine._spec_program.launches_per_replay.get("paged_verify_attention")
    if per_window != cfg.num_layers:
        fail(f"serve {label}: B3 launches {per_window} times a verify window, not "
             f"{cfg.num_layers}")
    if launches["paged_verify_attention"] <= 0 or launches["paged_decode_attention"] != 0:
        fail(f"serve {label}: launches {json.dumps(launches)}: B3 must launch, B1 must not")
    adm = run["admit_b2"]
    target, draft = adm.get("_prefill_admit", []), adm.get("_draft_admit", [])
    if not target or any(n != cfg.num_layers for n in target):
        fail(f"serve {label}: target admissions launched B2 {target} times")
    if len(draft) != len(target) or any(n != dcfg.num_layers for n in draft):
        fail(f"serve {label}: draft admissions launched B2 {draft} times "
             f"({len(target)} target admissions)")
    print(f"serve {label}: B3 {per_window} launches a verify window; B2 {target[0]} + "
          f"{draft[0]} launches an admission over {len(target)} admissions", flush=True)


def serve_draft(params, cfg) -> dict:
    """Draft-model speculation on the card (the catalog's
    llama-3.1-8b-draft-spec-tpu): the 8B-shape `params`, all 32 layers,
    with Llama-3.1's rope scaling as the target and random
    Llama-3.2-1B-shape weights (DRAFT_1B, 16 layers) as the draft, served
    with speculate=4, spec_adaptive=False on the four default chat
    requests (`serve_run`). Gates: `_draft_gates`; the draft's rows in
    step with the served tokens (`check_draft_rows`); every stream equal
    to an eager synchronous engine's with the same draft. Prints
    spec_stats and acceptance, the propose chain and the verify window
    from their graphs (device and wall ms; the chain's kernels from an
    eager pass), the graph pools and the draft cache's MiB. Then the 1B
    shape with itself as the draft on the four requests made greedy: the
    same gates, and acceptance at least SELF_DRAFT_MIN_ACCEPTANCE; and an
    engine with spec_adaptive=True and spec_probe_every=2 whose
    chunk-mode windows must run, after which the verify windows'
    acceptance must stay at least SELF_DRAFT_MIN_ACCEPTANCE and the rows
    in step (the catch-up keeps the draft in step).
    Returns the draft admissions' B2 launches for the kernels line."""
    import dataclasses

    from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    target_cfg = dataclasses.replace(cfg, rope_scaling=LLAMA31_ROPE)
    dparams, dcfg = draft_weights()
    extra = dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False)
    run = serve_run(params, target_cfg, "draft", draft=(dcfg, dparams), **extra)
    engine = run["engine"]
    _draft_gates("draft", run, target_cfg, dcfg)
    draft_b2 = sum(run["admit_b2"]["_draft_admit"])
    stats = engine.spec_stats
    print(f"serve draft spec_stats {json.dumps(stats)} acceptance {_acceptance(stats):.4f}",
          flush=True)
    check_draft_rows("draft", engine, _run_seqs(run))
    check_streams_equal_eager(params, target_cfg, "draft", run, **extra)
    propose = profile_program(engine, "propose chain", "propose chain")
    verify = profile_program(engine, "draft verify window", "verify window", eager=False)
    print(f"serve draft window (32-layer 8B target, 16-layer 1B draft, gamma 4, "
          f"{SERVE_CONFIG['num_slots']} slots): propose chain device "
          f"{propose['device_ms']:.3f} ms wall {propose['wall_ms']:.3f} ms + verify device "
          f"{verify['device_ms']:.3f} ms wall {verify['wall_ms']:.3f} ms = device "
          f"{propose['device_ms'] + verify['device_ms']:.3f} ms; draft cache "
          f"{engine.draft_cache.nbytes() / 2**20:.1f} MiB; card: {gpu_line()}", flush=True)
    del engine
    free(run)
    # The 1B with itself as its draft, on the four requests made greedy:
    # acceptance says whether the draft cache is in step.
    greedy = [[{k: v for k, v in b.items() if k != "seed"} | {"temperature": 0}
               for b in _default_bodies()[0]]]
    run = serve_run(dparams, dcfg, "self-draft", waves=greedy, draft=(dcfg, dparams), **extra)
    _draft_gates("self-draft", run, dcfg, dcfg)
    stats = run["engine"].spec_stats
    print(f"serve self-draft spec_stats {json.dumps(stats)} acceptance "
          f"{_acceptance(stats):.4f}", flush=True)
    if _acceptance(stats) < SELF_DRAFT_MIN_ACCEPTANCE:
        fail(f"serve self-draft: acceptance {_acceptance(stats):.4f} < "
             f"{SELF_DRAFT_MIN_ACCEPTANCE}: the draft cache is out of step")
    check_draft_rows("self-draft", run["engine"], _run_seqs(run))
    ref = check_streams_equal_eager(dparams, dcfg, "self-draft", run, **extra)
    print(f"serve self-draft eager reference spec_stats {json.dumps(ref.spec_stats)}",
          flush=True)
    del ref
    free(run)
    # Adaptive: chunk-mode windows between verify windows; the catch-up
    # program replays each chunk through the draft.
    tok = ByteTokenizer()
    engine = Engine("llama", dcfg, dparams, cfg=EngineConfig(
        **SERVE_CONFIG, decode_kernel="per_layer", speculate=4, spec_adaptive=True,
        spec_probe_every=2), eos_token_ids=tok.eos_token_ids, draft=(dcfg, dparams))
    if engine._draft_catchup_program.graph is None:
        fail("serve self-draft adaptive: the catch-up is not a CUDA graph on the card")
    first_chunk: dict = {}
    catchup = engine._draft_catchup_program.dispatch

    def catchup_and_note():
        if not first_chunk:
            first_chunk.update(engine.spec_stats)
        return catchup()

    engine._draft_catchup_program.dispatch = catchup_and_note
    slot_of: dict[int, int] = {}
    finish_admission = engine._finish_admission

    def admit_and_note(req, slot, *a, **kw):
        slot_of[req.rid] = slot
        return finish_admission(req, slot, *a, **kw)

    engine._finish_admission = admit_and_note
    prompts = [tok.apply_chat_template(b["messages"]) for b in _default_bodies()[0]]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, SamplingParams(temperature=0.0, max_tokens=96))
    stats = engine.spec_stats
    after = {k: stats[k] - first_chunk.get(k, 0) for k in stats}
    chunks = engine._mode_calls.get("chunk", 0)
    print(f"serve self-draft adaptive: {chunks} chunk-mode and "
          f"{engine._mode_calls.get('spec', 0)} verify calls in "
          f"{time.perf_counter() - t0:.2f} s; spec_stats {json.dumps(stats)}; after the "
          f"first chunk window {json.dumps(after)} acceptance {_acceptance(after):.4f}",
          flush=True)
    if chunks < 2 or after["proposed"] <= 0:
        fail(f"serve self-draft adaptive: {chunks} chunk windows, {after['proposed']} "
             "proposals after the first")
    if _acceptance(after) < SELF_DRAFT_MIN_ACCEPTANCE:
        fail(f"serve self-draft adaptive: acceptance {_acceptance(after):.4f} after the "
             f"chunk windows < {SELF_DRAFT_MIN_ACCEPTANCE}: the catch-up left the draft "
             "out of step")
    check_draft_rows("self-draft adaptive", engine,
                     {slot_of[rid]: prompts[rid] + outs[rid] for rid in range(len(prompts))})
    del engine
    free({})
    return {"flash_causal_prefill_d64_g4": draft_b2}


# ---- serve_slot: the slot KV cache at 8B width ------------------------------------


def serve_slot(params, cfg, bf16_step: dict) -> None:
    """The slot cache (cache_mode="slot") on the 8B-shape `params` at
    `cfg`'s depth: the four default chat requests served (`serve_run`),
    whole-prompt, then with prefill_chunk=256 (the 317- and 717-token
    prompts chunk into their rows through the plain chunk attention).
    Gates: the decode chunk a CUDA graph; the paged kernels never
    launched; each whole-prompt admission B2 once a layer; the chunked
    run's two long prompts admitted by chunks; every stream equal to an
    eager synchronous slot engine's. Prints the slot decode step from its
    graph beside the paged per_layer step at the same depth (`bf16_step`)
    and the slot cache's MiB."""
    paged = ("paged_decode_attention", "paged_verify_attention",
             "paged_decode_attention_fused", "paged_decode_attention_int8")
    for label, extra, chunked in (("slot", dict(cache_mode="slot"), 0),
                                  ("slot chunked", dict(cache_mode="slot", prefill_chunk=256), 2)):
        run = serve_run(params, cfg, label, **extra)
        engine = run["engine"]
        adm = run["admit_b2"]
        whole = adm.get("_prefill_admit_slot", [])
        if engine.cache_mode != "slot" or any(run["launches"][k] for k in paged):
            fail(f"serve {label}: cache {engine.cache_mode}, launches "
                 f"{json.dumps(run['launches'])}")
        if (len(whole) != 4 - chunked or any(n != cfg.num_layers for n in whole)
                or len(adm.get("_admit_chunked", [])) != chunked):
            fail(f"serve {label}: admissions {json.dumps(adm)}")
        print(f"serve {label}: B2 {whole[0]} launches in each of {len(whole)} whole-prompt "
              f"admissions, {chunked} chunked admissions", flush=True)
        check_streams_equal_eager(params, cfg, label, run, **extra)
        if not chunked:
            step = profile_program(engine, f"{cfg.num_layers}-layer slot decode step",
                                   "decode chunk", eager=False)
            print(f"serve slot: decode step device {step['device_ms']:.3f} ms wall "
                  f"{step['wall_ms']:.3f} ms against the paged per_layer step's device "
                  f"{bf16_step['device_ms']:.3f} ms wall {bf16_step['wall_ms']:.3f} ms at "
                  f"{cfg.num_layers} layers; slot cache {engine.cache.nbytes() / 2**20:.1f} "
                  f"MiB; card: {gpu_line()}", flush=True)
        del engine
        free(run)


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


def serve_prefix(params=None, cfg=None, int8: bool = False) -> dict:
    """Run 4: `prefill_chunk=512, prefix_cache=True` over two waves of
    traffic that share a 1,024-token system prompt (`_prefix_waves`), in
    the per_layer layout. Gates: B1 and B2 launch; the staged-chunk programs
    (mid chunk, final chunk, prefix gather) dispatch, only as CUDA-graph
    replays; prefix_stats["hit_tokens"] reaches the count of the cache
    rule (`expected_hits`, with wave 2 at least 4 x 1,024); the streams
    and hit tokens equal an eager synchronous engine's with the same
    settings. Reports: TTFT of hits and misses, greedy agreement with a
    whole-prompt engine's streams on the same prompts, and
    `profile_admissions`. Builds the weights when not given. With `int8`
    the pools are int8 (a hit dequantizes the adopted pages into the
    staging buffers) and B1's int8 read, not B1, must launch; the reports
    stop after the eager comparison. Returns the run's launches."""
    from kubeai_tpu_torch.engine import Engine, EngineConfig

    if params is None:
        params, cfg = serve_weights()
    label = "prefix int8" if int8 else "prefix"
    t_phase = time.perf_counter()
    extra = dict(decode_kernel="per_layer", prefill_chunk=PREFIX_CHUNK, prefix_cache=True)
    if int8:
        extra["kv_dtype"] = "int8"
    run = serve_run(params, cfg, label, waves=_prefix_waves(), **extra)
    engine = run["engine"]
    decode = "paged_decode_attention_int8" if int8 else "paged_decode_attention"
    for name in (decode, "flash_causal_prefill"):
        if run["launches"][name] <= 0:
            fail(f"serve {label}: main path never launched {name}")
    if int8 and run["launches"]["paged_decode_attention"]:
        fail(f"serve {label}: paged_decode_attention launched on int8 pools")
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
    if int8:
        launches = run["launches"]
        del engine, ref
        free(run)
        print(f"serve {label} took {time.perf_counter() - t_phase:.2f} s", flush=True)
        return launches
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


# ---- serve_int8: int8 KV pools on the 8B-shape model ------------------------------


def serve_int8(params, cfg, bf16_step: dict) -> int:
    """The per_layer serve run on int8 KV pools (`kv_dtype="int8"`, graphs
    and overlap): the four default prompts greedy, then the four seeded
    (`_disagg_bodies`), a wave each. Each wave's prompts fall in distinct
    buckets, so the served and the eager engine admit them alike, one per
    prefill call (a batched prefill of other rows rounds other bits, and
    random weights turn that into other tokens). Gates: B1's int8 read launches, only
    from graph replays; bf16 B1 never launches on this engine; every
    stream equals an eager synchronous int8 engine's. Reports the pool's
    GiB against a bf16 pool of the same pages, /v1/state's kv_cache facts,
    and the decode step from its graph (wall and device ms) beside the
    bf16 step of an engine at the same depth (`bf16_step`). Returns
    B1-int8's launches on the main path."""
    t_phase = time.perf_counter()
    label = "int8"
    extra = dict(decode_kernel="per_layer", kv_dtype="int8")
    bodies = [b for _, b in _disagg_bodies()]
    run = serve_run(params, cfg, label, waves=[bodies[0::2], bodies[1::2]], **extra)
    engine = run["engine"]
    got = run["launches"]
    if got["paged_decode_attention_int8"] <= 0:
        fail("serve int8: main path never launched paged_decode_attention_int8")
    if got["paged_decode_attention"]:
        fail("serve int8: paged_decode_attention (bf16) launched on int8 pools")
    if got["flash_causal_prefill"] <= 0:
        fail("serve int8: main path never launched flash_causal_prefill")
    check_int8_pools(label, engine, cfg.num_layers)
    check_streams_equal_eager(params, cfg, label, run, **extra)
    step = profile_program(engine, "int8 decode step", "decode chunk")
    print(f"serve int8 decode step from its graph: wall {step['wall_ms']:.3f} ms, device "
          f"{step['device_ms']:.3f} ms; bf16 step at {cfg.num_layers} layers: wall "
          f"{bf16_step['wall_ms']:.3f} ms, device {bf16_step['device_ms']:.3f} ms", flush=True)
    launches = got["paged_decode_attention_int8"]
    del engine
    free(run)
    print(f"serve int8 took {time.perf_counter() - t_phase:.2f} s; card: {gpu_line()}",
          flush=True)
    return launches


# ---- serve_lora: LoRA adapters on the 8B-shape model ------------------------------

LORA_RANK = 16
LORA_ALPHA = 32.0  # alpha / r = 2, folded into B by the loader
LORA_HF = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}
# (label, EngineConfig settings, kernels that must launch, kernels that
# must not): the four LoRA runs of serve_lora.
LORA_RUNS = (
    ("per_layer", dict(decode_kernel="per_layer"),
     ("paged_decode_attention", "flash_causal_prefill"), ()),
    ("speculate", dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False),
     ("paged_verify_attention", "flash_causal_prefill"), ("paged_decode_attention",)),
    ("fused", dict(decode_kernel="fused"),
     ("paged_decode_attention_fused", "flash_causal_prefill"), ("paged_decode_attention",)),
    ("int8", dict(decode_kernel="per_layer", kv_dtype="int8"),
     ("paged_decode_attention_int8", "flash_causal_prefill"), ("paged_decode_attention",)),
)


def write_peft_adapter(path: str, cfg, seed: int, num_layers: int | None = None) -> str:
    """A PEFT adapter directory at `path`: rank-LORA_RANK lora_A and lora_B
    tensors over wq, wk, wv and wo for every layer, drawn with numpy from
    `seed` (N(0, 0.02)) and stored in bf16 by `weights.save_safetensors`
    as adapter_model.safetensors, and an adapter_config.json with r and
    lora_alpha."""
    import os

    import numpy as np
    import torch

    from kubeai_tpu_torch.engine.weights import save_safetensors
    from kubeai_tpu_torch.models import llama

    rng = np.random.default_rng(seed)
    dims = llama.lora_dims(cfg)
    tensors = {}
    for i in range(num_layers or cfg.num_layers):
        for target, hf in LORA_HF.items():
            din, dout = dims[target]
            name = f"base_model.model.model.layers.{i}.self_attn.{hf}"
            for part, shape in (("lora_A", (LORA_RANK, din)), ("lora_B", (dout, LORA_RANK))):
                w = rng.standard_normal(shape, np.float32) * np.float32(0.02)
                tensors[f"{name}.{part}.weight"] = torch.from_numpy(w).to(torch.bfloat16)
    save_safetensors(path, tensors, {})
    os.replace(os.path.join(path, "model.safetensors"),
               os.path.join(path, "adapter_model.safetensors"))
    os.remove(os.path.join(path, "config.json"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": LORA_RANK, "lora_alpha": LORA_ALPHA,
                   "target_modules": list(LORA_HF.values())}, f)
    return path


def load_lora(path: str, cfg) -> dict:
    """`lora_weights.load_peft_adapter` of a PEFT directory; fails unless
    it gives all four targets at rank LORA_RANK with nonzero B."""
    from kubeai_tpu_torch.engine.lora_weights import load_peft_adapter

    weights = load_peft_adapter(path, cfg, max_rank=LORA_RANK)
    if sorted(weights) != sorted(LORA_HF):
        fail(f"serve_lora: {path} loaded targets {sorted(weights)}")
    for target, (A, B) in weights.items():
        if A.shape[-1] != LORA_RANK or not B.any():
            fail(f"serve_lora: {path} {target}: rank {A.shape[-1]}, B nonzero {B.any()}")
    return weights


def _lora_waves() -> list[list[dict]]:
    """Three waves over the four default bodies: in each wave every prompt
    runs on another model (the base, a1 or a2), so each wave mixes all
    three in one decode batch, and over the waves every prompt runs on
    all three. A wave's prompts fall in distinct prefill buckets, so the
    served and the eager engine admit them alike."""
    bodies = _default_bodies()[0]
    models = (None, "a1", "a2")
    return [[b if models[(i + w) % 3] is None else {**b, "model": models[(i + w) % 3]}
             for i, b in enumerate(bodies)] for w in range(3)]


def _by_prompt_and_adapter(run: dict) -> dict:
    """{(prompt length, adapter): (sampling params, stream)} of a run."""
    return {(len(prompt), run["adapters"].get(rid)): (sp, run["streams"][rid])
            for rid, (prompt, sp) in run["requests"].items()}


def check_adapters_matter(label: str, run: dict) -> None:
    """Prints how many leading tokens each adapter stream shares with the
    same prompt's base stream; fails unless at least one greedy adapter
    stream differs from its base stream."""
    got = _by_prompt_and_adapter(run)
    differ = 0
    for (plen, adapter), (sp, stream) in sorted(got.items(), key=lambda kv: str(kv[0])):
        if adapter is None:
            continue
        base = got[plen, None][1]
        same = _leading_equal(stream, base)
        kind = "greedy" if sp.temperature == 0 else "seeded"
        differ += kind == "greedy" and stream != base
        print(f"serve lora {label} prompt of {plen} tokens, adapter {adapter} ({kind}): "
              f"{same}/{len(base)} leading tokens equal to the base model's", flush=True)
    if differ == 0:
        fail(f"serve lora {label}: every greedy adapter stream equals its base stream")


def lora_buffer_bytes(engine) -> int:
    return sum(t.numel() * t.element_size() for ab in engine._lora.values()
               for t in ab.values())


def lora_hot_swap(params, cfg, engine, adapters: dict, a3: dict, extra: dict) -> None:
    """On a served engine after capture (a1 and a2 loaded): a pending and
    an active request of a2 make its unload raise the in-flight error;
    then a2 is unloaded and a third adapter loads into the row a2 freed
    (rows 3 and 4 held by two more loads of it, so the free list gives
    that row), and four requests (a3, a1 and the base model) run through
    the same graphs with overlap. Gates: their streams equal those of an
    eager synchronous engine that loaded a1 and a3 from the start
    (`check_streams_equal_eager`); every device program keeps its CUDA
    graph object and graph pool (nothing was captured again); B1 launched
    only from replays."""
    import torch

    from kubeai_tpu_torch.engine import SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    tok = ByteTokenizer()
    graphs = {name: (prog.graph, prog.pool_bytes) for name, prog in _programs(engine).items()}
    bodies = _default_bodies()[0]
    prompts = [tok.apply_chat_template(b["messages"]) for b in bodies]
    long_sp = SamplingParams(temperature=0.0, max_tokens=64)
    rid = engine.add_request(prompts[0], long_sp, adapter="a2")
    refusals = []
    for when in ("pending", "active"):
        if when == "active":
            engine.step()
            if engine._requests[rid].slot < 0:
                fail("serve lora swap: the a2 request was not admitted")
        try:
            engine.unload_adapter("a2")
        except RuntimeError as e:
            if "in-flight" not in str(e):
                fail(f"serve lora swap: unload while {when}: {e}")
            refusals.append(when)
        else:
            fail(f"serve lora swap: unload of a2 while a request was {when} succeeded")
    engine.cancel(rid)
    while engine.has_work():
        engine.step()
    engine.load_adapter("fill3", a3)
    engine.load_adapter("fill4", a3)
    if not engine.unload_adapter("a2"):
        fail("serve lora swap: unload of a2 after its request ended returned False")
    t_load = time.perf_counter()
    engine.load_adapter("a3", a3)
    load_ms = (time.perf_counter() - t_load) * 1e3
    if engine._adapter_slots["a3"] != 2:
        fail(f"serve lora swap: a3 took row {engine._adapter_slots['a3']}, not a2's row 2")
    models = ("a3", "a1", "a3", None)
    sps = [SamplingParams(temperature=b["temperature"], max_tokens=b["max_tokens"],
                          seed=b.get("seed")) for b in bodies]
    _zero_launches(engine)
    rids = [engine.add_request(p, sp, adapter=m) for p, sp, m in zip(prompts, sps, models)]
    streams = {r: [] for r in rids}
    while engine.has_work():
        for ev in engine.step():
            if ev.rid in streams:
                streams[ev.rid].append(ev.token)
    launches = _launches(engine)
    dispatches = {name: prog.dispatches for name, prog in _programs(engine).items()}
    for name, prog in _programs(engine).items():
        if prog.graph is not graphs[name][0] or prog.pool_bytes != graphs[name][1]:
            fail(f"serve lora swap: the {name} was captured again")
    if launches["paged_decode_attention"] <= 0 or dispatches["decode chunk"] <= 0:
        fail(f"serve lora swap: no decode replays after the swap ({launches}, {dispatches})")
    swap = {"engine": engine, "waves": [rids], "streams": streams,
            "requests": {r: (p, sp) for r, p, sp in zip(rids, prompts, sps)},
            "adapters": dict(zip(rids, models))}
    ref = check_streams_equal_eager(params, cfg, "lora swap", swap,
                                    adapters={"a1": adapters["a1"], "a3": a3}, **extra)
    if ref._adapter_slots != {"a1": 1, "a3": 2}:
        fail(f"serve lora swap: reference rows {ref._adapter_slots}")
    del ref
    torch.cuda.empty_cache()
    print(f"serve lora swap: unload refused while a request was {' and '.join(refusals)}; "
          f"a3 loaded into a2's row 2 in {load_ms:.2f} ms under the captured graphs; "
          f"graphs and pools unchanged ({', '.join(graphs)}); launches after the swap "
          f"{json.dumps(launches)}, dispatches {json.dumps(dispatches)}; took "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def profile_lora_prefill(params, cfg, lora) -> None:
    """torch.profiler over llama.prefill at B=1, S=1024 without adapters
    and with one adapter row of `lora` (the prefill admission's model
    call): device ms and kernel launches of each, and B2's share."""
    import torch

    from kubeai_tpu_torch.models import llama

    gen = torch.Generator("cuda").manual_seed(13)
    S = 1024
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device="cuda")
    lengths = torch.tensor([S], device="cuda")
    idx = torch.tensor([1], device="cuda")
    out = {}
    for tag, kw in (("base", {}), ("lora", {"lora": lora, "lora_idx": idx})):
        prof = profile(None, f"{tag} prefill S={S}",
                       lambda _: llama.prefill(params, cfg, toks, lengths, **kw),
                       e_steps=1, calls=1)
        out[tag] = (prof["device_ms"], sum(e.count for e in prof["rows"]) / prof["steps"])
    print(f"serve lora prefill S={S} B=1: device {out['lora'][0]:.3f} ms with an adapter vs "
          f"{out['base'][0]:.3f} ms without (x{out['lora'][0] / out['base'][0]:.4f}); kernel "
          f"launches {out['lora'][1]:.0f} vs {out['base'][1]:.0f}", flush=True)


def serve_lora(params, cfg, bf16_step: dict, bf16_verify: dict) -> None:
    """LoRA on the 8B-shape model: three rank-16 adapters over wq, wk, wv
    and wo written as PEFT directories (bf16, numpy from a seed) and read
    by `lora_weights.load_peft_adapter`. Four serve runs with
    max_adapters=4, a1 and a2 loaded after the programs were captured, and
    `_lora_waves` (base, a1 and a2 in every decode batch): per_layer (B1
    and B2 must launch), speculate=4 (B3), fused (B4) and per_layer on
    int8 pools (B1-int8); B1 must not launch in the last three. Every
    stream must equal an eager synchronous engine's fed the same requests
    and adapters, and a greedy adapter stream must differ from its base
    stream. On the per_layer run's engine: the decode chunk profiled
    against the bf16 step without adapters (`bf16_step`), the hot swap
    (`lora_hot_swap`) and the prefill admission with and without an
    adapter; on the speculate run's: the verify window against
    `bf16_verify`. Prints the adapter buffers' MiB."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kubeai-lora-")
    try:
        t0 = time.perf_counter()
        dirs = {name: write_peft_adapter(f"{root}/{name}", cfg, seed)
                for name, seed in (("a1", 21), ("a2", 22), ("a3", 23))}
        t1 = time.perf_counter()
        weights = {name: load_lora(path, cfg) for name, path in dirs.items()}
        print(f"serve lora: three rank-{LORA_RANK} PEFT adapters over "
              f"{'/'.join(LORA_HF)} for {cfg.num_layers} layers written in "
              f"{t1 - t0:.2f} s and loaded by load_peft_adapter in "
              f"{time.perf_counter() - t1:.2f} s", flush=True)
        adapters = {name: weights[name] for name in ("a1", "a2")}
        for label, extra, must, must_not in LORA_RUNS:
            extra = dict(max_adapters=4, **extra)
            run = serve_run(params, cfg, f"lora {label}", waves=_lora_waves(),
                            adapters=adapters, **extra)
            got = run["launches"]
            for name in must:
                if got[name] <= 0:
                    fail(f"serve lora {label}: main path never launched {name}")
            for name in must_not:
                if got[name]:
                    fail(f"serve lora {label}: {name} launched {got[name]} times")
            engine = run["engine"]
            print(f"serve lora {label}: adapter buffers {lora_buffer_bytes(engine) / 2**20:.2f} "
                  f"MiB ({engine.cfg.max_adapters + 1} rows x rank "
                  f"{engine.cfg.max_lora_rank} x {cfg.num_layers} layers, "
                  f"{engine._lora['wq']['A'].dtype}); rows {json.dumps(engine._adapter_slots)}",
                  flush=True)
            check_streams_equal_eager(params, cfg, f"lora {label}", run, **extra)
            check_adapters_matter(label, run)
            if label == "per_layer":
                step = profile_program(engine, "lora decode step", "decode chunk")
                print(f"serve lora decode step from its graph: device {step['device_ms']:.3f} "
                      f"ms vs {bf16_step['device_ms']:.3f} ms without adapters (+"
                      f"{step['device_ms'] - bf16_step['device_ms']:.3f} ms); wall "
                      f"{step['wall_ms']:.3f} vs {bf16_step['wall_ms']:.3f} ms; kernel "
                      f"launches {step['kernels']:.0f} vs {bf16_step['kernels']:.0f} "
                      f"per step", flush=True)
                profile_lora_prefill(params, cfg, engine._lora)
                lora_hot_swap(params, cfg, engine, adapters, weights["a3"], extra)
            elif label == "speculate":
                win = profile_program(engine, "lora verify window", "verify window")
                print(f"serve lora verify window from its graph: device "
                      f"{win['device_ms']:.3f} ms vs {bf16_verify['device_ms']:.3f} ms without "
                      f"adapters (+{win['device_ms'] - bf16_verify['device_ms']:.3f} ms); "
                      f"wall {win['wall_ms']:.3f} vs {bf16_verify['wall_ms']:.3f} ms; kernel "
                      f"launches {win['kernels']:.0f} vs {bf16_verify['kernels']:.0f} per "
                      f"window", flush=True)
            del engine
            free(run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"serve lora took {time.perf_counter() - t_phase:.2f} s; card: {gpu_line()}",
          flush=True)


# ---- serve_disagg and serve_kv_share: KV handoffs and peer page fetches ----------


def _disagg_bodies() -> list[tuple[str, dict]]:
    """The four default bodies, each greedy and seeded; the 117-token
    body's greedy run is streamed, every other is unary."""
    out = []
    for mode, body in _resume_bodies():
        stream = mode == "greedy" and len(out) == 6
        out.append((mode, {**body, "stream": stream}))
    return out


def _reply(res: dict, stream: bool) -> tuple[str, list]:
    """(text, SSE token ids or []) of a chat completion result."""
    if stream:
        return res["text"], res["token_ids"]
    return res["choices"][0]["message"]["content"], []


class _DisaggSide:
    """An EngineServer of one role over `params` with the engine's
    defaults (graphs and overlap) and IdTokenizer, its engine wrapped to
    keep: each request's token stream (the first event of an import
    included), when each request's first token existed, each export's
    wall, prefill and page-gather seconds, each import's seconds (until
    the card has finished it), the prefill calls, and (decode side) a
    check, under the engine lock, that an import wrote the handoff's bits
    into the pool."""

    def __init__(self, params, cfg, role: str, label: str, server_kw=None, **extra):
        import torch

        from kubeai_tpu_torch.engine import Engine, EngineConfig
        from kubeai_tpu_torch.engine.server import EngineServer

        self.label = label
        tok = IdTokenizer()
        eng = Engine("llama", cfg, params, cfg=EngineConfig(**SERVE_CONFIG, **extra),
                     eos_token_ids=tok.eos_token_ids)
        if not eng._overlap or eng._decode_program.graph is None:
            fail(f"serve_disagg {label}: the engine does not overlap or replay graphs")
        self.engine = eng
        self.streams: dict[int, list[int]] = {}
        self.t_first: dict[int, float] = {}
        self.exports: list[dict] = []
        self.imports: list[dict] = []
        self.prefill_calls = 0
        self.imported_bits_equal = 0
        step, add = eng.step, eng.add_request
        export, import_, import_kv = eng.export_handoff, eng.import_handoff, eng._import_kv
        prefill, gather = eng._prefill_admit, eng._gather_pages_host
        admit = eng._admit_paged_batch
        pending = {}
        self.gathered: list[int] = []
        timed = {"prefill": 0.0, "gather": 0.0}

        def step_and_keep():
            events = step()
            now = time.perf_counter()
            for ev in events:
                self.streams.setdefault(ev.rid, []).append(ev.token)
                self.t_first.setdefault(ev.rid, now)
            return events

        def add_and_note(*a, **kw):
            rid = add(*a, **kw)
            self.last_rid = rid
            return rid

        def export_and_time(*a, **kw):
            timed.update(prefill=0.0, gather=0.0)
            t0 = time.perf_counter()
            h = export(*a, **kw)
            wall = time.perf_counter() - t0
            self.exports.append({"wall_s": wall, **timed, "handoff": h})
            return h

        def admit_and_time(*a, **kw):  # returns the first tokens on the host
            t0 = time.perf_counter()
            out = admit(*a, **kw)
            timed["prefill"] += time.perf_counter() - t0
            return out

        def import_and_time(h, on_admit=None):
            pending["handoff"] = h
            t0 = time.perf_counter()
            rid, ev = import_(h, on_admit=on_admit)
            now = time.perf_counter()
            torch.cuda.synchronize()
            self.streams.setdefault(rid, []).insert(0, ev.token)
            self.t_first[rid] = now
            self.last_rid = rid
            self.imports.append({"rid": rid, "t": now,
                                 "import": time.perf_counter() - t0})
            return rid, ev

        def import_kv_and_check(slot, plen, k_seq, v_seq, req, scales=None):
            import_kv(slot, plen, k_seq, v_seq, req, scales)
            h = pending.pop("handoff")
            pages = eng._alloc.pages_for(slot)
            if not _pages_hold(eng.cache.k_pages, pages, h.k_pages, h.k_scales, plen) or \
                    not _pages_hold(eng.cache.v_pages, pages, h.v_pages, h.v_scales, plen):
                fail(f"serve_disagg {label}: the imported pool pages are not the "
                     "handoff's bits")
            self.imported_bits_equal += 1

        def prefill_and_count(*a, **kw):
            self.prefill_calls += 1
            return prefill(*a, **kw)

        def gather_and_keep(pool, pages):  # its copy to the host waits for the card
            self.gathered = list(pages)
            t0 = time.perf_counter()
            out = gather(pool, pages)
            timed["gather"] += time.perf_counter() - t0
            return out

        eng.step, eng.add_request = step_and_keep, add_and_note
        eng.export_handoff, eng.import_handoff = export_and_time, import_and_time
        eng._import_kv, eng._prefill_admit = import_kv_and_check, prefill_and_count
        eng._gather_pages_host, eng._admit_paged_batch = gather_and_keep, admit_and_time
        self.server = EngineServer(eng, tok, "llama-3-8b-shape", port=0, role=role,
                                   **(server_kw or {}))
        receive = self.server._handle_kv_import
        self.receives: list[float] = []

        def receive_and_time(http):
            t0 = time.perf_counter()
            out = receive(http)
            self.receives.append(time.perf_counter() - t0)
            return out

        self.server._handle_kv_import = receive_and_time
        self.server.start()

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.server.port}"

    def state(self) -> dict:
        return json.loads(_get(self.server.port, "/v1/state")[1])

    def metrics(self) -> dict:
        return _parse_metrics(_get(self.server.port, "/metrics")[1])

    def stop(self) -> None:
        self.server.stop()


def _pages_hold(pool, pages, host, host_scales=None, plen=None) -> bool:
    """Whether `pool`'s `pages`, in table order, hold the wire's bits: a
    bf16 pool its uint16 words, an int8 pool its int8 pages and f32
    scales; with `plen`, only the first plen token rows."""
    import numpy as np
    import torch

    from kubeai_tpu_torch.ops.kv_quant import QuantizedPool

    got = pool[:, torch.as_tensor(pages, device=pool.device)]
    nl, n, page, kvh, d = host.shape
    rows = plen if plen is not None else n * page
    if isinstance(got, QuantizedPool):
        pairs = ((got.q8.reshape(nl, -1, kvh, d), torch.from_numpy(host.copy())),
                 (got.scale.reshape(nl, -1, kvh), torch.from_numpy(host_scales.copy())))
    else:
        pairs = ((got.reshape(nl, -1, kvh, d),
                  torch.from_numpy(host.view(np.int16).copy()).view(torch.bfloat16)),)
    for have, wire in pairs:
        wire = wire.reshape(have.shape).to(have.device)
        if not torch.equal(have[:, :rows], wire[:, :rows]):
            return False
    return True


def _direct(side: _DisaggSide, bodies) -> dict:
    """Each body alone to `side`: {index: (text, token ids, engine stream,
    seconds from the POST to the first token in the engine)}."""
    out = {}
    for i, (_, body) in enumerate(bodies):
        t0 = time.perf_counter()
        status, res, _, _ = _post(side.server.port, body)
        if status != 200:
            fail(f"serve_disagg {side.label} direct body {i}: HTTP {status} {res}")
        rid = side.last_rid
        text, ids = _reply(res, body.get("stream"))
        out[i] = (text, ids, side.streams[rid], side.t_first[rid] - t0)
    return out


def _two_hop(pre: _DisaggSide, dec: _DisaggSide, i: int, body: dict) -> dict:
    """One body through prefill (X-Disagg-Transfer naming `dec`) and then
    decode (X-Disagg-Handoff). Returns the reply, the engine stream, the
    receipt and the seconds from the first POST to the first token in the
    decode engine."""
    t0 = time.perf_counter()
    status, receipt, _, hop1_s = _post(pre.server.port, {**body, "stream": False},
                                       headers={"X-Disagg-Transfer": dec.addr})
    if status != 200 or receipt.get("object") != "kv.handoff":
        fail(f"serve_disagg body {i}: the prefill hop got HTTP {status} {receipt}")
    status, res, _, _ = _post(dec.server.port, body,
                              headers={"X-Disagg-Handoff": receipt["handoff_id"]})
    if status != 200:
        fail(f"serve_disagg body {i}: the decode hop got HTTP {status} {res}")
    rid = dec.imports[-1]["rid"]
    text, ids = _reply(res, body.get("stream"))
    return {"text": text, "ids": ids, "stream": dec.streams[rid], "receipt": receipt,
            "ttft_s": dec.imports[-1]["t"] - t0, "hop1_s": hop1_s}


def _check_hops(pre, dec, label: str, bodies, direct: dict, hops: dict) -> None:
    for i, (mode, body) in enumerate(bodies):
        text, ids, stream, _ = direct[i]
        hop = hops[i]
        tag = f"serve_disagg {label} body {i} ({mode}, {len(stream)} tokens)"
        if hop["stream"] != stream or hop["text"] != text or hop["ids"] != ids:
            step = _leading_equal(hop["stream"], stream)
            fail(f"{tag}: the two-hop stream differs from the decode server's own answer "
                 f"at token {step}: {hop['stream'][step:step + 3]} vs "
                 f"{stream[step:step + 3]}")
    print(f"serve_disagg {label}: {len(bodies)} two-hop streams (engine tokens, text"
          f"{', SSE ids' if any(b.get('stream') for _, b in bodies) else ''}) equal the "
          "decode server's own answers to the same bodies sent alone", flush=True)


def serve_disagg(params, cfg) -> dict:
    """Disaggregated prefill/decode at full width: a prefill-role and a
    decode-role EngineServer in this process on the card, sharing the
    weight tensors, each with its own ~2 GiB pool, graphs and overlap.
    Each body of `_disagg_bodies` goes alone to the decode server (the
    reference), then through the two hops. Gates: every two-hop stream
    equals the reference; the exported pages are bit-equal to the prefill
    pool's pages in table order and each import writes the handoff's bits
    into the decode pool; B2 launches on the prefill side, which never
    runs a decode program; B1 launches on the decode side, only from
    graph replays, and the decode side runs no prefill; /v1/state.role
    and the handoff counters. Then a fused decode-role server gets two
    bodies: B4 must launch and the streams must equal its own answers.
    Reports export ms (prefill and gather), serialize, push and receive
    ms and MB/s, import ms and two-hop TTFT against direct TTFT. Returns
    the launches of the two-hop runs."""
    from kubeai_tpu_torch.disagg.handoff import serialize

    t_phase = time.perf_counter()
    bodies = _disagg_bodies()
    pre = _DisaggSide(params, cfg, "prefill", "prefill", decode_kernel="per_layer")
    dec = _DisaggSide(params, cfg, "decode", "per_layer", decode_kernel="per_layer")
    launches = {}
    try:
        direct = _direct(dec, bodies)
        _zero_launches(dec.engine)
        _zero_launches(pre.engine)
        dec.prefill_calls = pre.prefill_calls = 0
        hops = {}
        for i, (_, body) in enumerate(bodies):
            hops[i] = _two_hop(pre, dec, i, body)
            # The exported pages, in table order, are the prefill pool's
            # pages: no request has run on the prefill engine since.
            h, pages = pre.exports[-1]["handoff"], pre.gathered
            if not _pages_hold(pre.engine.cache.k_pages, pages, h.k_pages) or \
                    not _pages_hold(pre.engine.cache.v_pages, pages, h.v_pages):
                fail(f"serve_disagg body {i}: the exported pages are not the prefill "
                     "pool's pages")
        eager = {name: fn.launches for name, fn in _wrappers().items()}
        replays = {"prefill": pre.engine._decode_program.dispatches,
                   "decode": dec.engine._decode_program.dispatches}
        launches = _launches(dec.engine)
        launches["flash_causal_prefill"] = eager["flash_causal_prefill"]
        print(f"serve_disagg per_layer launches during the two hops: {json.dumps(launches)} "
              f"(eager {json.dumps(eager)}; decode-chunk replays {json.dumps(replays)}; "
              f"prefill calls: prefill side {pre.prefill_calls}, decode side "
              f"{dec.prefill_calls}); pages bit-equal to the prefill pool in "
              f"{len(bodies)} exports and to the handoff in {dec.imported_bits_equal} "
              "imports", flush=True)
        if eager["flash_causal_prefill"] <= 0 or pre.prefill_calls != len(bodies):
            fail("serve_disagg: flash_causal_prefill did not launch for the exports")
        if replays["prefill"] or dec.prefill_calls:
            fail("serve_disagg: the prefill side decoded or the decode side prefilled")
        if eager["paged_decode_attention"] or launches["paged_decode_attention"] <= 0:
            fail("serve_disagg: paged_decode_attention did not launch from the decode "
                 "side's graph replays alone")
        if dec.imported_bits_equal != len(bodies):
            fail(f"serve_disagg: {dec.imported_bits_equal} imports checked, not {len(bodies)}")
        _check_hops(pre, dec, "per_layer", bodies, direct, hops)
        # Roles and counters.
        for side, role, direction in ((pre, "prefill", "export"), (dec, "decode", "import")):
            state, m = side.state(), side.metrics()
            count = m.get(("kubeai_engine_kv_handoffs_total", (("direction", direction),)))
            if state["role"] != role or state["pending_handoffs"] != 0 or count != len(bodies):
                fail(f"serve_disagg: {role} server reads role {state['role']}, pending "
                     f"{state['pending_handoffs']}, {direction} handoffs {count}")
            print(f"serve_disagg {role} /v1/state role={state['role']} pending_handoffs="
                  f"{state['pending_handoffs']}; kubeai_engine_kv_handoffs_total"
                  f"{{direction=\"{direction}\"}} {count:.0f}, bytes "
                  f"{m.get(('kubeai_engine_kv_transfer_bytes_total', (('direction', direction),))):.0f}",
                  flush=True)
        # Report: each body's export, transfer, import and TTFT.
        for i, (mode, body) in enumerate(bodies):
            ex, im = pre.exports[i], dec.imports[i]
            h, receipt = ex["handoff"], hops[i]["receipt"]
            t0 = time.perf_counter()
            blob = serialize(h)
            ser_s = time.perf_counter() - t0
            mb = len(blob) / 1e6
            push_s, recv_s = receipt["transfer"]["seconds"], dec.receives[i]
            print(f"serve_disagg body {i} ({mode}) prompt {h.plen} tokens, {h.k_pages.shape[1]} "
                  f"pages, {mb:.3f} MB: export {ex['wall_s'] * 1e3:.3f} ms (prefill "
                  f"{ex['prefill'] * 1e3:.3f}, gather {ex['gather'] * 1e3:.3f} = "
                  f"{h.nbytes() / 1e6 / ex['gather']:.1f} MB/s); serialize "
                  f"{ser_s * 1e3:.3f} ms ({mb / ser_s:.1f} MB/s); push {push_s * 1e3:.3f} ms "
                  f"({mb / push_s:.1f} MB/s); receive {recv_s * 1e3:.3f} ms "
                  f"({mb / recv_s:.1f} MB/s); import {im['import'] * 1e3:.3f} ms; TTFT "
                  f"two-hop {hops[i]['ttft_s']:.4f} s vs direct {direct[i][3]:.4f} s",
                  flush=True)
        del blob
        # The fused decode layout: two bodies (the 317-token prompt).
        fused = _DisaggSide(params, cfg, "decode", "fused", decode_kernel="fused")
        try:
            two = bodies[4:6]
            direct = _direct(fused, two)
            _zero_launches(fused.engine)
            hops = {i: _two_hop(pre, fused, i, body) for i, (_, body) in enumerate(two)}
            got = _launches(fused.engine)
            eager = {name: fn.launches for name, fn in _wrappers().items()}
            print(f"serve_disagg fused launches during the two hops: {json.dumps(got)}; "
                  f"eager {json.dumps(eager)}", flush=True)
            if got["paged_decode_attention_fused"] <= 0 or eager["paged_decode_attention_fused"]:
                fail("serve_disagg fused: paged_decode_attention_fused did not launch from "
                     "the graph replays alone")
            if got["paged_decode_attention"]:
                fail("serve_disagg fused: paged_decode_attention launched")
            _check_hops(pre, fused, "fused", two, direct, hops)
            launches["paged_decode_attention_fused"] = got["paged_decode_attention_fused"]
        finally:
            fused.stop()
    finally:
        pre.stop()
        dec.stop()
    print(f"serve_disagg took {time.perf_counter() - t_phase:.2f} s; card: {gpu_line()}",
          flush=True)
    return launches



def serve_disagg_int8(params, cfg) -> None:
    """A prefill-role and a decode-role EngineServer on int8 pools
    (per_layer, graphs and overlap), the 717-token prompt greedy
    and seeded: each alone to the decode server, then through the two
    hops. Gates: the exported pages and scales are the prefill pool's bits
    in table order; each import writes the handoff's int8 pages and scales
    verbatim; every two-hop stream equals the decode server's own answer;
    B1's int8 read launches on the decode side only from graph replays
    and bf16 B1 not at all. Reports the blob's MB against a bf16
    handoff's and each hop's ms."""
    from kubeai_tpu_torch.disagg.handoff import serialize

    t_phase = time.perf_counter()
    two = _disagg_bodies()[4:6]
    extra = dict(decode_kernel="per_layer", kv_dtype="int8")
    pre = _DisaggSide(params, cfg, "prefill", "int8 prefill", **extra)
    dec = _DisaggSide(params, cfg, "decode", "int8", **extra)
    try:
        direct = _direct(dec, two)
        _zero_launches(dec.engine)
        _zero_launches(pre.engine)
        hops = {}
        for i, (_, body) in enumerate(two):
            hops[i] = _two_hop(pre, dec, i, body)
            h, pages = pre.exports[-1]["handoff"], pre.gathered
            if h.dtype != "int8" or not h.quantized:
                fail(f"serve_disagg int8 body {i}: the handoff is {h.dtype}")
            if not _pages_hold(pre.engine.cache.k_pages, pages, h.k_pages, h.k_scales) or \
                    not _pages_hold(pre.engine.cache.v_pages, pages, h.v_pages, h.v_scales):
                fail(f"serve_disagg int8 body {i}: the exported pages and scales are not "
                     "the prefill pool's")
        got = _launches(dec.engine)
        eager = {name: fn.launches for name, fn in _wrappers().items()}
        print(f"serve_disagg int8 launches during the two hops: {json.dumps(got)}; eager "
              f"{json.dumps(eager)}; pages and scales bit-equal to the prefill pool in "
              f"{len(two)} exports and to the handoff in {dec.imported_bits_equal} imports",
              flush=True)
        if got["paged_decode_attention_int8"] <= 0 or eager["paged_decode_attention_int8"]:
            fail("serve_disagg int8: paged_decode_attention_int8 did not launch from the "
                 "decode side's graph replays alone")
        if got["paged_decode_attention"]:
            fail("serve_disagg int8: paged_decode_attention (bf16) launched")
        if dec.imported_bits_equal != len(two):
            fail(f"serve_disagg int8: {dec.imported_bits_equal} imports checked, not {len(two)}")
        _check_hops(pre, dec, "int8", two, direct, hops)
        for i, (mode, _) in enumerate(two):
            ex, im = pre.exports[i], dec.imports[i]
            h = ex["handoff"]
            mb = len(serialize(h)) / 1e6
            bf16_mb = h.k_pages.size * 2 * 2 / 1e6
            push_s = hops[i]["receipt"]["transfer"]["seconds"]
            print(f"serve_disagg int8 body {i} ({mode}) prompt {h.plen} tokens, "
                  f"{h.k_pages.shape[1]} pages: blob {mb:.3f} MB (bf16 pages alone "
                  f"{bf16_mb:.3f} MB); export {ex['wall_s'] * 1e3:.3f} ms (prefill "
                  f"{ex['prefill'] * 1e3:.3f}, gather {ex['gather'] * 1e3:.3f}); push "
                  f"{push_s * 1e3:.3f} ms; receive {dec.receives[i] * 1e3:.3f} ms; import "
                  f"{im['import'] * 1e3:.3f} ms; TTFT two-hop {hops[i]['ttft_s']:.4f} s vs "
                  f"direct {direct[i][3]:.4f} s", flush=True)
    finally:
        pre.stop()
        dec.stop()
    print(f"serve_disagg int8 took {time.perf_counter() - t_phase:.2f} s", flush=True)


def serve_kv_share(params, cfg) -> None:
    """The cluster KV-sharing tier at full width, on serve_prefix's
    configuration (prefill_chunk=512, prefix_cache=True): two kv_sharing
    EngineServers A and B, A with an in-memory KVSpillStore, B with one
    on a gs:// bucket. A serves
    the 1,024-token system-prompt body (a miss); B gets the same body with
    X-KV-Source naming A and pulls the prefix pages over /v1/kv/export.
    Gates: B's hit tokens equal the cache rule's count, B imported 16
    pages, B's adopted pages are bit-equal to A's, and B's stream equals
    A's for the same body sent again to A (a hit). Then an eviction of A's
    idle pages spills them into A's store (in memory) and
    import_prefix_pages(..., source="spill") fills them back bit-equal;
    the same on B, whose store is a gs:// bucket on a fake GCS
    (--kv-spill-url's path). Reports the fetch's ms and MB/s."""
    import os
    import shutil
    import tempfile

    import torch

    from kubeai_tpu_torch.objstore import KVSpillStore

    t_phase = time.perf_counter()
    extra = dict(decode_kernel="per_layer", prefill_chunk=PREFIX_CHUNK, prefix_cache=True)
    gcs_root = tempfile.mkdtemp(prefix="kubeai-kv-spill-")
    gcs = FakeBucket("gcs", gcs_root)
    saved_env = os.environ.get("STORAGE_EMULATOR_HOST")
    os.environ["STORAGE_EMULATOR_HOST"] = gcs.endpoint
    stores = {"A": KVSpillStore(), "B": KVSpillStore("gs://kv-spill/pages")}
    sides = {name: _DisaggSide(params, cfg, "unified", f"kv_share {name}",
                               server_kw=dict(kv_sharing=True, kv_spill_store=stores[name]),
                               **extra)
             for name in ("A", "B")}
    a, b = sides["A"], sides["B"]
    body = _prefix_waves()[0][0]
    try:
        fetches = []
        fetch = b.server._maybe_fetch_prefix

        def fetch_and_time(*args):
            t0 = time.perf_counter()
            fetch(*args)
            fetches.append(time.perf_counter() - t0)

        b.server._maybe_fetch_prefix = fetch_and_time
        status, res, _, _ = _post(a.server.port, body)
        if status != 200:
            fail(f"serve_kv_share A: HTTP {status} {res}")
        prompt = IdTokenizer().apply_chat_template(body["messages"])
        chain = a.engine.compute_prefix_chain(prompt)
        chain = chain[: (len(prompt) - 1) // SERVE_CONFIG["page_size"]]
        state = a.state()
        if not state["kv_sharing"] or not set(chain) <= set(state["kv_holdings"]):
            fail("serve_kv_share: A does not advertise the body's chain")
        hits = b.engine.prefix_stats["hit_tokens"]
        status, res_b, _, _ = _post(b.server.port, body, headers={"X-KV-Source": a.addr})
        if status != 200:
            fail(f"serve_kv_share B: HTTP {status} {res_b}")
        rid_b = b.last_rid
        status, res_a, _, _ = _post(a.server.port, body)  # now a hit on A
        rid_a = a.last_rid
        want_hits = expected_hits([prompt, prompt], SERVE_CONFIG["page_size"], PREFIX_CHUNK,
                                  SERVE_CONFIG["max_seq_len"])[1]
        got_hits = b.engine.prefix_stats["hit_tokens"] - hits
        imported = b.engine.kv_share_stats["imported_pages"]
        fetched = b.metrics()[("kubeai_kv_fetch_bytes_total", ())]
        print(f"serve_kv_share: chain of {len(chain)} pages; B fetched {imported} pages "
              f"({fetched / 1e6:.3f} MB) in {fetches[0] * 1e3:.3f} ms = "
              f"{fetched / 1e6 / fetches[0]:.1f} MB/s; B hit {got_hits} tokens, the rule "
              f"gives {want_hits}; A exported {a.engine.kv_share_stats['exported_pages']} "
              "pages", flush=True)
        if got_hits != want_hits or imported != len(chain) or len(chain) != 16:
            fail(f"serve_kv_share: B hit {got_hits} tokens (rule {want_hits}), imported "
                 f"{imported} pages of a {len(chain)}-page chain")
        hashes = [bytes.fromhex(h) for h in chain]
        pages_a, pages_b = a.engine._alloc.lookup(hashes), b.engine._alloc.lookup(hashes)
        for pa, pb in ((a.engine.cache.k_pages, b.engine.cache.k_pages),
                       (a.engine.cache.v_pages, b.engine.cache.v_pages)):
            if not torch.equal(pa[:, pages_a], pb[:, pages_b]):
                fail("serve_kv_share: B's adopted pages are not A's bits")
        stream_a, stream_b = a.streams[rid_a], b.streams[rid_b]
        text_a, text_b = (r["choices"][0]["message"]["content"] for r in (res_a, res_b))
        if status != 200 or stream_a != stream_b or text_a != text_b:
            step = _leading_equal(stream_a, stream_b)
            fail(f"serve_kv_share: B's stream differs from A's hit at token {step}")
        print(f"serve_kv_share: B's {len(pages_b)} adopted pages bit-equal to A's; B's stream "
              f"({len(stream_b)} tokens) equals A's for the same body as a hit", flush=True)
        spill_and_fill(a, "A (in memory)", chain)
        spill_and_fill(b, "B (gs:// on a fake GCS)", chain)
        print(f"serve_kv_share B's bucket: {gcs.received} bytes put, {gcs.sent} bytes got",
              flush=True)
    finally:
        for side in sides.values():
            side.stop()
        gcs.stop()
        shutil.rmtree(gcs_root, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("STORAGE_EMULATOR_HOST", None)
        else:
            os.environ["STORAGE_EMULATOR_HOST"] = saved_env
    print(f"serve_kv_share took {time.perf_counter() - t_phase:.2f} s; card: {gpu_line()}",
          flush=True)


def spill_and_fill(side, label: str, chain: list) -> None:
    """Evict `side`'s idle pages into its server's spill store, then fill
    the chain back with import_prefix_pages(..., source="spill"): fails
    unless every page spilled and came back with the bits it left with."""
    import torch

    from kubeai_tpu_torch.disagg.handoff import deserialize_pages

    eng, store = side.engine, side.server.kv_spill
    hashes = [bytes.fromhex(h) for h in chain]
    held = [pool[:, eng._alloc.lookup(hashes)].clone()
            for pool in (eng.cache.k_pages, eng.cache.v_pages)]
    spilled0 = eng.kv_share_stats["spilled_pages"]
    with eng._lock:
        alloc = eng._alloc
        free, alloc._free = alloc._free, []
        taken = [alloc._take_free() for _ in range(alloc.cached_idle_pages)]
        alloc._free = free + taken
    spilled = eng.kv_share_stats["spilled_pages"] - spilled0
    if eng._alloc.lookup(hashes) or spilled < len(chain):
        fail(f"serve_kv_share {label}: the eviction spilled {spilled} pages")
    t0 = time.perf_counter()
    filled = sum(eng.import_prefix_pages(deserialize_pages(store.get(h)), source="spill")
                 for h in chain)
    fill_s = time.perf_counter() - t0
    pages = eng._alloc.lookup(hashes)
    for pool, want in zip((eng.cache.k_pages, eng.cache.v_pages), held):
        if filled != len(chain) or not torch.equal(pool[:, pages], want):
            fail(f"serve_kv_share {label}: the spill fill wrote {filled} pages, not the bits "
                 "spilled")
    print(f"serve_kv_share spill {label}: {spilled} pages spilled ({store.puts} puts), "
          f"{filled} filled back bit-equal in {fill_s * 1e3:.3f} ms "
          f"(kv_share_stats {json.dumps(eng.kv_share_stats)})", flush=True)


def cli_role_pair(model_dir: str) -> None:
    """A `--role prefill` and a `--role decode` process of the entry
    point on the CLI checkpoint, started together: one greedy body goes to
    the decode process alone (the reference) and then through the two
    hops; the texts must be equal and each /v1/state must name its role.
    Both processes drain and exit 0 on SIGTERM."""
    import os
    import signal
    import socket
    import tempfile

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "KUBEAI_TPU_DECODE_KERNEL"}
    env.update(PYTHONPATH=here)
    procs = {}
    try:
        for role in ("prefill", "decode"):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            log_fd, log_path = tempfile.mkstemp(prefix=f"kubeai-role-{role}-", suffix=".log")
            cmd = [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model-url",
                   model_dir, "--port", str(port), "--num-slots", "8", "--max-seq-len",
                   "2048", "--drain-timeout", str(CLI_DRAIN_S), "--watchdog-timeout", "60",
                   "--role", role]
            print(f"serve_cli role pair command: {' '.join(cmd[1:])}", flush=True)
            proc = subprocess.Popen(["timeout", "-k", "10", str(CLI_READY_S + 300), *cmd],
                                    cwd=here, env=env, stdout=log_fd, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            procs[role] = (proc, port, log_fd, log_path)

        def tail(role) -> str:
            with open(procs[role][3]) as f:
                return "".join(f.readlines()[-30:])

        for role, (proc, port, _, _) in procs.items():
            while True:
                if proc.poll() is not None:
                    fail(f"serve_cli {role}: exited {proc.returncode} before ready:\n{tail(role)}")
                try:
                    if _get(port, "/health")[0] == 200:
                        break
                except OSError:
                    pass
                if time.perf_counter() - t_phase > CLI_READY_S:
                    fail(f"serve_cli {role}: not ready within {CLI_READY_S} s:\n{tail(role)}")
                time.sleep(0.25)
        ready_s = time.perf_counter() - t_phase
        pre_port, dec_port = procs["prefill"][1], procs["decode"][1]
        body = _default_bodies()[0][2]  # the 317-token prompt, greedy, unary
        status, direct, _, direct_s = _post(dec_port, body)
        if status != 200:
            fail(f"serve_cli role pair direct: HTTP {status} {direct}")
        t0 = time.perf_counter()
        status, receipt, _, _ = _post(pre_port, body,
                                      headers={"X-Disagg-Transfer": f"127.0.0.1:{dec_port}"})
        if status != 200:
            fail(f"serve_cli role pair prefill hop: HTTP {status} {receipt}")
        status, hop, _, _ = _post(dec_port, body,
                                  headers={"X-Disagg-Handoff": receipt["handoff_id"]})
        hop_s = time.perf_counter() - t0
        want = direct["choices"][0]["message"]["content"]
        got = hop["choices"][0]["message"]["content"] if status == 200 else None
        print(f"serve_cli role pair: both ready {ready_s:.2f} s after start; direct "
              f"{direct_s:.4f} s, two hops {hop_s:.4f} s ({receipt['transfer']['bytes'] / 1e6:.3f} "
              f"MB pushed in {receipt['transfer']['seconds'] * 1e3:.3f} ms); text "
              f"{'equals' if got == want else 'DIFFERS FROM'} the decode process's direct "
              f"answer: {want[:40]!r}", flush=True)
        if got != want:
            fail(f"serve_cli role pair: two-hop text {got!r} differs from direct {want!r}")
        for role, (_, port, _, _) in procs.items():
            state = json.loads(_get(port, "/v1/state")[1])
            if state["role"] != role:
                fail(f"serve_cli role pair: /v1/state.role {state['role']!r}, not {role!r}")
        for role, (proc, _, _, _) in procs.items():
            proc.send_signal(signal.SIGTERM)
        for role, (proc, _, _, _) in procs.items():
            try:
                rc = proc.wait(timeout=CLI_DRAIN_S + 5)
            except subprocess.TimeoutExpired:
                fail(f"serve_cli {role}: no exit after SIGTERM:\n{tail(role)}")
            if rc != 0:
                fail(f"serve_cli {role}: exited {rc} after SIGTERM:\n{tail(role)}")
    finally:
        for proc, _, log_fd, log_path in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            os.close(log_fd)
            os.unlink(log_path)
    print(f"serve_cli role pair: both exit 0 after SIGTERM; took "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)


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
    """torch.profiler over `calls` calls of `call(engine)` (decode calls
    at the serving shapes: all num_slots rows; the requests have
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


def profile_program(engine, unit: str, program: str, calls: int | None = None,
                    eager: bool = True) -> dict:
    """One device program of `engine` ("decode chunk" or "verify window")
    replayed from its CUDA graph `calls` times back to back (default: one
    decode chunk, whose 8 steps already average; two verify windows;
    torch.profiler's processing of its events, not the card, takes most
    of this function's seconds), each dispatch
    read back before the next as a synchronous step does, and, with
    `eager`, the same calls run eagerly (the program's function, through
    the same buffers), in one call: wall time, device time and idle share
    per `unit`, side by side, and the graph pool's memory. Where
    torch.profiler does not see the kernels inside a replay, the device
    time is the CUDA-event span. Returns the graph's wall and device ms
    per `unit` and the kernel launches per `unit` (from the eager profile:
    the same kernels a replay runs; from the graph's without `eager`), and
    that profile's device rows and the units they cover."""
    prog = _programs(engine)[program]
    e_steps = engine._chunk_out.shape[0] if program == "decode chunk" else 1
    calls = calls or (1 if program == "decode chunk" else 2)

    def replay(_):
        prog.read(prog.dispatch())

    def run_eager(_):
        prog.fn()

    graph = profile(engine, f"{unit} graph", replay, e_steps, calls)
    tag = unit.replace(" ", "_")
    if not eager:
        # The eager pass's seconds go to torch.profiler's processing of
        # thousands of launches; the graph alone is the served step.
        device, source = graph["device_ms"], "torch.profiler"
        if device < 0.5 * graph["event_ms"]:
            device, source = graph["event_ms"], "CUDA events"
        print(f"profile {tag} graph: wall {graph['wall_ms']:.3f} ms/{tag}; device "
              f"{device:.3f} [{source}] ms/{tag}; idle share "
              f"{max(0.0, 1 - device / graph['wall_ms']):.3f}; graph pool "
              f"{prog.pool_bytes / 2**20:.2f} MiB", flush=True)
        kernels = sum(e.count for e in graph["rows"]) / graph["steps"]
        return {"wall_ms": graph["wall_ms"], "device_ms": device, "kernels": kernels,
                "rows": graph["rows"], "steps": graph["steps"]}
    eager_run = profile(engine, f"{unit} eager", run_eager, e_steps, calls)
    if eager_run["device_ms"] <= 0:
        fail(f"profile {unit}: torch.profiler recorded no device kernels")
    device, source = graph["device_ms"], "torch.profiler"
    if device < 0.5 * eager_run["device_ms"]:
        device = graph["event_ms"]
        source = ("CUDA events (torch.profiler attributed "
                  f"{graph['device_ms']:.3f} ms to the replay)")
    print(f"profile {tag} graph vs eager: wall {graph['wall_ms']:.3f} vs "
          f"{eager_run['wall_ms']:.3f} ms/{tag}; device {device:.3f} [{source}] vs "
          f"{eager_run['device_ms']:.3f} ms/{tag}; idle share "
          f"{max(0.0, 1 - device / graph['wall_ms']):.3f} vs "
          f"{max(0.0, 1 - eager_run['device_ms'] / eager_run['wall_ms']):.3f}; graph pool "
          f"{prog.pool_bytes / 2**20:.2f} MiB", flush=True)
    kernels = sum(e.count for e in eager_run["rows"]) / eager_run["steps"]
    return {"wall_ms": graph["wall_ms"], "device_ms": device, "kernels": kernels,
            "rows": eager_run["rows"], "steps": eager_run["steps"]}


def profile_prefill(params, cfg, model=None, buckets=(512, 1024), tag: str = "") -> dict:
    """torch.profiler over `model`.prefill (default llama), the function
    Engine._prefill_admit calls, at B=1 for `buckets` (default the serve
    phase's two long buckets, 512 and 1024, on the 8B-shape weights):
    device time by kernel, the idle share, and B2's device ms and launches
    per admission. This is the layer number that ties B2 to TTFT. Returns
    {bucket: (device ms, B2 launches) per admission}."""
    import torch

    if model is None:
        from kubeai_tpu_torch.models import llama as model

    gen = torch.Generator("cuda").manual_seed(12)
    out = {}
    for S in buckets:
        toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen, device="cuda")
        lengths = torch.tensor([S], device="cuda")
        prof = profile(None, f"{tag}prefill S={S}",
                       lambda _: model.prefill(params, cfg, toks, lengths),
                       e_steps=1, calls=1)
        rows, steps = prof["rows"], prof["steps"]
        total = sum(getattr(e, "self_device_time_total", 0) for e in rows)
        b2 = [e for e in rows if "flash_prefill_kernel" in e.key]
        if not b2:
            fail(f"prefill S={S}: the profile shows no flash_prefill_kernel")
        b2_us = sum(getattr(e, "self_device_time_total", 0) for e in b2)
        launches = sum(e.count for e in b2) / steps
        print(f"profile {tag}prefill_S={S} B2 {b2_us / 1e3 / steps:.4f} ms in "
              f"{launches:.0f} launches per admission, "
              f"{b2_us / max(total, 1):.3f} of its device time", flush=True)
        out[S] = (prof["device_ms"], launches)
    return out


# ---- serve_gemma: Gemma-2-9B shapes at full depth ----------------------------------

# HF google/gemma-2-9b config.json, all 42 layers: head_dim 256, a sliding
# window of 4096 on the even layers, attention softcap 50, final softcap 30.
GEMMA_9B = dict(
    vocab_size=256000, hidden_size=3584, intermediate_size=14336, num_layers=42,
    num_heads=16, num_kv_heads=8, head_dim=256, rope_theta=10000.0, rms_norm_eps=1e-6,
    max_position_embeddings=8192, sandwich_norms=True, final_logit_softcapping=30.0,
    attn_logit_softcapping=50.0, query_pre_attn_scalar=256, sliding_window=4096,
)
# serve_gemma serves Gemma-2-9B's width at this depth (an even count: half
# the layers windowed), every gate kept; the kernel phase holds B1 and B4 at
# its full shapes. 8 layers leave the smoke's time to serve_mixtral.
GEMMA_9B_LAYERS = 8
# 384 pages of 64 tokens (344 KB of K/V a token: 8.5 GB a pool pair) hold
# both prefix waves' pages with room; a slot's 8,192 tokens take 128.
GEMMA_SERVE_CONFIG = dict(num_slots=8, max_seq_len=8192, page_size=64, decode_chunk=8,
                          num_pages=1 + 3 * 128)


def _gemma_bodies(again: bool = False) -> list[dict]:
    """Four chat completions of about 28, 317, 1,100 and 4,200 prompt
    tokens, 32 completion tokens each: the second seeded, the last
    streamed. The 4,200-token context passes Gemma-2's window of 4,096,
    so the window masks keys in served decode. Each prompt is alone in its
    prefill bucket (32, 512, 2048, 8192), so the served and the eager
    engine admit them alike. With `again`, each content gains a short
    tail: a second wave whose prompts share their first pages with the
    first wave's (prefix hits) and whose lengths differ from them."""
    text = "The quick brown fox jumps over the lazy dog. "
    contents = ["Hello there", (text * 7)[:300], (text * 25)[:1083], (text * 93)[:4183]]
    bodies = []
    for j, content in enumerate(contents):
        body = {"messages": [{"role": "user", "content": content + (f" Again {j}." if again
                                                                     else "")}],
                "max_tokens": 32, "temperature": 0}
        if j == 1:
            body.update(temperature=0.8, seed=3 if again else 2)
        if j == 3:
            body["stream"] = True
        bodies.append(body)
    return bodies


def gemma_weights(shape: dict = GEMMA_9B, name: str = "Gemma-2-9B"):
    """(random weights of `shape` on cuda, all its layers, made from a
    seed; the config), after one prefill's shapes and finite logits (and
    Gemma-2's final softcap) are checked."""
    import torch

    from kubeai_tpu_torch.models import gemma

    cfg = gemma.GemmaConfig(**shape)
    t0 = time.perf_counter()
    params = gemma.init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.nbytes for t in [params["embed"], params["final_norm"],
                                     *params["layers"].values()])
    print(f"serve_gemma: random {name}-shape weights on cuda, {n_bytes / 1e9:.3f} GB "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
        logits, k_all, _ = gemma.prefill(params, cfg, toks, torch.tensor([64], device="cuda"))
    want_k = (cfg.num_layers, 1, 64, cfg.num_kv_heads, cfg.head_size)
    if tuple(logits.shape) != (1, cfg.vocab_size) or tuple(k_all.shape) != want_k:
        fail(f"{name} prefill shapes {tuple(logits.shape)} {tuple(k_all.shape)}")
    if not torch.isfinite(logits).all():
        fail(f"{name} prefill logits are not finite")
    cap = cfg.final_logit_softcapping
    if cap and float(logits.abs().max()) > cap:
        fail(f"{name} logits pass the final softcap")
    del logits, k_all
    return params, cfg


def _gemma_gates(label: str, run: dict, decode: str, gemma2: bool = True) -> None:
    """What every gemma serve run must show: its decode kernel launched
    and the other decode kernels not at all; for Gemma-2, B2 not at all
    (its prefill is the plain attention, as in the JAX package) and a
    served context past the window."""
    launched = run["launches"]
    if launched[decode] <= 0:
        fail(f"serve {label}: main path never launched {decode}")
    others = ["paged_decode_attention", "paged_decode_attention_fused",
              "paged_verify_attention", "paged_decode_attention_int8"]
    for name in others + ["flash_causal_prefill"] * gemma2:
        if name != decode and launched[name]:
            fail(f"serve {label}: {name} launched {launched[name]} times")
    if not gemma2:
        return
    longest = max(len(p) for p, *_ in run["requests"].values())
    if longest <= GEMMA_9B["sliding_window"]:
        fail(f"serve {label}: no served context passes the window ({longest} tokens)")
    print(f"serve {label}: the longest served context ({longest} prompt tokens) passes "
          f"the window of {GEMMA_9B['sliding_window']}", flush=True)


# The whole-prompt gemma serve runs: (label, decode kernel, engine
# settings, whether the decode step is also profiled eagerly). Only the
# per_layer step keeps its eager profile: torch.profiler's processing of
# an eager gemma step's ~3,000 launches took ~20 s a pass, on ~1 s of
# calls, and the other runs are compared graph to graph.
GEMMA_RUNS = (("per_layer", "paged_decode_attention", dict(decode_kernel="per_layer"), True),
              ("fused", "paged_decode_attention_fused", dict(decode_kernel="fused"), False),
              ("int8", "paged_decode_attention_int8",
               dict(decode_kernel="per_layer", kv_dtype="int8"), False))


def serve_gemma(shape: dict = GEMMA_9B, name: str = "Gemma-2-9B", tag: str = "gemma") -> dict:
    """Phase 4b (Gemma-2, the default) and 4c (Gemma-1: GEMMA_7B, tag
    "gemma1"): random weights of `shape` at full depth (`gemma_weights`),
    served with GEMMA_SERVE_CONFIG, graphs and overlap: the four
    `_gemma_bodies` (each alone in its bucket, the longest at 8192)
    per_layer (B1 at head_dim 256; Gemma-2's softcap 50 and window of
    4,096 on alternate layers), fused (B4 at head_dim 256) and per_layer on
    int8 pools (B1-int8 at head_dim 256), then `gemma_prefix_run`, and for
    Gemma-2 the prefix run again on int8 pools. Gates: `_gemma_gates`,
    every stream equal to an eager synchronous engine's (an int8 one for
    the int8 runs); on int8 pools `check_int8_pools` (num_layers launches
    of B1-int8 a step, pool bytes); for Gemma-1, B2 (head_dim 256)
    launches num_layers times in every prefill admission of the
    whole-prompt runs, counted. Profiles the decode step from its graph in
    each run (per_layer eagerly too) and, for Gemma-1, one 8192-bucket
    prefill admission (B2's device ms). Returns the head_dim-256 kernels'
    launches in the whole-prompt runs: B1's, B4's and B1-int8's for
    Gemma-2, B2's for Gemma-1."""
    import gc

    import torch

    from kubeai_tpu_torch.models import gemma

    t_phase = time.perf_counter()
    params, cfg = gemma_weights(shape, name)
    gemma2 = cfg.sandwich_norms
    launches = {} if gemma2 else {"flash_causal_prefill_d256": 0}
    steps = {}
    for layout, decode, extra, eager in GEMMA_RUNS:
        label = f"{tag} {layout}"
        run = serve_run(params, cfg, label, waves=[_gemma_bodies()], family="gemma",
                        config=GEMMA_SERVE_CONFIG, **extra)
        _gemma_gates(label, run, decode, gemma2)
        if extra.get("kv_dtype") == "int8":
            check_int8_pools(label, run["engine"], cfg.num_layers)
        if gemma2:
            launches[f"{decode}_d256"] = run["launches"][decode]
        else:
            b2, admitted = run["launches"]["flash_causal_prefill"], run["admissions"]
            print(f"serve {label}: flash_causal_prefill (head_dim 256) launched {b2} times "
                  f"in {admitted} prefill admissions ({cfg.num_layers} layers)", flush=True)
            if admitted < 1 or b2 != cfg.num_layers * admitted:
                fail(f"serve {label}: B2 launched {b2} times in {admitted} admissions, "
                     f"not {cfg.num_layers} an admission")
            if layout != "int8":
                launches["flash_causal_prefill_d256"] += b2
        check_streams_equal_eager(params, cfg, label, run, **extra)
        steps[layout] = profile_program(run["engine"], f"{label} decode step", "decode chunk",
                                        eager=eager)
        free(run)
    print(f"serve {tag} decode step from its graph on int8 pools: wall "
          f"{steps['int8']['wall_ms']:.3f} ms, device {steps['int8']['device_ms']:.3f} ms; "
          f"on bf16 pools (per_layer): wall {steps['per_layer']['wall_ms']:.3f} ms, device "
          f"{steps['per_layer']['device_ms']:.3f} ms", flush=True)
    if not gemma2:
        profile_prefill(params, cfg, model=gemma, buckets=(8192,), tag=f"{tag} ")
    gemma_prefix_run(params, cfg, f"{tag} prefix", gemma2)
    if gemma2:
        gemma_prefix_run(params, cfg, f"{tag} prefix int8", gemma2, int8=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve {tag} took {time.perf_counter() - t_phase:.2f} s; card: {gpu_line()}",
          flush=True)
    return launches


def check_int8_pools(label: str, engine, num_layers: int) -> None:
    """An engine on int8 pools: kv_cache_info reports them (dtype int8,
    D + 4 bytes a token and kv head a pool), their GiB against bf16 pools
    of the same pages, and, in a decode-chunk replay, B1-int8 launches
    once a layer and step (num_layers x the chunk's steps)."""
    info = engine.kv_cache_info()
    nl, n_pages, page, kvh, d = engine.cache.pages_shape
    bf16_bytes = 2 * nl * n_pages * page * kvh * d * 2
    if not info["quantized"] or info["dtype"] != "int8" or info["pool_bytes"] != (
            2 * nl * n_pages * page * kvh * (d + 4)):
        fail(f"serve {label}: kv_cache_info {info}")
    print(f"serve {label} pools: {info['pool_bytes'] / 2**30:.4f} GiB of int8 pages and "
          f"scales against {bf16_bytes / 2**30:.4f} GiB for the same {n_pages} pages in bf16 "
          f"(x{info['pool_bytes'] / bf16_bytes:.4f}); kv_cache_info {json.dumps(info)}",
          flush=True)
    per_replay = _programs(engine)["decode chunk"].launches_per_replay
    want = num_layers * engine._chunk_out.shape[0]
    if per_replay.get("paged_decode_attention_int8") != want:
        fail(f"serve {label}: B1-int8 launches per decode-chunk replay {per_replay}, not "
             f"{num_layers} layers x {engine._chunk_out.shape[0]} steps = {want}")


def gemma_prefix_run(params, cfg, label: str, gemma2: bool, int8: bool = False) -> None:
    """`prefill_chunk=512, prefix_cache=True` (per_layer) over two waves
    of `_gemma_bodies` whose second hits the first's pages, on int8 pools
    with `int8`. Gates: `_gemma_gates` (B1, or B1-int8 with `int8`), the
    staged-chunk programs dispatched only as graph replays, hit tokens the
    cache rule's (for Gemma-2 with more than a window of them in wave 2)
    and the eager synchronous engine's, every stream equal to that
    engine's."""
    extra = dict(decode_kernel="per_layer", prefill_chunk=PREFIX_CHUNK, prefix_cache=True)
    if int8:
        extra["kv_dtype"] = "int8"
    run = serve_run(params, cfg, label, waves=[_gemma_bodies(), _gemma_bodies(again=True)],
                    family="gemma", config=GEMMA_SERVE_CONFIG, **extra)
    _gemma_gates(label, run, "paged_decode_attention_int8" if int8 else
                 "paged_decode_attention", gemma2)
    if run["stage_calls"]:
        fail(f"serve {label}: staged-chunk functions ran outside their graphs: "
             f"{run['stage_calls']}")
    for name in ("mid chunk", "final chunk", "prefix gather"):
        if run["dispatches"].get(name, 0) <= 0:
            fail(f"serve {label}: the {name} program was never dispatched")
    order = sorted(run["requests"])
    per = expected_hits([run["requests"][rid][0] for rid in order],
                        GEMMA_SERVE_CONFIG["page_size"], PREFIX_CHUNK,
                        GEMMA_SERVE_CONFIG["max_seq_len"])
    stats = dict(run["engine"].prefix_stats)
    wave2 = sum(dict(zip(order, per))[rid] for rid in run["waves"][1])
    print(f"serve {label} prefix_stats {json.dumps(stats)}; the cache rule gives "
          f"{sum(per)} hit tokens ({wave2} in wave 2); B2 launched "
          f"{run['launches']['flash_causal_prefill']} times in {run['admissions']} "
          "whole-prompt admissions", flush=True)
    if stats["hit_tokens"] != sum(per) or (gemma2 and wave2 <= GEMMA_9B["sliding_window"]):
        fail(f"serve {label}: {stats['hit_tokens']} hit tokens, the rule gives {sum(per)} "
             f"({wave2} in wave 2)")
    ref = check_streams_equal_eager(params, cfg, label, run, **extra)
    if ref.prefix_stats["hit_tokens"] != stats["hit_tokens"]:
        fail(f"serve {label}: eager engine hit {ref.prefix_stats['hit_tokens']} tokens, "
             f"the served engine {stats['hit_tokens']}")
    del ref
    free(run)


# ---- serve_gemma1: Gemma-7B shapes -------------------------------------------------

# HF google/gemma-7b config.json, all 28 layers: 16 heads over 16 kv heads
# at head_dim 256, no softcaps and no window, so whole-prompt prefill runs
# through B2's head_dim-256 build. 8.54 B parameters (17.1 GB in bf16);
# 448 KiB of K/V a token, 11.3 GB a pool pair at GEMMA_SERVE_CONFIG's 385
# pages. Served by `serve_gemma(GEMMA_7B, "Gemma-7B", "gemma1")`.
GEMMA_7B = dict(
    vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_layers=28,
    num_heads=16, num_kv_heads=16, head_dim=256, rope_theta=10000.0, rms_norm_eps=1e-6,
    max_position_embeddings=8192,
)
# The smoke serves Gemma-7B's width at this depth, every gate kept (B2 once
# a layer in every admission): the int8-weight and the mixtral phases took
# the time.
GEMMA_7B_LAYERS = 8


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


# The --draft-url run's draft: the CLI checkpoint's width at 2 layers,
# drawn from another seed.
CLI_DRAFT_CONFIG = dict(CLI_CONFIG, num_hidden_layers=2)


def cli_tensors(c: dict = CLI_CONFIG, seed: int = 1) -> dict:
    """Random bf16 tensors under their Hugging Face names for the llama
    checkpoint config `c` (default CLI_CONFIG), drawn on the card from
    `seed` as `llama.init_params` draws them (N(0, 0.02), norms 1) and
    kept on the host for the writer."""
    import torch

    E, M, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    HD, KD = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    gen = torch.Generator("cuda").manual_seed(seed)

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


def check_loaded_bits(params: dict, tensors: dict, leaves=CLI_LEAVES,
                      layer_leaves=CLI_LAYER_LEAVES, num_layers: int = CLI_LAYERS) -> int:
    """Fails unless every leaf `load_params` put on the card is bit-equal
    to the tensor written (transposed where the port's layout is
    [in, out]); the leaves default to the llama checkpoint's. Returns the
    leaves checked."""
    import torch

    pairs = [(params[leaf], name, t) for leaf, name, t in leaves]
    for i in range(num_layers):
        pairs += [(params["layers"][leaf][i], f"model.layers.{i}.{name}", t)
                  for leaf, name, t in layer_leaves]
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
# runs B1 and B2; speculation runs B3 in every decode call. (The fused
# layout chosen by the environment, B4, is served through the CLI by
# serve_sharded_cli's part (a).) "{draft}" in the flags is the draft
# checkpoint's directory, "{s3}" the checkpoint's URL on a fake S3, "{gs}"
# a snapshot bucket on a fake GCS
# and "{work}" the run's own staging directory. The first three runs are
# the object-store boots: a full load that publishes its snapshot after
# the warm-up; the same flags from a copy of the package whose build/ is
# empty ("restored": it must restore the tree and the kernel library, so
# no nvcc runs); and another engine config with --snapshot-no-publish (a
# miss, then a full load).
SPEC_FLAGS = ["--speculate", "4", "--spec-adaptive", "off"]
SPEC_CONFIG = dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False)
BOOT_FLAGS = ["--model-url", "{s3}", "--snapshot-url", "{gs}", "--snapshot-dir", "{work}"]
CLI_RUNS = (
    ("speculate", [*SPEC_FLAGS, *BOOT_FLAGS], {}, SPEC_CONFIG),
    ("restored", [*SPEC_FLAGS, *BOOT_FLAGS], {}, SPEC_CONFIG),
    ("default", [*BOOT_FLAGS, "--snapshot-no-publish"], {}, dict(decode_kernel="per_layer")),
    ("draft", ["--speculate", "4", "--spec-adaptive", "off", "--draft-url", "{draft}"], {},
     dict(decode_kernel="per_layer", speculate=4, spec_adaptive=False)),
    ("int8", ["--quantization", "int8"], {}, dict(decode_kernel="per_layer", quantization="int8")),
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


class FakeBucket:
    """A GCS (JSON API) or S3 (path-style REST) fake on 127.0.0.1 over a
    directory, for the boots through `--model-url s3://...`,
    `--snapshot-url gs://...` and the KV spill to gs://: objects are
    files under <root>/<bucket>/<name>; downloads honour Range and go out
    with sendfile; uploads stream to a private name renamed into place.
    It counts the bytes it sends and receives. Its rates measure this
    host and a Python server, not a cloud bucket."""

    def __init__(self, kind: str, root: str):
        import os
        import urllib.parse
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        bucket_fake = self
        self.kind, self.root = kind, root
        self.sent = self.received = 0
        self._lock = threading.Lock()

        def path_of(bucket: str, name: str) -> str:
            return os.path.join(root, bucket, *name.split("/"))

        def listed(bucket: str, prefix: str) -> list[tuple[str, int]]:
            base, out = os.path.join(root, bucket), []
            for d, _, files in os.walk(base):
                for f in files:
                    if f.endswith(".inflight"):
                        continue
                    full = os.path.join(d, f)
                    name = os.path.relpath(full, base).replace(os.sep, "/")
                    if name.startswith(prefix):
                        out.append((name, os.path.getsize(full)))
            return sorted(out)

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def send(self, status: int, body: bytes = b"", ctype="application/json"):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def send_object(self, bucket: str, name: str):
                path = path_of(bucket, name)
                if not os.path.isfile(path):
                    return self.send(404, b"{}")
                size = os.path.getsize(path)
                rng = self.headers.get("Range")
                start, end = 0, size - 1
                if rng:
                    a, _, b = rng.removeprefix("bytes=").partition("-")
                    start, end = int(a), min(int(b), size - 1) if b else size - 1
                self.send_response(206 if rng else 200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(end - start + 1))
                if rng:
                    self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
                self.end_headers()
                with open(path, "rb") as f:
                    self.connection.sendfile(f, start, end - start + 1)
                with bucket_fake._lock:
                    bucket_fake.sent += end - start + 1

            def receive(self, bucket: str, name: str):
                path = path_of(bucket, name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                left = n = int(self.headers.get("Content-Length", 0))
                buf = memoryview(bytearray(1 << 20))
                with open(path + ".inflight", "wb") as f:
                    while left:
                        got = self.rfile.readinto(buf[:min(left, len(buf))])
                        if not got:
                            return self.send(400, b"{}")
                        f.write(buf[:got])
                        left -= got
                os.replace(path + ".inflight", path)
                with bucket_fake._lock:
                    bucket_fake.received += n
                self.send(200, b"{}")

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                q = urllib.parse.parse_qs(parsed.query)
                parts = parsed.path.split("/")
                if kind == "gcs" and parsed.path.startswith("/download/storage/v1/b/"):
                    return self.send_object(parts[5], urllib.parse.unquote(parts[7]))
                if kind == "gcs" and parsed.path.startswith("/storage/v1/b/"):
                    items = [{"name": n, "size": str(z)}
                             for n, z in listed(parts[4], q.get("prefix", [""])[0])]
                    return self.send(200, json.dumps({"items": items}).encode())
                if kind == "s3":
                    bucket, _, key = parsed.path.lstrip("/").partition("/")
                    if "list-type" in q:
                        contents = "".join(
                            f"<Contents><Key>{n}</Key><Size>{z}</Size></Contents>"
                            for n, z in listed(bucket, q.get("prefix", [""])[0]))
                        return self.send(200, (
                            "<ListBucketResult><IsTruncated>false</IsTruncated>"
                            f"{contents}</ListBucketResult>").encode(), "application/xml")
                    return self.send_object(bucket, urllib.parse.unquote(key))
                self.send(404, b"{}")

            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                if kind == "gcs" and parsed.path.startswith("/upload/storage/v1/b/"):
                    name = urllib.parse.parse_qs(parsed.query)["name"][0]
                    return self.receive(parsed.path.split("/")[5], name)
                self.send(404, b"{}")

            def do_PUT(self):
                if kind != "s3":
                    return self.send(404, b"{}")
                bucket, _, key = urllib.parse.urlparse(self.path).path.lstrip("/").partition("/")
                self.receive(bucket, urllib.parse.unquote(key))

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

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
            ckpt_bytes: int, sink: OtlpSink, admin=None, root: str | None = None) -> dict:
    """One `python -m kubeai_tpu_torch.engine.server` run over `model_dir`
    (unless `flags` name a --model-url) in a subprocess of its own
    session, from the checkout or from `root`, a copy of the package
    (its working directory and PYTHONPATH): ready within CLI_READY_S, the
    four requests of `_default_bodies` sent together (all 200), /metrics
    and /v1/state read, then /v1/drain (a new request gets 503, no slot
    stays active) and SIGTERM (exit 0 within the drain budget). Returns
    the responses' texts, the streamed token ids, the completion tokens
    the responses report, the state read before the drain, the /metrics
    values the phase gates, the seconds to Ready and the server's log
    lines about weights, downloads and snapshots. The server exports its spans to
    `sink` (OTEL_EXPORTER_OTLP_TRACES_ENDPOINT); `check_trace` runs
    before the drain, then `admin(port)` when given."""
    import os
    import signal
    import socket
    import tempfile

    from kubeai_tpu_torch.metrics.registry import hist_buckets

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    source = [] if "--model-url" in flags else ["--model-url", model_dir]
    cmd = [sys.executable, "-m", "kubeai_tpu_torch.engine.server",
           *source, "--port", str(port), "--num-slots", "8",
           "--max-seq-len", "2048", "--drain-timeout", str(CLI_DRAIN_S),
           "--watchdog-timeout", "60", *flags]
    env_text = " ".join(f"{k}={v}" for k, v in env_extra.items())
    print(f"serve_cli {label} command: {env_text} {' '.join(cmd[1:])}".replace("  ", " "),
          flush=True)
    here = root or os.path.dirname(os.path.abspath(__file__))
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
        how = "restore" if cold["restored"] else "load"
        load_s = cold["phases"][how]
        print(f"serve_cli {label} cold start (/v1/state): phases_s "
              f"{json.dumps({k: round(v, 4) for k, v in cold['phases'].items()})} total_s "
              f"{cold['total_s']:.4f}; events {cold['events']}; ready {ready_s:.2f} s after "
              f"the process started; {how} {ckpt_bytes / 1e9:.3f} GB in {load_s:.4f} s = "
              f"{ckpt_bytes / 1e9 / load_s:.3f} GB/s", flush=True)
        print(f"serve_cli {label} TTFT (/metrics): count {ttft_count:.0f}, mean "
              f"{ttft_sum / max(1, ttft_count):.4f} s; bucket upper bound -> rid "
              f"{json.dumps(state['exemplars']['ttft'])}; the streamed request's first "
              f"chunk at {streamed_first:.4f} s (client); spec_stats "
              f"{json.dumps(state['spec_stats'])}", flush=True)
        # After /metrics and /v1/state were read: the gates count the
        # four requests above.
        check_trace(port, sink, label)
        if admin is not None:
            admin(port)
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
        weights_log, log = [], []
        with open(log_path) as f:
            for line in f:
                if any(k in line for k in ("tokenizer:", "drain complete", "weights:",
                                           "downloaded", "snapshot")):
                    print(f"serve_cli {label} log: {line.strip()}", flush=True)
                    log.append(line.strip())
                if "weights:" in line:
                    weights_log.append(line.strip())
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
            "state": state, "metrics": metric_values, "bodies": bodies,
            "weights_log": weights_log, "log": log, "ready_s": ready_s}


def cli_admin_round(port: int, dirs: dict, served: str = "model") -> None:
    """The LoRA admin round over HTTP on a CLI server (the default
    --max-adapters 4): load "tenant" from the PEFT directory dirs["a"];
    /v1/models and /v1/state.adapters list it; a chat completion naming it
    is served in full; loading the same path again answers "already
    loaded" and another path (dirs["b"]) reloads; an unknown model name
    gets 404; unloading twice gives 200, then 404."""
    def admin(path: str, body: dict) -> tuple[int, dict]:
        status, res, _, _ = _post(port, body, path=path)
        return status, res

    t0 = time.perf_counter()
    load = {"lora_name": "tenant", "lora_path": dirs["a"]}
    got = admin("/v1/load_lora_adapter", load)
    if got != (200, {"status": "loaded", "lora_name": "tenant"}):
        fail(f"serve_cli admin: load from {dirs['a']}: {got}")
    load_s = time.perf_counter() - t0
    models = [m["id"] for m in json.loads(_get(port, "/v1/models")[1])["data"]]
    adapters = json.loads(_get(port, "/v1/state")[1])["adapters"]
    if models != [served, "tenant"] or adapters != ["tenant"]:
        fail(f"serve_cli admin: /v1/models {models}, /v1/state.adapters {adapters}")
    body = {**_default_bodies()[0][0], "max_tokens": 16}
    results = {}
    for model in (served, "tenant"):
        status, res, _, total_s = _post(port, {**body, "model": model})
        if status != 200 or res["usage"]["completion_tokens"] < 1 or res["model"] != model:
            fail(f"serve_cli admin: a request for {model}: HTTP {status} {res}")
        results[model] = (res["choices"][0]["message"]["content"], total_s,
                          res["usage"]["completion_tokens"])
    again = admin("/v1/load_lora_adapter", load)
    if again[0] != 200 or again[1].get("status") != "already loaded":
        fail(f"serve_cli admin: loading the same path again: {again}")
    other = admin("/v1/load_lora_adapter", {"lora_name": "tenant", "lora_path": dirs["b"]})
    if other != (200, {"status": "loaded", "lora_name": "tenant"}):
        fail(f"serve_cli admin: loading another path: {other}")
    unknown = _post(port, {**body, "model": "no-such-adapter"})[0]
    if unknown != 404:
        fail(f"serve_cli admin: an unknown model got HTTP {unknown}, not 404")
    unloads = [admin("/v1/unload_lora_adapter", {"lora_name": "tenant"})[0] for _ in range(2)]
    if unloads != [200, 404]:
        fail(f"serve_cli admin: two unloads gave {unloads}, not [200, 404]")
    same = results[served][0] == results["tenant"][0]
    print(f"serve_cli admin round: load from a PEFT directory 200 in {load_s:.3f} s; "
          f"/v1/models {models}; /v1/state.adapters {adapters}; the tenant request served "
          f"{results['tenant'][2]} tokens in {results['tenant'][1]:.4f} s ({'the same text as' if same else 'other text than'} "
          f"the base model's); same path again {again[1]['status']!r}; another path "
          f"{other[1]['status']!r}; unknown model 404; unloads {unloads}", flush=True)


def check_cli_run(label: str, run: dict, engine) -> None:
    """A `cli_run`'s gates against `engine`, built in-process on the card
    with the run's configuration from the same checkpoint: the same token
    capacity, each greedy stream served over HTTP equal to the engine's
    (the streamed one by its token ids too), and on /metrics the requests
    sent, a TTFT count of as many and the generated tokens the responses
    report."""
    from kubeai_tpu_torch.engine import SamplingParams
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    bodies = run["bodies"]
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


def cli_s3_adapter(port: int, url: str) -> None:
    """An adapter loaded through `lora_url` from the fake S3 on a CLI
    server: the load answers 200 "loaded", a request naming it is served
    in full, and it unloads."""
    t0 = time.perf_counter()
    status, res, _, _ = _post(port, {"lora_name": "s3-tenant", "lora_url": url},
                              path="/v1/load_lora_adapter")
    if (status, res) != (200, {"status": "loaded", "lora_name": "s3-tenant"}):
        fail(f"serve_cli restored: loading an adapter from {url}: HTTP {status} {res}")
    load_s = time.perf_counter() - t0
    body = {**_default_bodies()[0][0], "max_tokens": 8, "model": "s3-tenant"}
    status, res, _, total_s = _post(port, body)
    if status != 200 or res["usage"]["completion_tokens"] < 1 or res["model"] != "s3-tenant":
        fail(f"serve_cli restored: a request for the s3:// adapter: HTTP {status} {res}")
    tokens = res["usage"]["completion_tokens"]
    status, res, _, _ = _post(port, {"lora_name": "s3-tenant"}, path="/v1/unload_lora_adapter")
    if status != 200:
        fail(f"serve_cli restored: unloading the s3:// adapter: HTTP {status} {res}")
    print(f"serve_cli restored: adapter loaded through lora_url {url} in {load_s:.3f} s; "
          f"a request naming it served {tokens} tokens in {total_s:.4f} s; unloaded",
          flush=True)


def _logged_seconds(run: dict, word: str) -> float:
    """The seconds at the end of the server's log line holding `word`
    ("downloaded ... in 3.141 s")."""
    for line in run["log"]:
        if word in line:
            return float(re.search(r"in ([0-9.]+) s", line).group(1))
    fail(f"serve_cli: no {word!r} line in the server's log: {run['log']}")


def check_boots(runs: dict, tensors: dict, ckpt_bytes: int, gcs: FakeBucket, snap_url: str,
                copy_root: str) -> None:
    """The object-store boots' gates: snapshot events `absent, published`,
    then `restored`, then `absent`; one fingerprint for the two speculate
    boots and another for the changed config; the restored boot put the
    snapshot's kernel library into its copy's empty build/ and ran no nvcc
    (the build directory holds the library alone, no objects, no log);
    the snapshot's tree bit-equal to the tensors written and its library
    the one this run built. Reports seconds to Ready, every phase, the
    nvcc seconds the restored boot skipped, and the GB/s of a restore
    against a load through the fake S3."""
    import os

    from kubeai_tpu_torch.engine.weights import load_native_checkpoint
    from kubeai_tpu_torch.objstore import parse_url
    from kubeai_tpu_torch.ops import _build

    cold = {label: runs[label]["state"]["cold_start"]
            for label in ("speculate", "restored", "default")}
    events = [cold[k]["events"] for k in ("speculate", "restored", "default")]
    if events != [["absent", "published"], ["restored"], ["absent"]]:
        fail(f"serve_cli boots: snapshot events {events}, not published, restored, absent")
    fp = cold["speculate"]["fingerprint"]
    if cold["restored"]["fingerprint"] != fp or cold["default"]["fingerprint"] == fp:
        fail(f"serve_cli boots: fingerprints {[c['fingerprint'] for c in cold.values()]}")
    lib_dir = os.path.join(copy_root, "build", "kernels", _build.build_dir().name)
    listing = sorted(os.listdir(lib_dir)) if os.path.isdir(lib_dir) else []
    if listing != [_build.LIB_NAME] or not any(
            lib_dir in line for line in runs["restored"]["log"] if "restored snapshot" in line):
        fail(f"serve_cli restored: the copy's build directory holds {listing} (nvcc ran, or "
             f"no library was restored); log {runs['restored']['log']}")
    _, bucket, prefix = parse_url(snap_url)
    key = os.path.join(gcs.root, bucket, *prefix.split("/"), "model", fp)
    with open(os.path.join(key, "kernels", _build.build_dir().name, _build.LIB_NAME), "rb") as a:
        with open(_build.installed_library(), "rb") as b:
            if a.read() != b.read():
                fail("serve_cli boots: the snapshot's kernel library is not this run's build")
    import torch

    snap_bytes = os.path.getsize(os.path.join(key, "params", "params.safetensors"))
    params = load_native_checkpoint(os.path.join(key, "params"), "cuda")
    n = check_loaded_bits(params, tensors)
    del params
    torch.cuda.empty_cache()
    full, restored, missed = (cold[k]["phases"] for k in ("speculate", "restored", "default"))
    download_s = _logged_seconds(runs["speculate"], "downloaded")
    load_rate = ckpt_bytes / 1e9 / (download_s + full["load"])
    restore_rate = snap_bytes / 1e9 / (restored["fetch"] + restored["restore"])
    for label in ("speculate", "restored", "default"):
        c = cold[label]
        print(f"serve_cli boot {label}: events {c['events']}, fingerprint {c['fingerprint']}, "
              f"ready {runs[label]['ready_s']:.2f} s after the process started, total_s "
              f"{c['total_s']:.4f}, phases_s "
              f"{json.dumps({k: round(v, 4) for k, v in c['phases'].items()})}", flush=True)
    print(f"serve_cli boots: the snapshot's tree ({n} leaves, {snap_bytes / 1e9:.3f} GB) "
          f"bit-equal to the tensors written; its kernel library is this run's build; the "
          f"restored boot ran no nvcc (this run's build took {_build.last_build_seconds:.2f} s "
          f"of nvcc) and its compile phase took {restored['compile']:.3f} s against the full "
          f"boot's {full['compile']:.3f} s", flush=True)
    print(f"serve_cli boots (fake S3 and GCS on 127.0.0.1, Python servers: host rates, not a "
          f"cloud bucket's): load through S3 {ckpt_bytes / 1e9:.3f} GB = download "
          f"{download_s:.3f} s + load {full['load']:.3f} s = {load_rate:.3f} GB/s; restore "
          f"{snap_bytes / 1e9:.3f} GB = fetch {restored['fetch']:.3f} s + restore "
          f"{restored['restore']:.3f} s = {restore_rate:.3f} GB/s; the missed boot's fetch "
          f"{missed['fetch']:.4f} s and load {missed['load']:.3f} s (from the weights cache); "
          f"GCS sent {gcs.sent / 1e9:.3f} GB and received {gcs.received / 1e9:.3f} GB; card "
          f"{gpu_line()}", flush=True)


def serve_cli() -> None:
    """Phase 5: the engine Pod's entry point. Writes a random-weight Llama
    checkpoint at Llama-3-8B width (CLI_LAYERS layers, bf16) with
    `weights.save_safetensors` into a temporary directory, uploads it to a
    fake S3 (FakeBucket, with a PEFT adapter) and serves it with `python -m
    kubeai_tpu_torch.engine.server` five times (`cli_run`, CLI_RUNS): the
    object-store boots (`--speculate 4` from s3:// with a gs:// snapshot
    bucket on a fake GCS, publishing; the same again from a copy of the
    package with an empty build/, restoring, which also loads the adapter
    through lora_url s3://; the default config with --snapshot-no-publish,
    missing; gated by `check_boots`), `--speculate 4 --draft-url` with a
    2-layer draft checkpoint written beside it, and `--quantization
    int8`. Then it loads
    the same checkpoint in-process with `weights.load_params` on the card
    and builds an engine of each run's configuration on it. Gates, besides
    `cli_run`'s: the loaded tensors bit-equal to those written; each run's
    greedy streams over HTTP equal to its in-process engine's; on /metrics
    4 requests, a TTFT count of 4 and the generated tokens the responses
    report; speculation windows in the speculative runs; the same token
    capacity as in-process. The default run (--max-adapters 4, the
    default) also runs `cli_admin_round` over two PEFT adapters written
    for the checkpoint. Reports the load rate, the cold-start phases, TTFT
    and the card."""
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.engine.weights import load_hf_config, load_params, save_safetensors
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.objstore import S3Client, upload_dir

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="kubeai-serve-cli-")
    stores = []
    try:
        disk = shutil.disk_usage(root)
        t0 = time.perf_counter()
        tensors = cli_tensors()
        model_dir = os.path.join(root, "model")
        save_safetensors(model_dir, tensors, CLI_CONFIG)
        ckpt_bytes = os.path.getsize(os.path.join(model_dir, "model.safetensors"))
        print(f"serve_cli checkpoint: {CLI_LAYERS} layers at Llama-3-8B width, bf16, "
              f"{ckpt_bytes / 1e9:.3f} GB in {len(tensors)} tensors, drawn and written in "
              f"{time.perf_counter() - t0:.2f} s; {disk.free / 1e9:.1f} GB free in "
              f"{os.path.dirname(root)} before", flush=True)
        draft_dir = os.path.join(root, "draft")
        save_safetensors(draft_dir, cli_tensors(CLI_DRAFT_CONFIG, seed=3), CLI_DRAFT_CONFIG)
        cli_cfg = llama.LlamaConfig.from_hf_dict(CLI_CONFIG)
        dirs = {name: write_peft_adapter(os.path.join(root, f"lora-{name}"), cli_cfg, seed)
                for name, seed in (("a", 31), ("b", 32))}
        s3 = FakeBucket("s3", os.path.join(root, "fake-s3"))
        gcs = FakeBucket("gcs", os.path.join(root, "fake-gcs"))
        stores += [s3, gcs]
        t0 = time.perf_counter()
        upload_dir(model_dir, "s3://ckpt/llama-8b-4l", client=S3Client(endpoint=s3.endpoint))
        upload_s = time.perf_counter() - t0
        upload_dir(dirs["a"], "s3://ckpt/adapters/a", client=S3Client(endpoint=s3.endpoint))
        print(f"serve_cli: the checkpoint uploaded to the fake S3 in {upload_s:.3f} s = "
              f"{ckpt_bytes / 1e9 / upload_s:.3f} GB/s (host rate)", flush=True)
        snap_url = "gs://snapshots/boots"
        store_env = {"AWS_ENDPOINT_URL": s3.endpoint, "STORAGE_EMULATOR_HOST": gcs.endpoint,
                     "KUBEAI_WEIGHTS_CACHE": os.path.join(root, "weights-cache")}
        # The restored boot's package: a copy with no build/ beside it.
        here = os.path.dirname(os.path.abspath(__file__))
        copy_root = os.path.join(root, "package-copy")
        shutil.copytree(os.path.join(here, "kubeai_tpu_torch"),
                        os.path.join(copy_root, "kubeai_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))

        def flags_of(label: str, flags: list) -> list:
            sub = {"{draft}": draft_dir, "{s3}": "s3://ckpt/llama-8b-4l", "{gs}": snap_url,
                   "{work}": os.path.join(root, "snapshot-work", label)}
            return [sub.get(f, f) for f in flags]

        def admin_of(label: str):
            if label == "default":
                return lambda port: cli_admin_round(port, dirs)
            if label == "restored":
                return lambda port: cli_s3_adapter(port, "s3://ckpt/adapters/a")
            return None

        sink = OtlpSink()
        runs = {}
        try:
            for label, flags, env, _ in CLI_RUNS:
                runs[label] = cli_run(
                    model_dir, label, flags_of(label, flags), {**env, **store_env},
                    ckpt_bytes, sink, admin=admin_of(label),
                    root=copy_root if label == "restored" else None)
                shutil.rmtree(os.path.join(root, "snapshot-work", label), ignore_errors=True)
        finally:
            sink.stop()
        check_boots(runs, tensors, ckpt_bytes, gcs, snap_url, copy_root)
        for store in stores:
            store.stop()
            shutil.rmtree(store.root, ignore_errors=True)
        stores = []
        shutil.rmtree(store_env["KUBEAI_WEIGHTS_CACHE"], ignore_errors=True)
        cli_role_pair(model_dir)

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
        dcfg = llama.LlamaConfig.from_hf_dict(CLI_DRAFT_CONFIG)
        draft = (dcfg, load_params("llama", draft_dir, dcfg, device="cuda"))
        engine, engine_key = None, None
        for label, flags, _, extra in CLI_RUNS:
            key = (json.dumps(extra, sort_keys=True), "--draft-url" in flags)
            if key != engine_key:
                # The CLI's default --max-adapters 4: every request pays the
                # (all-zero) delta of adapter row 0.
                del engine
                engine = Engine("llama", cfg, params, cfg=EngineConfig(
                    num_slots=8, max_seq_len=2048, max_adapters=4, **extra),
                    eos_token_ids=tok.eos_token_ids,
                    draft=draft if "--draft-url" in flags else None)
                engine_key = key
            check_cli_run(label, runs[label], engine)
        del engine
        if not any("int8 layer weights" in line for line in runs["int8"]["weights_log"]):
            fail("serve_cli int8: the server logged no int8 weight GiB")
        for label in ("speculate", "restored", "draft"):
            stats = runs[label]["state"]["spec_stats"]
            if stats["windows"] <= 0:
                fail(f"serve_cli {label}: the CLI ran no speculation window")
            print(f"serve_cli {label} spec_stats {json.dumps(stats)} acceptance "
                  f"{_acceptance(stats):.4f}", flush=True)
        del draft
        print(f"serve_cli card: {gpu_line()}", flush=True)
        del params
    finally:
        for store in stores:
            store.stop()
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# A Gemma-2 checkpoint at Gemma-2-9B width, 2 of its 42 layers, for the CLI.
GEMMA_CLI_LAYERS = 2
GEMMA_CLI_CONFIG = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "vocab_size": 256000, "hidden_size": 3584, "intermediate_size": 14336,
    "num_hidden_layers": GEMMA_CLI_LAYERS, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 8192, "sliding_window": 4096,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
    "query_pre_attn_scalar": 256, "torch_dtype": "bfloat16",
}
GEMMA_CLI_LEAVES = (("embed", "model.embed_tokens.weight", False),
                    ("final_norm", "model.norm.weight", False))
GEMMA_CLI_LAYER_LEAVES = (
    ("input_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True), ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True), ("wo", "self_attn.o_proj.weight", True),
    ("post_attn_norm", "post_attention_layernorm.weight", False),
    ("pre_mlp_norm", "pre_feedforward_layernorm.weight", False),
    ("post_mlp_norm", "post_feedforward_layernorm.weight", False),
    ("w_gate", "mlp.gate_proj.weight", True), ("w_up", "mlp.up_proj.weight", True),
    ("w_down", "mlp.down_proj.weight", True))
# A Gemma-1 checkpoint at Gemma-7B width (GEMMA_7B), 2 of its 28 layers.
# Gemma-1's `post_attention_layernorm` is its pre-MLP norm.
GEMMA1_CLI_CONFIG = {
    "architectures": ["GemmaForCausalLM"], "model_type": "gemma",
    "vocab_size": 256000, "hidden_size": 3072, "intermediate_size": 24576,
    "num_hidden_layers": GEMMA_CLI_LAYERS, "num_attention_heads": 16,
    "num_key_value_heads": 16, "head_dim": 256, "rope_theta": 10000.0,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 8192, "torch_dtype": "bfloat16",
}
GEMMA1_CLI_LAYER_LEAVES = (
    ("input_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True), ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True), ("wo", "self_attn.o_proj.weight", True),
    ("pre_mlp_norm", "post_attention_layernorm.weight", False),
    ("w_gate", "mlp.gate_proj.weight", True), ("w_up", "mlp.up_proj.weight", True),
    ("w_down", "mlp.down_proj.weight", True))


def gemma_cli_tensors(c: dict = GEMMA_CLI_CONFIG,
                      layer_leaves=GEMMA_CLI_LAYER_LEAVES) -> dict:
    """Random bf16 tensors under the Hugging Face names of `c` (default
    Gemma-2's), drawn on the card from a seed as `gemma.init_params` draws
    them (N(0, 0.02), zero-centred norms at 0) and kept on the host.
    Logits are tied to the embedding, so its rows of the printable ASCII
    bytes are drawn ASCII_HEAD_SCALE times larger, as the llama
    checkpoint's head rows are."""
    import torch

    E, M, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    HD, KD = c["num_attention_heads"] * c["head_dim"], c["num_key_value_heads"] * c["head_dim"]
    gen = torch.Generator("cuda").manual_seed(2)
    shapes = {"self_attn.q_proj.weight": (HD, E), "self_attn.k_proj.weight": (KD, E),
              "self_attn.v_proj.weight": (KD, E), "self_attn.o_proj.weight": (E, HD),
              "mlp.gate_proj.weight": (M, E), "mlp.up_proj.weight": (M, E),
              "mlp.down_proj.weight": (E, M)}

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.02

    embed = rnd(V, E)
    embed[32:127] *= ASCII_HEAD_SCALE
    out = {"model.embed_tokens.weight": embed.to(torch.bfloat16).cpu()}
    for i in range(c["num_hidden_layers"]):
        for _, name, _ in layer_leaves:
            shape = shapes.get(name)
            out[f"model.layers.{i}.{name}"] = (
                torch.zeros(E, dtype=torch.bfloat16) if shape is None
                else rnd(*shape).to(torch.bfloat16).cpu())
    out["model.norm.weight"] = torch.zeros(E, dtype=torch.bfloat16)
    return out


def serve_cli_gemma(config: dict = GEMMA_CLI_CONFIG, layer_leaves=GEMMA_CLI_LAYER_LEAVES,
                    label: str = "gemma", width: str = "Gemma-2-9B", int8: bool = False) -> None:
    """Phase 5b: the entry point on a gemma checkpoint (default: Gemma-2
    at Gemma-2-9B width; GEMMA1_CLI_CONFIG: Gemma-1 at Gemma-7B width,
    whose prefill runs B2 at head_dim 256 in the server process),
    GEMMA_CLI_LAYERS layers, bf16, `gemma_cli_tensors`, written with
    `weights.save_safetensors`: one `cli_run` with the default flags
    (--max-adapters 4; with `int8`, also --kv-dtype int8, and /v1/state
    must report int8 pools), whose admin step must get 400 naming ROADMAP
    fault C10 from /v1/load_lora_adapter; then the checkpoint loaded
    in-process with `weights.load_params` must be bit-equal to the tensors
    written, and an in-process engine of the run's configuration must give
    the greedy streams served over HTTP (`check_cli_run`)."""
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.weights import load_hf_config, load_params, save_safetensors
    from kubeai_tpu_torch.models import gemma

    def refuse_adapters(port: int) -> None:
        status, res, _, _ = _post(port, {"lora_name": "tenant", "lora_path": root},
                                  path="/v1/load_lora_adapter")
        if status != 400 or "C10" not in json.dumps(res):
            fail(f"serve_cli {label}: an adapter load got HTTP {status} {res}, not 400 (C10)")
        print(f"serve_cli {label}: /v1/load_lora_adapter answers 400: {json.dumps(res)}",
              flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="kubeai-serve-cli-gemma-")
    try:
        t0 = time.perf_counter()
        tensors = gemma_cli_tensors(config, layer_leaves)
        model_dir = os.path.join(root, "model")
        save_safetensors(model_dir, tensors, config)
        ckpt_bytes = os.path.getsize(os.path.join(model_dir, "model.safetensors"))
        print(f"serve_cli {label} checkpoint: {GEMMA_CLI_LAYERS} layers at {width} width, "
              f"bf16, {ckpt_bytes / 1e9:.3f} GB in {len(tensors)} tensors, drawn and written "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        sink = OtlpSink()
        try:
            run = cli_run(model_dir, label, ["--kv-dtype", "int8"] if int8 else [], {},
                          ckpt_bytes, sink, admin=refuse_adapters)
        finally:
            sink.stop()
        kv = run["state"]["kv_cache"]
        if (kv["dtype"], kv["quantized"]) != (("int8", True) if int8 else ("bfloat16", False)):
            fail(f"serve_cli {label}: /v1/state kv_cache {kv}")
        cfg = gemma.GemmaConfig.from_hf_dict(load_hf_config(model_dir))
        params = load_params("gemma", model_dir, cfg, device="cuda")
        n = check_loaded_bits(params, tensors, GEMMA_CLI_LEAVES, layer_leaves,
                              GEMMA_CLI_LAYERS)
        del tensors
        print(f"serve_cli {label} load_params in-process: {n} leaves bit-equal to the "
              "tensors written", flush=True)
        engine = Engine("gemma", cfg, params, cfg=EngineConfig(
            num_slots=8, max_seq_len=2048, max_adapters=4, decode_kernel="per_layer",
            kv_dtype="int8" if int8 else ""))
        check_cli_run(label, run, engine)
        del engine, params
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


# ---- serve_mixtral: Mixtral-8x7B's width at a cut depth ----------------------------

# HF mistralai/Mixtral-8x7B-v0.1 config.json (the catalog's
# mixtral-8x7b-instruct-tpu): 32 heads over 8 kv heads at head_dim 128, 8
# experts of intermediate 14336, top-2, rope theta 1e6. 46.7 B parameters,
# 93.4 GB in bf16 (a layer 2.90 GB: 41.9 M attention and 1,409 M expert
# parameters), past the card's 80 GB, and int8 weights do not apply
# (ROADMAP fault C15): the smoke serves its full width at MIXTRAL_LAYERS.
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32,
    num_heads=32, num_kv_heads=8, num_experts=8, num_experts_per_tok=2,
    rope_theta=1e6, rms_norm_eps=1e-5, max_position_embeddings=32768,
)
MIXTRAL_LAYERS = 8
# The 8 slots' pages at 4,096 tokens take 1.07 GB a pool pair at 8 layers
# (32 KiB of K/V a token); the largest dense prefill temporaries (g, u and
# g * u, [tokens, 8 x 14336] bf16) are 0.47 GB each at the 2048 bucket.
MIXTRAL_SERVE_CONFIG = dict(num_slots=8, max_seq_len=4096, page_size=64, decode_chunk=8)
# (label, decode kernel, engine settings). speculate=2 runs vanilla decode
# (no verify forward): the per_layer kernels, and no B3.
MIXTRAL_RUNS = (("per_layer", "paged_decode_attention", dict(decode_kernel="per_layer")),
                ("fused", "paged_decode_attention_fused", dict(decode_kernel="fused")),
                ("int8", "paged_decode_attention_int8",
                 dict(decode_kernel="per_layer", kv_dtype="int8")),
                ("speculate", "paged_decode_attention",
                 dict(decode_kernel="per_layer", speculate=2)))
# The paged decode kernels' walk, by name in a profile: B1 and B4 share it.
DECODE_WALKS = {"paged_decode_attention": "paged_split_walk_kernel",
                "paged_decode_attention_fused": "paged_split_walk_kernel",
                "paged_decode_attention_int8": "paged_split_walk_int8_kernel"}
# Library GEMM kernels by name (cuBLAS' GEMMs and gemv).
GEMM_NAMES = LIBRARY_GEMMS + ("gemv", "splitKreduce")


def _mixtral_bodies(again: bool = False) -> list[dict]:
    """Four chat completions of about 28, 117, 317 and 1,100 prompt
    tokens, 32 completion tokens each: the second seeded, the last
    streamed; each alone in its prefill bucket (32, 128, 512, 2048), so
    the served and the eager engine admit them alike. With `again`, each
    content gains a short tail: a second wave whose prompts share their
    first pages with the first wave's."""
    text = "The quick brown fox jumps over the lazy dog. "
    contents = ["Hello there", (text * 3)[:100], (text * 7)[:300], (text * 25)[:1083]]
    bodies = []
    for j, content in enumerate(contents):
        tail = f" Again {j}." if again else ""
        body = {"messages": [{"role": "user", "content": content + tail}],
                "max_tokens": 32, "temperature": 0}
        if j == 1:
            body.update(temperature=0.8, seed=3 if again else 2)
        if j == 3:
            body["stream"] = True
        bodies.append(body)
    return bodies


def mixtral_weights(num_layers: int = MIXTRAL_LAYERS):
    """(random Mixtral-8x7B-width weights on cuda at `num_layers`, made
    from a seed; the config; their bytes), after one prefill's shapes and
    finite logits are checked."""
    import torch

    from kubeai_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig(**dict(MIXTRAL_8X7B, num_layers=num_layers))
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.nbytes for t in [params["embed"], params["final_norm"],
                                     params["lm_head"], *params["layers"].values()])
    print(f"serve_mixtral: random Mixtral-8x7B-width weights at {num_layers} of 32 layers "
          f"on cuda, {n_bytes / 2**30:.3f} GiB ({n_bytes / 1e9:.3f} GB) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, 64), device="cuda")
        logits, k_all, _ = mixtral.prefill(params, cfg, toks, torch.tensor([64], device="cuda"))
    want_k = (cfg.num_layers, 1, 64, cfg.num_kv_heads, cfg.head_size)
    if tuple(logits.shape) != (1, cfg.vocab_size) or tuple(k_all.shape) != want_k:
        fail(f"mixtral prefill shapes {tuple(logits.shape)} {tuple(k_all.shape)}")
    if not torch.isfinite(logits).all():
        fail("mixtral prefill logits are not finite")
    return params, cfg, n_bytes


def check_router_ties(cfg) -> None:
    """The router's top-k on the card at the served widths (4,096 tokens
    and one decode step's 8, 8 experts): activations and a router of
    integers in {-1, 0, 1}, whose odd columns repeat the even ones, give
    exact products with forced ties; `top_k_stable` must pick what a
    stable sort by index picks on the host (the lower index first among
    equal logits, jax.lax.top_k's order) in every row."""
    import numpy as np
    import torch

    from kubeai_tpu_torch.models import mixtral

    gen = torch.Generator("cuda").manual_seed(21)
    X, k = cfg.num_experts, cfg.num_experts_per_tok
    router = torch.randint(-1, 2, (cfg.hidden_size, X // 2), generator=gen, device="cuda")
    router = router.repeat_interleave(2, dim=1).to(torch.bfloat16)  # columns in pairs
    for T in (4096, 8):
        h = torch.randint(-1, 2, (T, cfg.hidden_size), generator=gen, device="cuda")
        logits = torch.matmul(h.to(torch.bfloat16), router).float()
        if not torch.equal(logits[:, 0::2], logits[:, 1::2]):
            fail("router ties: paired router columns gave different logits")
        _, got = mixtral.top_k_stable(logits, k)
        want = np.argsort(-logits.cpu().numpy(), axis=-1, kind="stable")[:, :k]
        bad = int((got.cpu().numpy() != want).any(-1).sum())
        if bad:
            fail(f"router ties: top_k_stable picked other experts than a stable host sort "
                 f"in {bad} of {T} rows")
    print("serve_mixtral router ties: in 4,096 + 8 rows whose top two logits tie, "
          "top_k_stable on the card picked the lower index first, as a stable host sort "
          "does", flush=True)


def _mixtral_gates(label: str, run: dict, decode: str, num_layers: int) -> None:
    """A mixtral serve run: its decode kernel launched, num_layers times
    a step in every decode-chunk replay, and no other paged kernel (no B3:
    speculate falls back to vanilla decode); B2 num_layers times in every
    whole-prompt admission."""
    launched, engine = run["launches"], run["engine"]
    if launched[decode] <= 0:
        fail(f"serve {label}: main path never launched {decode}")
    for name in ("paged_decode_attention", "paged_decode_attention_fused",
                 "paged_verify_attention", "paged_decode_attention_int8"):
        if name != decode and launched[name]:
            fail(f"serve {label}: {name} launched {launched[name]} times")
    steps = engine._chunk_out.shape[0]
    per_replay = _programs(engine)["decode chunk"].launches_per_replay
    if per_replay.get(decode) != num_layers * steps:
        fail(f"serve {label}: {decode} launches per decode-chunk replay {per_replay}, not "
             f"{num_layers} layers x {steps} steps")
    per_admission = run["admit_b2"].get("_prefill_admit", [])
    if not per_admission or any(n != num_layers for n in per_admission):
        fail(f"serve {label}: B2 launches per whole-prompt admission {per_admission}, not "
             f"{num_layers} each")
    print(f"serve {label}: {decode} {per_replay[decode]} launches per decode-chunk replay "
          f"({num_layers} layers x {steps} steps), {launched[decode]} in the run; B2 "
          f"{per_admission} in {len(per_admission)} whole-prompt admissions", flush=True)


def _walks_per_step(label: str, prof: dict, decode: str, num_layers: int) -> None:
    """torch.profiler's count of the decode kernel's walk a step must be
    num_layers."""
    walk = DECODE_WALKS[decode]
    n = sum(e.count for e in prof["rows"] if walk in e.key) / prof["steps"]
    if n != num_layers:
        fail(f"serve {label}: the profile shows {n} {walk} launches a step, not {num_layers}")
    print(f"serve {label}: torch.profiler counts {n:.0f} {walk} launches a decode step",
          flush=True)


def _no_weight_copies(label: str, prof: dict, cfg, engine) -> None:
    """The decode step moves no expert stack through anything but a GEMM:
    every other kernel of the profile takes less a launch than one of a
    layer's expert stacks ([X, E, M] bf16) takes to cross HBM once at the
    card's peak, and the decode chunk's graph pool holds less than one."""
    stack = cfg.num_experts * cfg.hidden_size * cfg.intermediate_size * 2
    floor_ms = stack / PEAK_BYTES_PER_S * 1e3
    worst = (0.0, "")
    for e in prof["rows"]:
        if any(g in e.key for g in GEMM_NAMES) or not e.count:
            continue
        per = getattr(e, "self_device_time_total", 0) / 1e3 / e.count
        if per >= floor_ms:
            fail(f"serve {label}: {e.key[:90]} takes {per:.4f} ms a launch, as long as "
                 f"moving an expert stack ({stack / 1e9:.3f} GB, {floor_ms:.4f} ms)")
        worst = max(worst, (per, e.key[:60]))
    pool = _programs(engine)["decode chunk"].pool_bytes
    if pool >= stack:
        fail(f"serve {label}: the decode graph's pool holds {pool / 2**20:.1f} MiB, an "
             "expert stack's worth")
    print(f"serve {label}: no kernel but a GEMM moves an expert stack ({stack / 1e9:.3f} "
          f"GB, {floor_ms:.4f} ms at peak): the slowest other launch {worst[0]:.4f} ms "
          f"({worst[1]}); graph pool {pool / 2**20:.1f} MiB", flush=True)


def moe_ms(params, cfg, tokens: int) -> float:
    """Device ms of one forward's MoE blocks (`_moe_ffn` once a layer) on
    `tokens` rows, from a CUDA graph."""
    import torch

    from kubeai_tpu_torch.models import mixtral

    h = torch.randn(tokens, cfg.hidden_size, generator=torch.Generator("cuda").manual_seed(5),
                    device="cuda").to(torch.bfloat16)
    layers = [mixtral._layer(params, i) for i in range(cfg.num_layers)]

    def call():
        for lp in layers:
            out = mixtral._moe_ffn(h, lp, cfg)
        return out

    return graph_ms(call, iters=1, replays=5)


def mixtral_prefix_run(params, cfg, label: str = "mixtral prefix") -> None:
    """`prefill_chunk=512, prefix_cache=True` (per_layer) over two waves of
    `_mixtral_bodies` whose second hits the first's pages. Gates:
    `_mixtral_gates`, the staged-chunk programs dispatched only as graph
    replays, hit tokens the cache rule's and the eager engine's, every
    stream equal to that engine's."""
    extra = dict(decode_kernel="per_layer", prefill_chunk=PREFIX_CHUNK, prefix_cache=True)
    run = serve_run(params, cfg, label, waves=[_mixtral_bodies(), _mixtral_bodies(again=True)],
                    family="mixtral", config=MIXTRAL_SERVE_CONFIG, **extra)
    _mixtral_gates(label, run, "paged_decode_attention", cfg.num_layers)
    if run["stage_calls"]:
        fail(f"serve {label}: staged-chunk functions ran outside their graphs: "
             f"{run['stage_calls']}")
    for name in ("mid chunk", "final chunk", "prefix gather"):
        if run["dispatches"].get(name, 0) <= 0:
            fail(f"serve {label}: the {name} program was never dispatched")
    order = sorted(run["requests"])
    per = expected_hits([run["requests"][rid][0] for rid in order],
                        MIXTRAL_SERVE_CONFIG["page_size"], PREFIX_CHUNK,
                        MIXTRAL_SERVE_CONFIG["max_seq_len"])
    stats = dict(run["engine"].prefix_stats)
    print(f"serve {label} prefix_stats {json.dumps(stats)}; the cache rule gives "
          f"{sum(per)} hit tokens", flush=True)
    if stats["hit_tokens"] != sum(per) or not stats["hit_tokens"]:
        fail(f"serve {label}: {stats['hit_tokens']} hit tokens, the rule gives {sum(per)}")
    ref = check_streams_equal_eager(params, cfg, label, run, **extra)
    if ref.prefix_stats["hit_tokens"] != stats["hit_tokens"]:
        fail(f"serve {label}: eager engine hit {ref.prefix_stats['hit_tokens']} tokens, "
             f"the served engine {stats['hit_tokens']}")
    del ref
    free(run)


class _Warnings(logging.Handler):
    """The warnings logged while it is attached to a logger."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def serve_mixtral() -> dict:
    """Phase 4f: Mixtral-8x7B's width at MIXTRAL_LAYERS layers
    (`mixtral_weights`), served with MIXTRAL_SERVE_CONFIG, graphs and
    overlap: the four `_mixtral_bodies` per_layer (B1), fused (B4), on int8
    pools (B1-int8) and with speculate=2 (vanilla decode, logged; B1 and
    no B3), then `mixtral_prefix_run`. Gates: `check_router_ties`,
    `_mixtral_gates`, every stream equal to an eager synchronous engine's
    (an int8 one on int8 pools), `check_int8_pools`, and in each layout's
    decode-step profile the walk num_layers times a step
    (`_walks_per_step`) and no kernel but a GEMM moving an expert stack
    (`_no_weight_copies`). Prints the decode step's device ms against its
    bytes bound, a 512-bucket admission's device ms, the MoE's share of
    each, the weights' GiB and the peak memory. Returns the launches of
    the whole-prompt runs by kernel."""
    import gc

    import torch

    from kubeai_tpu_torch.models import mixtral

    torch.cuda.reset_peak_memory_stats()
    params, cfg, n_bytes = mixtral_weights()
    check_router_ties(cfg)
    launches: dict[str, int] = {}
    steps = {}
    logger = logging.getLogger("kubeai_tpu_torch.engine.engine")
    for layout, decode, extra in MIXTRAL_RUNS:
        label = f"mixtral {layout}"
        warned = _Warnings()
        logger.addHandler(warned)
        try:
            run = serve_run(params, cfg, label, waves=[_mixtral_bodies()], family="mixtral",
                            config=MIXTRAL_SERVE_CONFIG, **extra)
        finally:
            logger.removeHandler(warned)
        _mixtral_gates(label, run, decode, cfg.num_layers)
        for name, n in run["launches"].items():
            launches[name] = launches.get(name, 0) + n
        if layout == "speculate":
            said = [m for m in warned.messages if "running vanilla decode" in m]
            if run["engine"]._spec != 0 or not said:
                fail(f"serve {label}: speculate=2 did not fall back to vanilla decode "
                     f"with a warning ({warned.messages})")
            print(f"serve {label}: the engine logged {said[0]!r}", flush=True)
        if extra.get("kv_dtype") == "int8":
            check_int8_pools(label, run["engine"], cfg.num_layers)
        check_streams_equal_eager(params, cfg, label, run, **extra)
        if layout != "speculate":  # its step is per_layer's
            prof = profile_program(run["engine"], f"{label} decode step", "decode chunk")
            _walks_per_step(label, prof, decode, cfg.num_layers)
            _no_weight_copies(label, prof, cfg, run["engine"])
            steps[layout] = prof
        free(run)
    mixtral_prefix_run(params, cfg)
    # The step's bound: every weight but the embedding read once (the
    # embedding's 8 rows and the pools' few MB aside).
    step_bytes = n_bytes - params["embed"].nbytes
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3
    decode_moe = moe_ms(params, cfg, MIXTRAL_SERVE_CONFIG["num_slots"])
    for layout, prof in steps.items():
        print(f"serve_mixtral {layout} decode step from its graph: device "
              f"{prof['device_ms']:.3f} ms, wall {prof['wall_ms']:.3f} ms; bytes bound "
              f"{bound_ms:.3f} ms ({step_bytes / 1e9:.3f} GB at "
              f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; x{prof['device_ms'] / bound_ms:.2f}); "
              f"the MoE blocks {decode_moe:.3f} ms ({decode_moe / prof['device_ms']:.3f} of "
              "the step)", flush=True)
    admission = profile_prefill(params, cfg, model=mixtral, buckets=(512,), tag="mixtral ")
    adm_ms, b2 = admission[512]
    if b2 != cfg.num_layers:
        fail(f"serve_mixtral: the 512 admission's profile shows {b2} B2 launches, not "
             f"{cfg.num_layers}")
    prefill_moe = moe_ms(params, cfg, 512)
    flops = 3 * 2 * 512 * cfg.hidden_size * cfg.intermediate_size * cfg.num_experts
    flops *= cfg.num_layers
    print(f"serve_mixtral 512-bucket admission: device {adm_ms:.3f} ms; the MoE blocks "
          f"{prefill_moe:.3f} ms ({prefill_moe / adm_ms:.3f} of it; the dense expert "
          f"products {flops / 1e12:.2f} TFLOP, {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at "
          "peak)", flush=True)
    peak = torch.cuda.max_memory_allocated()
    print(f"serve_mixtral memory: weights {n_bytes / 2**30:.3f} GiB, peak allocated "
          f"{peak / 2**30:.3f} GiB; card: {gpu_line()}", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# A Mixtral checkpoint at Mixtral-8x7B width, 2 of its 32 layers, for the
# CLI: 6.3 GB in bf16 under HF's names.
MIXTRAL_CLI_LAYERS = 2
MIXTRAL_CLI_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": MIXTRAL_CLI_LAYERS, "num_attention_heads": 32,
    "num_key_value_heads": 8, "num_local_experts": 8, "num_experts_per_tok": 2,
    "rope_theta": 1e6, "rms_norm_eps": 1e-5, "max_position_embeddings": 32768,
    "torch_dtype": "bfloat16",
}
MIXTRAL_CLI_LAYER_LEAVES = (
    ("input_norm", "input_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True), ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True), ("wo", "self_attn.o_proj.weight", True),
    ("post_attn_norm", "post_attention_layernorm.weight", False),
    ("router", "block_sparse_moe.gate.weight", True))
# Each expert's tensors: (the port's stack, HF name); w1 and w3 fill
# [NL, E, X, M] stacks at [i, :, e], w2 the [NL, X, M, E] stack at [i, e].
MIXTRAL_CLI_EXPERTS = (("w_gate", "w1"), ("w_up", "w3"), ("w_down", "w2"))


def mixtral_cli_tensors(c: dict = MIXTRAL_CLI_CONFIG) -> dict:
    """Random bf16 tensors under the Hugging Face names of `c`, drawn on
    the card from a seed (N(0, 0.02), norms at 1) and kept on the host;
    the head's rows of the printable ASCII bytes are drawn
    ASCII_HEAD_SCALE times larger, as the llama checkpoint's are."""
    import torch

    E, M, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    HD = c["num_attention_heads"] * (E // c["num_attention_heads"])
    KD = c["num_key_value_heads"] * (E // c["num_attention_heads"])
    X = c["num_local_experts"]
    gen = torch.Generator("cuda").manual_seed(3)

    def rnd(*shape, ascii_rows: bool = False):
        t = torch.randn(shape, generator=gen, device="cuda") * 0.02
        if ascii_rows:
            t[32:127] *= ASCII_HEAD_SCALE
        return t.to(torch.bfloat16).cpu()

    out = {"model.embed_tokens.weight": rnd(V, E)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = torch.ones(E, dtype=torch.bfloat16)
        for name, shape in (("q_proj", (HD, E)), ("k_proj", (KD, E)), ("v_proj", (KD, E)),
                            ("o_proj", (E, HD))):
            out[f"{p}self_attn.{name}.weight"] = rnd(*shape)
        out[p + "post_attention_layernorm.weight"] = torch.ones(E, dtype=torch.bfloat16)
        out[p + "block_sparse_moe.gate.weight"] = rnd(X, E)
        for e in range(X):
            for name, shape in (("w1", (M, E)), ("w2", (E, M)), ("w3", (M, E))):
                out[f"{p}block_sparse_moe.experts.{e}.{name}.weight"] = rnd(*shape)
    out["model.norm.weight"] = torch.ones(E, dtype=torch.bfloat16)
    out["lm_head.weight"] = rnd(V, E, ascii_rows=True)
    return out


def serve_cli_mixtral() -> None:
    """Phase 5c: the entry point on a MIXTRAL_CLI_LAYERS-layer checkpoint
    at Mixtral-8x7B width (`mixtral_cli_tensors`, written with
    `weights.save_safetensors`): one `cli_run` with the default flags
    (--max-adapters 4), whose admin step must get 400 naming ROADMAP fault
    C10 from /v1/load_lora_adapter and 400 from /v1/embeddings; the
    checkpoint loaded in-process with `weights.load_params` must be
    bit-equal to the tensors written (every expert's w1, w3 and w2 in its
    slot), and an in-process engine of the run's configuration must give
    the greedy streams served over HTTP (`check_cli_run`); then `main`
    with `--quantization int8`, called in this process, must exit at boot
    naming C15."""
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.server import main as server_main
    from kubeai_tpu_torch.engine.weights import load_hf_config, load_params, save_safetensors
    from kubeai_tpu_torch.models import mixtral

    def refusals(port: int) -> None:
        status, res, _, _ = _post(port, {"lora_name": "tenant", "lora_path": root},
                                  path="/v1/load_lora_adapter")
        if status != 400 or "C10" not in json.dumps(res):
            fail(f"serve_cli mixtral: an adapter load got HTTP {status} {res}, not 400 (C10)")
        e_status, e_res, _, _ = _post(port, {"input": ["hello"], "model": "model"},
                                      path="/v1/embeddings")
        if e_status != 400:
            fail(f"serve_cli mixtral: /v1/embeddings got HTTP {e_status} {e_res}, not 400")
        print(f"serve_cli mixtral: /v1/load_lora_adapter answers 400: {json.dumps(res)}; "
              f"/v1/embeddings answers 400: {json.dumps(e_res)}", flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="kubeai-serve-cli-mixtral-")
    try:
        t0 = time.perf_counter()
        tensors = mixtral_cli_tensors()
        model_dir = os.path.join(root, "model")
        save_safetensors(model_dir, tensors, MIXTRAL_CLI_CONFIG)
        ckpt_bytes = os.path.getsize(os.path.join(model_dir, "model.safetensors"))
        print(f"serve_cli mixtral checkpoint: {MIXTRAL_CLI_LAYERS} layers at Mixtral-8x7B "
              f"width, bf16, {ckpt_bytes / 1e9:.3f} GB in {len(tensors)} tensors, drawn and "
              f"written in {time.perf_counter() - t0:.2f} s", flush=True)
        sink = OtlpSink()
        try:
            run = cli_run(model_dir, "mixtral", [], {}, ckpt_bytes, sink, admin=refusals)
        finally:
            sink.stop()
        cfg = mixtral.MixtralConfig.from_hf_dict(load_hf_config(model_dir))
        params = load_params("mixtral", model_dir, cfg, device="cuda")
        n = check_loaded_bits(params, tensors, CLI_LEAVES, MIXTRAL_CLI_LAYER_LEAVES,
                              MIXTRAL_CLI_LAYERS)
        for i in range(MIXTRAL_CLI_LAYERS):
            for e in range(cfg.num_experts):
                for leaf, hf in MIXTRAL_CLI_EXPERTS:
                    stack = params["layers"][leaf][i]
                    got = stack[e] if leaf == "w_down" else stack[:, e]
                    want = tensors[f"model.layers.{i}.block_sparse_moe.experts.{e}.{hf}.weight"]
                    if not torch.equal(got.view(torch.int16),
                                       want.T.to(got.device).view(torch.int16)):
                        fail(f"serve_cli mixtral: loaded {leaf}[{i}] expert {e} is not "
                             f"bit-equal to {hf}")
                    n += 1
        del tensors
        print(f"serve_cli mixtral load_params in-process: {n} leaves and expert slots "
              "bit-equal to the tensors written", flush=True)
        engine = Engine("mixtral", cfg, params, cfg=EngineConfig(
            num_slots=8, max_seq_len=2048, max_adapters=4, decode_kernel="per_layer"))
        check_cli_run("mixtral", run, engine)
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
        # main exits at boot, before it loads a tensor.
        t0 = time.perf_counter()
        try:
            server_main(["--model-url", model_dir, "--quantization", "int8"])
        except SystemExit as e:
            said = str(e.code)
        else:
            said = ""
        if "C15" not in said:
            fail(f"serve_cli mixtral: --quantization int8 did not exit at boot naming C15: "
                 f"{said!r}")
        print(f"serve_cli mixtral: main with --quantization int8 exits at boot in "
              f"{time.perf_counter() - t0:.2f} s: {said}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---- serve_embed: the catalog's embedder through /v1/embeddings --------------------

# HF Qwen/Qwen2.5-0.5B-Instruct config.json (the catalog's qwen2-embed-tpu and
# qwen2.5-0.5b-instruct-tpu), all 24 layers: 14 heads over 2 kv heads at
# head_dim 64, q/k/v biases, tied embeddings; 0.494 B parameters, 0.99 GB in
# bf16.
QWEN_05B_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
    "vocab_size": 151936, "hidden_size": 896, "intermediate_size": 4864,
    "num_hidden_layers": 24, "num_attention_heads": QWEN_H,
    "num_key_value_heads": QWEN_KVH, "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
    "max_position_embeddings": 32768, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16",
}
QWEN_LEAVES = CLI_LEAVES[:2]  # the head is the embedding
QWEN_LAYER_LEAVES = CLI_LAYER_LEAVES + (("bq", "self_attn.q_proj.bias", False),
                                        ("bk", "self_attn.k_proj.bias", False),
                                        ("bv", "self_attn.v_proj.bias", False))
# Embedding inputs, ByteTokenizer's one token a byte: a batch of 8 with
# ragged lengths from 5 to 1,500 tokens (the 2048 bucket), and single
# inputs of 5, 200 and 1,500.
EMBED_LENGTHS = (5, 17, 64, 200, 333, 700, 1024, 1500)
EMBED_SINGLE = (5, 200, 1500)
EMBED_REPEATS = 5
# The served vectors (bf16 weights, B2) against the plain path in f32 on the
# same weights (upcast) on the card: bf16 activations through 24 layers,
# compared as unit vectors. A sound trunk read max |err| 1.534e-3 and least
# cosine 0.999904 on an H100; the same f32 path without its last layer
# must read outside both limits, or the check could not see a broken trunk.
EMBED_ATOL = 5e-3
EMBED_MIN_COS = 0.9995
# Chat traffic served beside the embeddings (greedy and seeded, one
# streamed), long enough that batches land between its steps.
EMBED_CHAT = [
    {"messages": [{"role": "user", "content": "Tell me about the sea."}],
     "max_tokens": 192, "temperature": 0, "stream": True},
    {"messages": [{"role": "user", "content": "List some rivers, please: " * 9}],
     "max_tokens": 192, "temperature": 0.7, "seed": 4},
]


def _embed_texts(lengths, seed: int) -> list[str]:
    """Printable ASCII strings of the given lengths, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return ["".join(map(chr, rng.integers(32, 127, n))) for n in lengths]


def _embed_inputs(texts: list[str], config: dict = SERVE_CONFIG):
    """(tokens [B, bucket], lengths [B]) as EngineServer builds them for
    ByteTokenizer: right-padded to the engine's prefill bucket."""
    import torch

    from kubeai_tpu_torch.engine import EngineConfig

    ids = [list(t.encode()) or [0] for t in texts]
    n = max(map(len, ids))
    bucket = next(b for b in EngineConfig(**config).buckets() if n <= b)
    tokens = torch.zeros((len(ids), bucket), dtype=torch.long)
    for row, i in enumerate(ids):
        tokens[row, : len(i)] = torch.tensor(i)
    return tokens, torch.tensor([len(i) for i in ids])


def _in_process_vectors(params, cfg, texts):
    """llama.hidden_states on the card over `texts` as the server pads them."""
    import torch

    from kubeai_tpu_torch.models import llama

    tokens, lengths = _embed_inputs(texts)
    with torch.no_grad():
        return llama.hidden_states(params, cfg, tokens.cuda(), lengths.cuda()).cpu()


def _same_vectors(label: str, served: list, want) -> None:
    """Served JSON vectors bit-equal to `want` (f32 through JSON's repr)."""
    import torch

    got = torch.tensor(served, dtype=torch.float32)
    if got.shape != want.shape or not torch.equal(got, want):
        err = (got - want).abs().max() if got.shape == want.shape else "shape"
        fail(f"serve_embed {label}: served vectors {tuple(got.shape)} differ from the "
             f"in-process hidden_states {tuple(want.shape)} (max |err| {err})")


def qwen_weights():
    """(random Qwen2.5-0.5B weights on the card, all 24 layers, from a seed,
    with q/k/v biases drawn; their HF-named tensors on the host; the
    config)."""
    import torch

    from kubeai_tpu_torch.models import llama

    cfg = llama.LlamaConfig.from_hf_dict(QWEN_05B_CONFIG)
    gen = torch.Generator("cuda").manual_seed(5)
    params = llama.init_params(cfg, gen, device="cuda")
    for name in ("bk", "bv"):
        params["layers"][name].copy_(torch.randn(params["layers"][name].shape,
                                                 generator=gen, device="cuda") * 0.02)
    tensors = {leaf_name: params[leaf] for leaf, leaf_name, _ in QWEN_LEAVES}
    for i in range(cfg.num_layers):
        for leaf, name, transposed in QWEN_LAYER_LEAVES:
            w = params["layers"][leaf][i]
            tensors[f"model.layers.{i}.{name}"] = (w.T if transposed else w).contiguous()
    tensors = {name: t.cpu() for name, t in tensors.items()}
    return params, tensors, cfg


@contextlib.contextmanager
def cli_process(model_dir: str, label: str, flags=()):
    """`python -m kubeai_tpu_torch.engine.server --model-url model_dir` on a
    free port, as a new process group under `timeout --foreground` (which
    passes a signal to the server once; without it the server would get
    it a second time through the group): yields the port once /health
    answers 200 (within CLI_READY_S). Afterwards SIGINT must end it with
    exit 0 within CLI_DRAIN_S; on any failure the group is killed."""
    import os
    import signal
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model-url", model_dir,
           "--port", str(port), *flags]
    print(f"{label} command: {' '.join(cmd[1:])}", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    log_fd, log_path = tempfile.mkstemp(prefix=f"kubeai-{label}-", suffix=".log")

    def tail() -> str:
        with open(log_path) as f:
            return "".join(f.readlines()[-30:])

    proc = subprocess.Popen(["timeout", "--foreground", "-k", "10", str(CLI_READY_S + 300),
                             *cmd], cwd=here, env=dict(os.environ, PYTHONPATH=here),
                            stdout=log_fd, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                fail(f"{label}: the server exited {proc.returncode} before it was ready:\n"
                     f"{tail()}")
            try:
                if _get(port, "/health")[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > CLI_READY_S:
                fail(f"{label}: not ready within {CLI_READY_S} s:\n{tail()}")
            time.sleep(0.25)
        print(f"{label}: ready {time.perf_counter() - t0:.2f} s after the process started",
              flush=True)
        yield port
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=CLI_DRAIN_S)
        except subprocess.TimeoutExpired:
            fail(f"{label}: no exit within {CLI_DRAIN_S} s of SIGINT:\n{tail()}")
        if rc != 0:
            fail(f"{label}: the server exited {rc} after SIGINT:\n{tail()}")
        print(f"{label}: exit 0 after SIGINT", flush=True)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        os.close(log_fd)
        os.unlink(log_path)


def serve_embed() -> dict:
    """Phase 6: /v1/embeddings on the catalog's embedder, Qwen2.5-0.5B at
    full width and depth (QWEN_05B_CONFIG, random bf16 weights from a
    seed), written with `weights.save_safetensors` and loaded back
    bit-equal. In-process (`serve_run`, the counted main path): greedy and
    seeded chat (EMBED_CHAT) while batches of 8 embeddings (EMBED_LENGTHS)
    are posted until three of them ran while a stream was live. Gates: B2
    launches 24 times a batch and a prefill admission; every served
    vector bit-equal to in-process `hidden_states` on the card; the chat
    streams equal an eager synchronous engine's. Reports each batch's time
    on the serve loop (the delay it adds to the streams' next step). Then
    torch.profiler over one batch of 8 (B2's launches, which must be 24,
    and its share of device time), the vectors against the plain f32 path
    (EMBED_ATOL, EMBED_MIN_COS, which that path without its last layer must
    read outside), and the checkpoint through `main` in a
    subprocess (`cli_process`): batches of 8 and single inputs, each
    bit-equal to in-process `hidden_states`, ms per request and tokens/s,
    the prompt tokens on /metrics. Returns B2's launches in the
    in-process run."""
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from kubeai_tpu_torch.engine.server import EngineServer
    from kubeai_tpu_torch.engine.weights import load_params, save_safetensors
    from kubeai_tpu_torch.models import llama
    from kubeai_tpu_torch.ops.attention import causal_prefill_attention

    root = tempfile.mkdtemp(prefix="kubeai-serve-embed-")
    try:
        t0 = time.perf_counter()
        params, tensors, cfg = qwen_weights()
        model_dir = os.path.join(root, "qwen")
        save_safetensors(model_dir, tensors, QWEN_05B_CONFIG)
        nbytes = os.path.getsize(os.path.join(model_dir, "model.safetensors"))
        del params
        params = load_params("qwen", model_dir, cfg, device="cuda")
        n = check_loaded_bits(params, tensors, QWEN_LEAVES, QWEN_LAYER_LEAVES,
                              cfg.num_layers)
        if params["lm_head"] is not params["embed"]:
            fail("serve_embed: the loaded Qwen2.5-0.5B head is not tied to the embedding")
        del tensors
        print(f"serve_embed: random Qwen2.5-0.5B weights ({cfg.num_layers} layers, "
              f"{cfg.num_heads} heads over {cfg.num_kv_heads} at head_dim {cfg.head_size}, "
              f"biases, tied), {nbytes / 1e9:.3f} GB written and loaded back ({n} leaves "
              f"bit-equal) in {time.perf_counter() - t0:.2f} s", flush=True)

        # In-process: chat streams with embedding batches between their steps.
        texts8 = _embed_texts(EMBED_LENGTHS, 6)
        calls, on_loop = [], []
        embed = EngineServer.embed

        def timed_embed(self, tokens, lengths):
            live = self.engine.has_work()
            t = time.perf_counter()
            out = embed(self, tokens, lengths)
            on_loop.append((time.perf_counter() - t, live))
            return out

        def side(port):
            while sum(live for _, live in on_loop) < 3 and len(calls) < 40:
                status, res, _, total_s = _post(port, {"input": texts8},
                                                path="/v1/embeddings")
                if status != 200:
                    raise RuntimeError(f"/v1/embeddings: HTTP {status} {res}")
                calls.append(([d["embedding"] for d in res["data"]], total_s))

        EngineServer.embed = timed_embed
        try:
            run = serve_run(params, cfg, "embed", waves=[EMBED_CHAT], family="qwen",
                            side=side)
        finally:
            EngineServer.embed = embed
        b2, admitted = run["launches"]["flash_causal_prefill"], run["admissions"]
        print(f"serve embed: {len(calls)} batches of 8 beside the chat streams; "
              f"flash_causal_prefill launched {b2} times for them and {admitted} prefill "
              f"admissions ({cfg.num_layers} layers)", flush=True)
        if b2 != cfg.num_layers * (len(calls) + admitted):
            fail(f"serve embed: B2 launched {b2} times, not {cfg.num_layers} a batch and "
                 "an admission")
        live = [s * 1e3 for s, was_live in on_loop if was_live]
        if len(live) < 3:
            fail(f"serve embed: only {len(live)} batches ran while a stream was live")
        print(f"serve embed: a batch of 8 (bucket 2048) on the serve loop took "
              f"{json.dumps([round(s * 1e3, 3) for s, _ in on_loop])} ms, "
              f"{json.dumps([round(x, 3) for x in live])} of them between two steps of "
              f"live streams: the delay each added to the streams' next step; client "
              f"seconds {json.dumps([round(t, 4) for _, t in calls])}", flush=True)
        want8 = _in_process_vectors(params, cfg, texts8)
        for served, _ in calls:
            _same_vectors("in-process server", served, want8)
        print(f"serve embed: all {len(calls)} served batches bit-equal to in-process "
              "hidden_states on the card", flush=True)
        check_streams_equal_eager(params, cfg, "embed chat", run)
        free(run)

        # B2 in one batch of 8, and the plain f32 path on the same weights.
        tokens, lengths = (t.cuda() for t in _embed_inputs(texts8))
        prof = profile(None, "embed batch 8",
                       lambda _: llama.hidden_states(params, cfg, tokens, lengths),
                       e_steps=1, calls=1)
        total = sum(getattr(e, "self_device_time_total", 0) for e in prof["rows"])
        b2_rows = [e for e in prof["rows"] if "flash_prefill_kernel" in e.key]
        b2_us = sum(getattr(e, "self_device_time_total", 0) for e in b2_rows)
        b2_n = sum(e.count for e in b2_rows)
        print(f"profile embed_batch_8 B2 {b2_us / 1e3:.4f} ms in {b2_n} launches, "
              f"{b2_us / max(total, 1):.3f} of its device time ({total / 1e3:.4f} ms)",
              flush=True)
        if b2_n != cfg.num_layers:
            fail(f"serve embed: torch.profiler saw {b2_n} B2 launches in a batch, not "
                 f"{cfg.num_layers}")
        p32 = {k: v.float() for k, v in params.items() if k != "layers"}
        p32["layers"] = {k: v.float() for k, v in params["layers"].items()}
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        # A broken trunk for the limits to catch: the last layer left out.
        short = dict(p32, layers={k: v[:-1] for k, v in p32["layers"].items()})
        flash = llama.flash_causal_prefill
        llama.flash_causal_prefill = causal_prefill_attention
        try:
            with torch.no_grad():
                plain = llama.hidden_states(p32, cfg32, tokens, lengths).cpu()
                broken = llama.hidden_states(
                    short, dataclasses.replace(cfg32, num_layers=cfg.num_layers - 1),
                    tokens, lengths).cpu()
        finally:
            llama.flash_causal_prefill = flash
        del p32, short
        err = float((want8 - plain).abs().max())
        cos = float((want8 * plain).sum(-1).min())
        b_err = float((broken - plain).abs().max())
        b_cos = float((broken * plain).sum(-1).min())
        print(f"serve embed: batch of 8 against the plain f32 path: max |err| {err:.3e} "
              f"(limit {EMBED_ATOL}), least cosine {cos:.6f} (limit {EMBED_MIN_COS}); "
              f"the f32 path without its last layer reads {b_err:.3e} and {b_cos:.6f}",
              flush=True)
        if err > EMBED_ATOL or cos < EMBED_MIN_COS:
            fail("serve embed: the served vectors are off the plain f32 path")
        if b_err <= EMBED_ATOL or b_cos >= EMBED_MIN_COS:
            fail("serve embed: a trunk without its last layer reads within the limits, "
                 "so they cannot tell a broken trunk")

        # The entry point: main in a subprocess.
        gc.collect()
        torch.cuda.empty_cache()
        with cli_process(model_dir, "serve_embed main", ["--num-slots", "8", "--max-seq-len",
                                                        "2048"]) as port:
            batches = [("batch 8", texts8)] + [
                (f"batch 1 of {n}", [t]) for n, t in zip(EMBED_SINGLE,
                                                         _embed_texts(EMBED_SINGLE, 7))]
            posted = 0
            for label, texts in batches:
                want = _in_process_vectors(params, cfg, texts)
                secs = []
                for _ in range(EMBED_REPEATS):
                    status, res, _, total_s = _post(port, {"input": texts},
                                                    path="/v1/embeddings")
                    if status != 200:
                        fail(f"serve_embed main {label}: HTTP {status} {res}")
                    _same_vectors(f"main {label}", [d["embedding"] for d in res["data"]],
                                  want)
                    secs.append(total_s)
                    posted += res["usage"]["prompt_tokens"]
                ntok = sum(len(t) for t in texts)
                med = sorted(secs)[len(secs) // 2]
                print(f"serve_embed main {label}: {ntok} tokens; ms per request "
                      f"{json.dumps([round(s * 1e3, 3) for s in secs])} (median "
                      f"{med * 1e3:.3f}); {ntok / med:.1f} tokens/s; every response "
                      "bit-equal to in-process hidden_states", flush=True)
            counted = _parse_metrics(_get(port, "/metrics")[1]).get(
                ("kubeai_engine_prompt_tokens_total", ()), 0.0)
            if counted < posted:
                fail(f"serve_embed main: /metrics counts {counted} prompt tokens, "
                     f"{posted} were embedded")
        print(f"serve_embed card: {gpu_line()}", flush=True)
        del params
        return {"flash_causal_prefill_d64": b2}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---- serve_whisper: whisper-small through /v1/audio/transcriptions -----------------

# HF openai/whisper-small config.json, all 12 + 12 layers: d_model 768, 12
# heads, ffn 3072, 80 mel bins, vocab 51865, 1500 / 448 positions; 0.242 B
# parameters, 0.97 GB in f32.
WHISPER_SMALL_CONFIG = {
    "architectures": ["WhisperForConditionalGeneration"], "model_type": "whisper",
    "vocab_size": 51865, "num_mel_bins": 80, "d_model": 768, "encoder_layers": 12,
    "encoder_attention_heads": 12, "decoder_layers": 12, "decoder_attention_heads": 12,
    "encoder_ffn_dim": 3072, "decoder_ffn_dim": 3072, "max_source_positions": 1500,
    "max_target_positions": 448, "decoder_start_token_id": 50258, "eos_token_id": 50257,
}
WHISPER_AUDIO_S = 5
# The card in f32 (TF32 off, PyTorch's default) against the CPU in f32: only
# the sum order differs.
WHISPER_ATOL = 1e-3


def _speech_wav(seconds: int, seed: int) -> bytes:
    """16 kHz mono 16-bit WAV: a chirp from 200 Hz to 2 kHz under noise."""
    import io
    import wave

    import numpy as np

    sr = 16000
    t = np.arange(seconds * sr) / sr
    pcm = 0.4 * np.sin(2 * np.pi * (200 * t + 180 * t ** 2))
    pcm += 0.05 * np.random.default_rng(seed).standard_normal(len(t))
    buf = io.BytesIO()
    with wave.open(buf, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _leaves_of(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_of(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_of(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def serve_whisper() -> None:
    """Phase 7: whisper-small at full width and depth (WHISPER_SMALL_CONFIG,
    random f32 weights from a seed) written in the HF layout
    (`weights.whisper_hf_tensors`) and loaded back bit-equal. On the card
    in-process: `encode` and `decoder_logits` within WHISPER_ATOL of the
    port on the CPU (decoder on the card's encoder states), and
    `transcribe_tokens` over a 5-second 16 kHz WAV made here: encode ms,
    ms per decoded token, tokens decoded, the real-time factor. Then the
    checkpoint through `main` in a subprocess (`cli_process`, on cuda by
    default): the served text (token ids: the directory has no tokenizer)
    must be the in-process ids, and /metrics must count one request and 5
    seconds of audio."""
    import gc
    import http.client
    import os
    import shutil
    import tempfile

    import torch

    from kubeai_tpu_torch.engine.weights import (
        load_params,
        save_safetensors,
        whisper_hf_tensors,
    )
    from kubeai_tpu_torch.models import whisper

    cfg = whisper.WhisperConfig.from_hf_dict(WHISPER_SMALL_CONFIG)
    root = tempfile.mkdtemp(prefix="kubeai-serve-whisper-")
    try:
        t0 = time.perf_counter()
        drawn = whisper.init_params(cfg, torch.Generator("cuda").manual_seed(8), device="cuda")
        model_dir = os.path.join(root, "whisper")
        save_safetensors(model_dir, whisper_hf_tensors(drawn, cfg), WHISPER_SMALL_CONFIG)
        params = load_params("whisper", model_dir, cfg, dtype=torch.float32, device="cuda")
        leaves = dict(_leaves_of(params))
        for name, want in _leaves_of(drawn):
            if not torch.equal(leaves[name], want):
                fail(f"serve_whisper: loaded {name} is not the tensor written")
        nbytes = sum(t.nbytes for t in leaves.values())
        del drawn
        print(f"serve_whisper: random whisper-small weights ({cfg.encoder_layers} + "
              f"{cfg.decoder_layers} layers, d_model {cfg.d_model}), f32, "
              f"{nbytes / 1e9:.3f} GB written and loaded back ({len(leaves)} leaves "
              f"bit-equal) in {time.perf_counter() - t0:.2f} s", flush=True)
        wav = _speech_wav(WHISPER_AUDIO_S, 9)
        mel = whisper.log_mel_spectrogram(whisper.decode_wav(wav), cfg.num_mel_bins,
                                          2 * cfg.max_source_positions)
        mel_t = torch.from_numpy(mel)[None]
        with torch.no_grad():
            enc = whisper.encode(params, cfg, mel_t.cuda())
        encode_ms = cuda_ms(lambda: whisper.encode(params, cfg, mel_t.cuda()), iters=3,
                            warmup=1)
        t0 = time.perf_counter()
        ids = whisper.transcribe_tokens(params, cfg, mel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not ids:
            fail("serve_whisper: transcribe_tokens decoded no token")
        per_token = (wall * 1e3 - encode_ms) / len(ids)
        print(f"serve_whisper transcribe_tokens on the card: encode {encode_ms:.3f} ms "
              f"(3000 mel frames -> {enc.shape[1]} states); {len(ids)} tokens decoded "
              f"(cap {cfg.max_target_positions - 1}) in {wall:.3f} s: {per_token:.3f} ms "
              f"a token after the encode; real-time factor {wall / WHISPER_AUDIO_S:.4f} "
              f"for {WHISPER_AUDIO_S} s of audio", flush=True)

        # The port on the CPU, on the same weights and inputs.
        def to_cpu(tree):
            if isinstance(tree, dict):
                return {k: to_cpu(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [to_cpu(v) for v in tree]
            return tree.cpu()

        params_cpu = to_cpu(params)
        t0 = time.perf_counter()
        with torch.no_grad():
            enc_cpu = whisper.encode(params_cpu, cfg, mel_t)
            prefix = torch.tensor([[cfg.decoder_start_token_id, *ids[:15]]])
            logits = whisper.decoder_logits(params, cfg, prefix.cuda(), enc).cpu()
            logits_cpu = whisper.decoder_logits(params_cpu, cfg, prefix, enc.cpu())
        enc_err = float((enc.cpu() - enc_cpu).abs().max())
        logit_err = float((logits - logits_cpu).abs().max())
        print(f"serve_whisper card against the CPU (f32 both; CPU {time.perf_counter() - t0:.2f}"
              f" s): encode max |err| {enc_err:.3e}, decoder_logits over {prefix.shape[1]} "
              f"tokens max |err| {logit_err:.3e} (limit {WHISPER_ATOL}); greedy picks "
              f"{'equal' if logits.argmax(-1).equal(logits_cpu.argmax(-1)) else 'differ'}",
              flush=True)
        if enc_err > WHISPER_ATOL or logit_err > WHISPER_ATOL:
            fail("serve_whisper: the card is off the CPU")
        del params_cpu, enc_cpu

        # The entry point: main in a subprocess, on the card by default.
        gc.collect()
        torch.cuda.empty_cache()
        boundary = "kubeai-smoke"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode()
        body += wav + f"\r\n--{boundary}--\r\n".encode()
        with cli_process(model_dir, "serve_whisper main") as port:
            served_s = []
            for _ in range(2):  # the first request includes the process's first calls
                t0 = time.perf_counter()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=REQUEST_TIMEOUT_S)
                conn.request("POST", "/v1/audio/transcriptions", body,
                             {"Content-Type": f"multipart/form-data; boundary={boundary}"})
                resp = conn.getresponse()
                res = json.loads(resp.read())
                conn.close()
                served_s.append(time.perf_counter() - t0)
                if resp.status != 200:
                    fail(f"serve_whisper main: HTTP {resp.status} {res}")
                served = [int(x) for x in res["text"].split()]
                if served != ids:
                    step = _leading_equal(served, ids)
                    fail(f"serve_whisper main: served ids differ from in-process "
                         f"transcribe_tokens at token {step}: {served[step:step + 4]} vs "
                         f"{ids[step:step + 4]}")
            metrics = _parse_metrics(_get(port, "/metrics")[1])
            reqs = sum(v for (n, _), v in metrics.items()
                       if n == "kubeai_engine_requests_total")
            audio = metrics.get(("kubeai_engine_audio_seconds_total", ()))
            if reqs != 2 or audio != 2 * WHISPER_AUDIO_S:
                fail(f"serve_whisper main: /metrics counts {reqs} requests and {audio} s "
                     "of audio, not 2 and 2 x {WHISPER_AUDIO_S}")
            print(f"serve_whisper main: {len(ids)} served ids equal to in-process "
                  f"transcribe_tokens, twice; requests {served_s[0]:.3f} s and "
                  f"{served_s[1]:.3f} s for {WHISPER_AUDIO_S} s of audio (real-time factor "
                  f"{served_s[1] / WHISPER_AUDIO_S:.4f} for the second); /metrics "
                  f"{reqs:.0f} requests, {audio} s of audio", flush=True)
        print(f"serve_whisper card: {gpu_line()}", flush=True)
        del params, enc
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---- phase 4g: serve_sharded_cli, sharded serving through the entry point -----

# The catalog's sharded entries at one rank's heads: Llama-3-8B at tp=4
# (llama-3.1-8b-instruct-tpu) and tp=8, the 70B at tp=8 (one KV head a
# rank), every kernel at D=128 on ragged lengths to 2048; gemma2-9b-it-tpu
# at tp=4 (B1, B4 and B1-int8 at D=256, plain and with Gemma-2's window
# 4096 and softcap 50), gemma-7b-it-tpu at tp=4 (B2 and B1-int8 at D=256)
# and gemma2-27b-it-tpu at tp=8 (B1 and B4 at D=128 with the window and
# softcap), on ragged lengths to 8192 so that the window masks keys.
# (label, H, KVH, D, max_len, kernels, (softcap, window) cases)
_TP_KERNELS = ("B1", "B1-int8", "B4", "B3", "B2")
_PLAIN = ((None, None),)
_GEMMA2_MASKS = ((None, None), (50.0, 4096))
TP_LOCAL_HEADS = (
    ("8B tp=4", 8, 2, 128, 2048, _TP_KERNELS, _PLAIN),
    ("8B tp=8", 4, 1, 128, 2048, _TP_KERNELS, _PLAIN),
    ("70B tp=8", 8, 1, 128, 2048, _TP_KERNELS, _PLAIN),
    ("Gemma-2-9B tp=4", 4, 2, 256, 8192, ("B1", "B1-int8", "B4"), _GEMMA2_MASKS),
    ("Gemma-7B tp=4", 4, 4, 256, 8192, ("B1-int8", "B2"), _PLAIN),
    ("Gemma-2-27B tp=8", 4, 2, 128, 8192, ("B1", "B4"), ((50.0, 4096),)),
)
# The int8 GEMM's local weights (K, N): wk at tp=4 and 8, w_down at tp=4.
TP_LOCAL_GEMMS = (("wk tp=4", 4096, 256), ("wk tp=8", 4096, 128),
                  ("w_down tp=4", 3584, 4096))


def check_rank_local_kernels() -> dict:
    """B1, B1-int8, B2, B3 and B4 at the heads one rank of a sharded
    catalog entry walks (TP_LOCAL_HEADS: each case's kernels, with its
    softcap and window cases), and both W8A16 routes at its local weights
    (TP_LOCAL_GEMMS), each against its plain version at its own limits and
    timed beside its bound and its library call, as in the kernel phase's
    serving cases. Returns {(kernel, shape label): line}."""
    import torch

    gen = torch.Generator().manual_seed(31)
    out = {}
    for label, H, KVH, D, max_len, kernels, masks in TP_LOCAL_HEADS:
        q, kp, vp, bt, lengths = _paged_inputs(gen, H=H, KVH=KVH, D=D, max_len=max_len)
        shape = f"H={H} KVH={KVH} D={D} max_len={max_len}"
        cg = torch.Generator("cuda").manual_seed(32)
        B = q.shape[0]
        kn = torch.randn(B, KVH, D, generator=cg, device="cuda").to(torch.bfloat16)
        vn = torch.randn(B, KVH, D, generator=cg, device="cuda").to(torch.bfloat16)
        for cap, win in masks:
            kw = dict(logit_softcap=cap, window=win)
            tag = label if cap is None and win is None else f"{label} softcap={cap} window={win}"
            for name, kernel, pools in (("paged_decode_attention", "B1", (kp, vp)),
                                        ("paged_decode_attention_int8", "B1-int8", None)):
                if kernel not in kernels:
                    continue
                if pools is None:
                    pools = (_quantize_pool(kp), _quantize_pool(vp))
                args = (q, *pools, bt, lengths)
                _, err = _check_decode_case(tag, args, kw)
                line = dict(_time_decode(args, kw, library=True), max_abs_err=err)
                out[(name, tag)] = line
                print(f"kernel {name} rank-local {tag} {shape} {json.dumps(line)}", flush=True)
                del pools, args
            if "B4" in kernels:
                # The same pools as one layer of a 2-layer stack, the new token.
                pos = (lengths - 1).clamp(min=0).to(torch.int32)
                args = (q, torch.stack([kp, kp]), torch.stack([vp, vp]), kn, vn, bt, pos, 1)
                _, err = _check_fused_case(tag, args, kw)
                line = dict(_time_fused(args, kw, library=True), max_abs_err=err)
                out[("paged_decode_attention_fused", tag)] = line
                print(f"kernel paged_decode_attention_fused rank-local {tag} {shape} "
                      f"{json.dumps(line)}", flush=True)
                del args
        if "B3" in kernels:
            # A K = 5 window at the same positions.
            K = 5
            qv = torch.randn(B, K, H, D, generator=cg, device="cuda").to(torch.bfloat16)
            pos = (lengths - K).clamp(min=0).to(torch.int32)
            args = (qv, kp, vp, bt, pos)
            _, err = _check_verify_case(label, args, {})
            line = dict(_time_verify(args, {}, library=True), max_abs_err=err)
            out[("paged_verify_attention", label)] = line
            print(f"kernel paged_verify_attention rank-local {label} {shape} "
                  f"{json.dumps(line)}", flush=True)
            del qv, args
        del q, kp, vp, kn, vn
        if "B2" in kernels:
            # B2 at a 512-token admission and a batch of 4 at 1024.
            for B2, S in ((1, 512), (4, 1024)):
                line, call = _flash_case(B2, S, H, KVH, D, gen)
                out[("flash_causal_prefill", f"{label} B={B2} S={S}")] = line
                del call
        torch.cuda.empty_cache()
    for label, K, N in TP_LOCAL_GEMMS:
        leaf = _int8_leaf(K, N, gen)
        for M in (8, 512):
            line = _gemm_case(M, K, N, leaf, gen, timed=True)
            out[(line["kernel"], f"{label} M={M}")] = line
    return out


# serve_sharded_cli: the entry point over ranks. Llama-3-8B's width at
# SHARDED_LAYERS of 32 layers (its catalog entry runs tp=4) and
# Mixtral-8x7B's at MIXTRAL_CLI_LAYERS (its experts over tp=2), from
# checkpoints written with `weights.save_safetensors`. NCCL refuses two
# ranks on one card ("Duplicate GPU detected", `report_nccl_one_card`), so
# the sharded parts run their ranks over gloo, time-sliced on the card:
# their times are no parallel speed. Their eager steps over gloo cost
# time in proportion to depth: the parts take serve_cli's 4 layers.
SHARDED_LAYERS = CLI_LAYERS
SHARDED_CONFIG = dict(CLI_CONFIG, num_hidden_layers=SHARDED_LAYERS)
# The 8B entry's --num-slots 64 --max-seq-len 8192 pools do not fit one
# card next to four ranks: the served parts take the CLI runs' 8 x 2048.
SHARDED_FLAGS = ["--num-slots", "8", "--max-seq-len", "2048", "--drain-timeout", "30",
                 "--watchdog-timeout", "120"]
SHARDED_ENGINE = dict(num_slots=8, max_seq_len=2048, max_adapters=4, step_overlap="off",
                      decode_kernel="per_layer")
# (label, flags, checkpoint, ranks, adapter): the sharded parts (b) and (c).
SHARDED_PARTS = (
    ("2x2", ["--tpu-topology", "2x2"], "llama", 4, True),
    ("mixtral 1x2", ["--tpu-topology", "1x2"], "mixtral", 2, False),
)
# A served part's limit, its ranks included (the group is killed past it).
SHARDED_TIMEOUT_S = 420
# The gemma parts, a second wave once (a)-(c) and their references have
# ended (the host holds each wave's rank processes at once): the catalog's
# gemma2-9b-it-tpu and gemma-7b-it-tpu at tp=4 (2x2, `catalog/models.yaml`
# :37-42 and :187-192) at GEMMA_CLI_LAYERS of their layers (Gemma-2-9B's:
# one windowed, one global), from checkpoints written as serve_cli_gemma
# writes them. (label, HF config, layer leaves, flags, reference runs (the
# served one first), the wrappers each served rank must launch, heads a
# rank, head dim)
GEMMA_SHARDED_PARTS = (
    ("gemma2 2x2", GEMMA_CLI_CONFIG, GEMMA_CLI_LAYER_LEAVES, ["--tpu-topology", "2x2"],
     ("per_layer", "fused"), ("paged_decode_attention",), (4, 2), 256),
    ("gemma1 int8 2x2", GEMMA1_CLI_CONFIG, GEMMA1_CLI_LAYER_LEAVES,
     ["--tpu-topology", "2x2", "--kv-dtype", "int8"], ("int8",),
     ("flash_causal_prefill", "paged_decode_attention_int8"), (4, 4), 256),
)
# Part (b)'s /v1/embeddings inputs (its one process holds every rank, so
# it serves them through the lockstep op), held to world 1's
# hidden_states at EMBED_ATOL and EMBED_MIN_COS.
SHARDED_EMBED_TEXTS = ["hello", "The quick brown fox jumps over the lazy dog.",
                       ("The quick brown fox jumps over the lazy dog. " * 7)[:300]]


def _sharded_bodies() -> list[dict]:
    """The served parts' requests, sent one at a time so that each is
    admitted alone, as the in-process reference admits it: greedy unary,
    seeded streamed and greedy streamed, 8 tokens each."""
    text = "The quick brown fox jumps over the lazy dog. "
    return [
        {"messages": [{"role": "user", "content": "Hello there"}], "max_tokens": 8,
         "temperature": 0},
        {"messages": [{"role": "user", "content": (text * 3)[:100]}], "max_tokens": 8,
         "temperature": 0.8, "seed": 1, "stream": True},
        {"messages": [{"role": "user", "content": (text * 7)[:300]}], "max_tokens": 8,
         "temperature": 0, "stream": True},
    ]


ADAPTER_BODY = {"model": "tenant", "messages": [{"role": "user", "content": "Hello there"}],
                "max_tokens": 8, "temperature": 0}


def _request_specs(adapter: bool) -> list[tuple[list[int], dict, str | None]]:
    """(prompt ids, sampling kwargs, adapter) of each served request, as
    the server's ByteTokenizer chat template encodes it."""
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    bodies = _sharded_bodies() + ([ADAPTER_BODY] if adapter else [])
    return [(tok.apply_chat_template(b["messages"]),
             dict(temperature=b["temperature"], max_tokens=b["max_tokens"], seed=b.get("seed")),
             "tenant" if b.get("model") == "tenant" else None) for b in bodies]


# The in-process references' runs over the served part's ranks: run ->
# (engine settings over SHARDED_ENGINE, the decode kernel's wrapper, its
# kernel's name in a profile, its launches a program call in layers).
# A reference's first run is the served configuration (per_layer, or
# int8 for the gemma part served on --kv-dtype int8) and runs every
# served request; the others (the fused layout, speculate=4) run the
# first, a greedy base request.
SHARDED_REF_RUNS = {
    "per_layer": ({}, "paged_decode_attention", "paged_decode_combine_kernel", 8),
    "fused": (dict(decode_kernel="fused"), "paged_decode_attention_fused",
              "paged_fused_combine_kernel", 8),
    "speculate": (dict(speculate=4, spec_adaptive=False), "paged_verify_attention",
                  "paged_verify_split_kernel", 1),
    "int8": (dict(kv_dtype="int8"), "paged_decode_attention_int8",
             "paged_decode_combine_kernel", 8),
}
# The first prefill's logits of a sharded engine against world 1's, both
# in bf16, each held against the same weights in f32 on the CPU. Sharding
# moves where bf16 rounds (each rank's partial sum of a row-parallel
# product is rounded before the f32 all_reduce, where world 1 rounds the
# whole product once), not how coarsely: its max |err| against f32 may be
# at most SHARDED_ERR_FACTOR times world 1's own.
SHARDED_ERR_FACTOR = 2.0
# World 1 over NCCL (`sharded_world1`): the engine PR 26's serve_tp ran.
WORLD1_ENGINE = dict(num_slots=4, max_seq_len=1024, page_size=64, decode_chunk=4)


def _logits_batch(requests):
    """The first two requests' prompts, each cut to its first 64 tokens
    and right-padded to 64: (tokens, lengths) on the CPU."""
    import torch

    prompts = [p[:64] for p, *_ in requests[:2]]
    tokens = torch.zeros((2, 64), dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    return tokens, torch.tensor([len(p) for p in prompts])


def _prefill_logits(engine, requests):
    """The family's prefill over `_logits_batch` on the engine's params
    and tp group: f32 logits on the CPU."""
    import torch

    tokens, lengths = _logits_batch(requests)
    kw = {} if engine._tp is None else {"tp": engine._tp}
    with torch.no_grad():
        logits, _, _ = engine.family.prefill(engine.params, engine.model_cfg,
                                             tokens.cuda(), lengths.cuda(), **kw)
    return logits.float().cpu()


def _f32_prefill_logits(family, params, cfg, requests):
    """`family.prefill` over `_logits_batch` with `params` (moved off the
    card as they are read) in f32 on the CPU: the reference the sharded
    logits are held to."""
    import dataclasses

    import torch

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.float().cpu()

    tokens, lengths = _logits_batch(requests)
    with torch.no_grad():
        logits, _, _ = family.prefill(cpu(params), dataclasses.replace(cfg, dtype=torch.float32),
                                      tokens, lengths)
    return logits


def _generate_each(engine, requests) -> list[list[int]]:
    """Each (prompt, sampling kwargs, adapter) run alone, in order."""
    from kubeai_tpu_torch.engine import SamplingParams

    out = []
    for prompt, sp, adapter in requests:
        rid = engine.add_request(prompt, SamplingParams(**sp), adapter=adapter)
        stream = []
        while engine.has_work():
            stream += [ev.token for ev in engine.step() if ev.rid == rid]
        out.append(stream)
    return out


def sharded_ref_rank(spec_path: str, rank: int) -> None:
    """One rank of an in-process reference for a served part (a process of
    its own, over gloo with the others on the card): the spec's checkpoint
    loaded rank-locally (`weights.ShardPlan`) into an engine of each of
    the spec's runs (SHARDED_REF_RUNS) on the same params; the first, the
    served configuration, runs each served request alone in order (the
    adapter loaded from its PEFT directory first) and the first prefill's
    logits (`_logits_batch`), the other runs the first request; then one
    admission and one call of each run's decode program, which rank 0
    alone records with torch.profiler (the other ranks run the same
    collectives unrecorded). Writes its streams, launch counts and heads
    beside the spec, and its logits in a file of their own."""
    import datetime

    import torch
    import torch.distributed as dist

    from kubeai_tpu_torch.engine import Engine, EngineConfig
    from kubeai_tpu_torch.engine.lora_weights import load_peft_adapter
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
    from kubeai_tpu_torch.engine.weights import ShardPlan, load_hf_config, load_params
    from kubeai_tpu_torch.models.registry import get_model_family
    from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{spec['rendezvous']}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    try:
        phases = {"group": time.perf_counter() - t0}
        mesh = build_mesh(MeshConfig(tp=world))
        hf = load_hf_config(spec["model_dir"])
        family = get_model_family(hf["architectures"][0])
        cfg = family.config_from_hf(hf)
        params = load_params(family.name, spec["model_dir"], cfg, device="cuda",
                             shard=ShardPlan(family, cfg, mesh))
        engines = {run: Engine(family, cfg, params, mesh=mesh, presharded=True,
                               eos_token_ids=ByteTokenizer().eos_token_ids,
                               cfg=EngineConfig(**{**SHARDED_ENGINE,
                                                   **SHARDED_REF_RUNS[run][0]}))
                   for run in spec["runs"]}
        served = spec["runs"][0]
        engine = engines[served]
        out = {"rank": rank, "runs": {}, "kv_heads": engine.cache.k_pages.shape[-2],
               "q_columns": engine.params["layers"]["wq"].shape[-1], "phases": phases,
               "b2_expected": family.prefill_uses_flash(cfg)}
        phases["load and build"] = time.perf_counter() - t0 - phases["group"]
        t = time.perf_counter()
        torch.save(_prefill_logits(engine, spec["requests"]), f"{spec['out']}.rank{rank}.pt")
        if spec["adapter_dir"]:
            engine.load_adapter("tenant", load_peft_adapter(
                spec["adapter_dir"], cfg, max_rank=engine.cfg.max_lora_rank))
        for run, eng in engines.items():
            _zero_launches(eng)
            requests = spec["requests"] if run == served else spec["requests"][:1]
            out["runs"][run] = {"streams": _generate_each(eng, requests),
                                "launches": {k: v for k, v in _launches(eng).items() if v}}
        out["streams"] = out["runs"][served]["streams"]
        out["launches"] = out["runs"][served]["launches"]
        phases["requests"] = time.perf_counter() - t
        t = time.perf_counter()
        toks = torch.tensor([spec["requests"][-1][0]], device="cuda")

        def admission_and_calls():
            engine.family.prefill(engine.params, cfg, toks,
                                  torch.tensor([toks.shape[1]], device="cuda"), tp=engine._tp)
            for run, eng in engines.items():
                (eng._spec_program if run == "speculate" else eng._decode_program).fn()

        if rank == 0:
            counts = _kernel_counts(admission_and_calls, ["flash_prefill_kernel"] + [
                SHARDED_REF_RUNS[run][2] for run in engines])
            out["b2_per_admission"] = counts["flash_prefill_kernel"]
            for run in engines:
                out["runs"][run]["walk_per_call"] = counts[SHARDED_REF_RUNS[run][2]]
        else:
            with torch.no_grad():
                admission_and_calls()
            torch.cuda.synchronize()
        phases["profile" if rank == 0 else "admission and calls"] = time.perf_counter() - t
        out["num_layers"] = cfg.num_layers
        out["seconds"] = time.perf_counter() - t0
        out["written"] = time.time()
        path = f"{spec['out']}.rank{rank}.json"
        with open(f"{path}.tmp", "w") as f:
            json.dump(out, f)
        os.replace(f"{path}.tmp", path)
    finally:
        dist.destroy_process_group()


def _kernel_counts(fn, names) -> dict:
    """torch.profiler's launches of each kernel whose name holds one of
    `names`, over one call of fn (device activity only: the host ops of an
    eager forward would cost more to record than the call takes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch.no_grad(), torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return {n: sum(e.count for e in rows if n in e.key) for n in names}


def _start_ref_world(label: str, model_dir: str, world: int, requests, adapter_dir,
                     runs, tmp: str) -> dict:
    """Start a served part's in-process reference (`runs` of
    SHARDED_REF_RUNS) over `world` gloo ranks on the card: each rank a
    `timeout`ed process in its own session, its output in a log beside
    the spec."""
    tag = label.replace(" ", "_")
    spec = dict(model_dir=model_dir, world=world, requests=requests, adapter_dir=adapter_dir,
                runs=list(runs), rendezvous=os.path.join(tmp, f"rdv_{tag}"),
                out=os.path.join(tmp, f"ref_{tag}"))
    spec_path = os.path.join(tmp, f"ref_{tag}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    w = dict(label=label, out=spec["out"], procs=[], logs=[], t0=time.perf_counter(),
             wall0=time.time())
    for rank in range(world):
        log_path = f"{spec['out']}.rank{rank}.log"
        w["logs"].append(log_path)
        with open(log_path, "w") as log:
            w["procs"].append(subprocess.Popen(
                ["timeout", "-k", "10", str(SHARDED_TIMEOUT_S), sys.executable, "-c",
                 f"import chip_smoke as c; c.sharded_ref_rank({spec_path!r}, {rank})"],
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True))
    return w


def _kill_worlds(worlds) -> None:
    """Kill the process group of every rank still running."""
    import signal

    for w in worlds:
        for p in w["procs"]:
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=30)


def _finish_worlds(worlds) -> list:
    """Wait until every rank of `worlds` has written its results: the first
    to fail (or the time limit) ends them all. A rank's exit after its
    results (CUDA and CUPTI teardown, ~35 s a rank on a busy host) is not
    waited for: every rank still running is killed. Returns each world's
    results, in rank order."""
    t0 = min(w["t0"] for w in worlds)
    failed = None

    def written(w) -> bool:
        return all(os.path.exists(f"{w['out']}.rank{r}.json") for r in range(len(w["procs"])))

    try:
        while failed is None and not all(written(w) for w in worlds):
            # Poll every rank each round (any() would stop at the first alive).
            codes = [[p.poll() for p in w["procs"]] for w in worlds]
            failed = next(((w, r, code) for w, cs in zip(worlds, codes)
                           for r, code in enumerate(cs) if code not in (None, 0)), None)
            for w in worlds:
                if "seconds" not in w and written(w):
                    w["seconds"] = time.perf_counter() - w["t0"]
            if time.perf_counter() - t0 > SHARDED_TIMEOUT_S + 30:
                failed = (worlds[0], 0, "the time limit")
            time.sleep(0.2)
        for w in worlds:
            w.setdefault("seconds", time.perf_counter() - w["t0"])
    finally:
        _kill_worlds(worlds)
    if failed is not None:
        w, rank, code = failed
        with open(w["logs"][rank]) as f:
            tail = f.read()[-3000:]
        fail(f"serve_sharded_cli {w['label']} reference: rank {rank} ended with {code}:\n{tail}")
    out = []
    for w in worlds:
        ranks = []
        for rank in range(len(w["procs"])):
            with open(f"{w['out']}.rank{rank}.json") as f:
                ranks.append(json.load(f))
        out.append(ranks)
        print(f"serve_sharded_cli {w['label']} reference: {len(w['procs'])} ranks on the card "
              f"in {w.get('seconds', time.perf_counter() - w['t0']):.2f} s; each rank's "
              f"seconds from its process start to its results written: "
              f"{[round(r['written'] - w['wall0'], 2) for r in ranks]}, of them in the "
              f"function {[round(r['seconds'], 2) for r in ranks]}", flush=True)
    return out


def sharded_cli_run(model_dir: str, label: str, flags: list, ranks: int,
                    adapter_dir: str | None = None, root: str | None = None,
                    env_extra: dict | None = None, running: list | None = None,
                    embeds: bool = False) -> dict:
    """`python -m kubeai_tpu_torch.engine.server` with `flags` in a
    subprocess of its own session under `timeout` (its spawned ranks in
    that session too), from the checkout or from `root`, a copy of the
    package, with `env_extra` in its environment (its process appended to
    `running`, whose caller kills what a failure elsewhere leaves): ready, the `_sharded_bodies` one at a time (all 200), with
    `adapter_dir` a PEFT adapter loaded through /v1/load_lora_adapter and
    a request that names it; with more than one rank (all in one
    process) /v1/embeddings of SHARDED_EMBED_TEXTS (200 with `embeds`, the
    vectors returned; else the family's 400), the lockstep refusal of
    `kubeai_resume` (400, the JAX server's words) and /v1/state.parallel;
    then SIGTERM, which must end the
    process (and its ranks) with exit 0 within the drain budget. On any
    failure the group is killed. Returns each request's tokens (streamed
    ids, or the unary text), seconds to Ready, ms a served token,
    and the log's rank lines."""
    import signal
    import tempfile

    # --port 0: the server binds a port the kernel picks and logs it. A
    # port probed here would stay free only until the server binds it,
    # after its load: the ranks' gloo and NCCL sockets beside it took one
    # such port once on the card.
    cmd = [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model-url", model_dir,
           "--port", "0", *SHARDED_FLAGS, *flags]
    print(f"serve_sharded_cli {label} command: {' '.join(cmd[1:])}", flush=True)
    here = root or os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "KUBEAI_TPU_DECODE_KERNEL"}
    env.update(env_extra or {}, PYTHONPATH=here)
    log_fd, log_path = tempfile.mkstemp(prefix="kubeai-sharded-", suffix=".log")
    proc = None

    def tail(n: int = 40) -> str:
        with open(log_path) as f:
            return "".join(f.readlines()[-n:])

    try:
        t_start = time.perf_counter()
        # --foreground: SIGTERM reaches the server once (not its ranks
        # through the group); a failure kills the whole session below.
        proc = subprocess.Popen(["timeout", "--foreground", "-k", "10", str(SHARDED_TIMEOUT_S),
                                 *cmd], cwd=here,
                                env=env, stdout=log_fd, stderr=subprocess.STDOUT,
                                start_new_session=True)
        if running is not None:
            running.append(proc)
        port = None
        while True:
            if proc.poll() is not None:
                fail(f"serve_sharded_cli {label}: the server exited {proc.returncode} before "
                     f"it was ready:\n{tail()}")
            if port is None:
                with open(log_path) as f:
                    said = re.search(r"engine serving on \S+:(\d+)", f.read())
                port = int(said.group(1)) if said else None
            try:
                if port is not None and _get(port, "/health")[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t_start > SHARDED_TIMEOUT_S - 60:
                fail(f"serve_sharded_cli {label}: not ready in time:\n{tail()}")
            time.sleep(0.25)
        ready_s = time.perf_counter() - t_start
        bodies = _sharded_bodies()
        if adapter_dir is not None:
            status, res, _, _ = _post(port, {"lora_name": "tenant", "lora_path": adapter_dir},
                                      path="/v1/load_lora_adapter")
            if (status, res) != (200, {"status": "loaded", "lora_name": "tenant"}):
                fail(f"serve_sharded_cli {label}: the adapter load got HTTP {status} {res}")
            bodies.append(ADAPTER_BODY)
        tokens, served_s, served_n = [], 0.0, 0
        for i, body in enumerate(bodies):
            status, res, _, total_s = _post(port, body)
            if status != 200:
                fail(f"serve_sharded_cli {label} request {i}: HTTP {status} {res}")
            if body.get("stream"):
                if not res["done"]:
                    fail(f"serve_sharded_cli {label} request {i}: no [DONE]")
                got = res["token_ids"]
            else:
                got = res["choices"][0]["message"]["content"]
            tokens.append(got)
            served_s += total_s
            served_n += res["usage"]["completion_tokens"] if isinstance(got, str) else len(got)
        state = json.loads(_get(port, "/v1/state")[1])
        refusals, vectors, embed_s = {}, None, None
        if ranks > 1:
            if state.get("parallel", {}).get("ranks") != ranks:
                fail(f"serve_sharded_cli {label}: /v1/state.parallel {state.get('parallel')}")
            t = time.perf_counter()
            e_status, e_res, _, _ = _post(port, {"input": SHARDED_EMBED_TEXTS,
                                                 "model": "model"}, path="/v1/embeddings")
            embed_s = time.perf_counter() - t
            r_status, r_res, _, _ = _post(port, {
                **bodies[0], "kubeai_resume": {"token_ids": [65], "emitted": 1}})
            refusals = {"resume": (r_status, r_res)}
            if embeds and e_status == 200:
                vectors = [d["embedding"] for d in e_res["data"]]
            elif embeds or e_status != 400 or "has no embedding support" not in json.dumps(e_res):
                fail(f"serve_sharded_cli {label}: /v1/embeddings got HTTP {e_status} {e_res}")
            else:
                refusals["embeddings"] = (e_status, e_res)
            if r_status != 400 or "multi-host" not in json.dumps(r_res):
                fail(f"serve_sharded_cli {label}: kubeai_resume got HTTP {r_status} {r_res}")
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            fail(f"serve_sharded_cli {label}: no exit within 60 s of SIGTERM:\n{tail()}")
        if rc != 0:
            fail(f"serve_sharded_cli {label}: the server exited {rc} after SIGTERM:\n{tail()}")
        with open(log_path) as f:
            log = f.read().splitlines()
    finally:
        if proc is not None and proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        os.close(log_fd)
        os.unlink(log_path)

    def lines(key: str) -> list[str]:
        return [ln for ln in log if key in ln]

    return {"tokens": tokens, "ready_s": ready_s, "state": state, "refusals": refusals,
            "embeddings": vectors, "embed_s": embed_s,
            "ms_per_token": 1e3 * served_s / max(1, served_n), "served_tokens": served_n,
            "digests": lines("lockstep digest"), "reports": lines(" KVH="),
            "before_load": lines("loading model"),
            "launches": lines("kernel launches"), "build": lines("kernel library:"),
            "cold": lines("warm-up complete")}


def _rank_fields(lines: list[str], key: str) -> dict[int, str]:
    """{rank: the rest of the line after `key` <rank>} of the log lines."""
    out = {}
    for ln in lines:
        m = re.search(rf"{key} (\d+):? (.*)$", ln)
        if m:
            out[int(m.group(1))] = m.group(2)
    return out


def _sharded_gates(label: str, run: dict, ranks: int, ref: list | None, heads,
                   head_dim: int = 128,
                   served=("flash_causal_prefill", "paged_decode_attention")) -> None:
    """A sharded part's gates: every rank's digest equal to rank 0's; each
    rank's heads, weights and peak host RSS (printed); each rank's
    launches of the `served` wrappers (its counts, in its log); rank 0's
    served tokens equal to the in-process reference's, whose ranks'
    streams agree and whose rank 0's torch.profiler shows each run's
    decode kernel, and B2 where the family's prefill takes it, at the same
    heads."""
    digests = {r: d.split("sha256 ")[-1] for r, d in
               _rank_fields(run["digests"], "rank").items()}
    if sorted(digests) != list(range(ranks)) or len(set(digests.values())) != 1:
        fail(f"serve_sharded_cli {label}: lockstep digests {run['digests']}")
    reports = _rank_fields(run["reports"], "rank")
    launches = {r: json.loads(v) for r, v in _rank_fields(run["launches"], "rank").items()}
    H, KVH = heads
    for r in range(ranks):
        if f"H={H} KVH={KVH}" not in reports.get(r, ""):
            fail(f"serve_sharded_cli {label} rank {r}: {reports.get(r)} is not H={H} KVH={KVH}")
        got = launches.get(r, {})
        if not all(got.get(w) for w in served):
            fail(f"serve_sharded_cli {label} rank {r}: launches {got} lack one of {served}")
    before = [ln.split("(")[-1].rstrip(")") for ln in run["before_load"]]
    print(f"serve_sharded_cli {label}: the {ranks} ranks' stream digests equal "
          f"({list(digests.values())[0][:16]}...); per rank: " + "; ".join(
              f"rank {r} {reports[r]}, launches since start {json.dumps(launches[r])}"
              for r in range(ranks)) + f"; before the load: {before}", flush=True)
    if ref is None:
        return
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    want = ref[0]["streams"]
    for i, (have, w) in enumerate(zip(run["tokens"], want)):
        if have != (ByteTokenizer().decode(w) if isinstance(have, str) else w):
            fail(f"serve_sharded_cli {label} request {i}: served {have}, the in-process "
                 f"tp={ranks} engine {w}")
    b2 = ref[0]["num_layers"] if ref[0]["b2_expected"] else 0
    for name in ref[0]["runs"]:
        want_run = ref[0]["runs"][name]["streams"]
        wrapper, walk, per_layer = SHARDED_REF_RUNS[name][1:]
        for r in ref:
            res = r["runs"][name]
            if res["streams"] != want_run:
                fail(f"serve_sharded_cli {label} reference {name}: the ranks' streams differ")
            if not res["launches"].get(wrapper) or (
                    b2 and not res["launches"].get("flash_causal_prefill")):
                fail(f"serve_sharded_cli {label} reference {name} rank {r['rank']}: launches "
                     f"{res['launches']} lack {wrapper}" + (" or B2" if b2 else ""))
        calls = ref[0]["runs"][name]["walk_per_call"]
        if calls != ref[0]["num_layers"] * per_layer:
            fail(f"serve_sharded_cli {label} reference {name} rank 0: {calls} {walk} launches "
                 f"a program call, not {ref[0]['num_layers'] * per_layer}")
        print(f"serve_sharded_cli {label} reference {name}: the {ranks} ranks' streams "
              f"identical ({sum(len(x) for x in want_run)} tokens); {walk} {calls} launches a "
              f"program call at H={H} KVH={KVH} D={head_dim} (torch.profiler, rank 0); rank "
              f"0's launches {json.dumps(ref[0]['runs'][name]['launches'])}", flush=True)
    if ref[0]["b2_per_admission"] != b2:
        fail(f"serve_sharded_cli {label} reference rank 0: B2 {ref[0]['b2_per_admission']} "
             f"an admission, not {b2}")
    for r in ref:
        if r["q_columns"] != H * head_dim or r["kv_heads"] != KVH:
            fail(f"serve_sharded_cli {label} reference rank {r['rank']}: "
                 f"{r['q_columns']} q columns, {r['kv_heads']} KV heads")
    print(f"serve_sharded_cli {label}: rank 0's {len(want)} served streams equal the "
          f"in-process tp={ranks} engine's token for token (its rank 0's seconds: "
          f"{json.dumps({k: round(v, 2) for k, v in ref[0]['phases'].items()})}); B2 "
          f"{ref[0]['b2_per_admission']} launches an admission at H={H} KVH={KVH} "
          f"D={head_dim}", flush=True)


def _logits_gate(label: str, out: str, ranks: int, world1: dict) -> None:
    """Each reference rank's first prefill logits (`<out>.rank<r>.pt`)
    finite, of world 1's shape, and no further from the f32 CPU reference
    than SHARDED_ERR_FACTOR times world 1's own."""
    import torch

    w1, f32 = world1["logits"], world1["f32_logits"]
    w1_err = float((w1 - f32).abs().max())
    for rank in range(ranks):
        got = torch.load(f"{out}.rank{rank}.pt")
        if got.shape != w1.shape or not torch.isfinite(got).all():
            fail(f"serve_sharded_cli {label} rank {rank}: first prefill logits "
                 f"{tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        err = float((got - f32).abs().max())
        if err > SHARDED_ERR_FACTOR * w1_err:
            fail(f"serve_sharded_cli {label} rank {rank}: first prefill logits max |err| "
                 f"{err:.4e} against f32, beyond {SHARDED_ERR_FACTOR} x world 1's {w1_err:.4e}")
        if rank == 0:
            agree = float((got.argmax(-1) == w1.argmax(-1)).float().mean())
            print(f"serve_sharded_cli {label}: first prefill logits max |err| against f32 on "
                  f"the CPU {err:.4e}, world 1's {w1_err:.4e} (limit {SHARDED_ERR_FACTOR} x); "
                  f"against world 1 {float((got - w1).abs().max()):.4e}; |logit| up to "
                  f"{float(f32.abs().max()):.3f}; argmax agreement with world 1 {agree:.3f}",
                  flush=True)


def _embed_batch(texts: list[str], max_seq_len: int):
    """(tokens, lengths) of `texts` on the CPU as the server batches them
    for /v1/embeddings: ByteTokenizer ids right-padded to the prefill
    bucket of the longest."""
    import torch

    from kubeai_tpu_torch.engine import EngineConfig
    from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer

    ids = [ByteTokenizer().encode(t) or [0] for t in texts]
    n = max(map(len, ids))
    bucket = next((b for b in EngineConfig(max_seq_len=max_seq_len).buckets() if n <= b),
                  max_seq_len)
    tokens = torch.zeros((len(ids), bucket), dtype=torch.long)
    for row, i in enumerate(ids):
        tokens[row, :len(i)] = torch.tensor(i)
    return tokens, torch.tensor([len(i) for i in ids])


def _embeddings_gate(label: str, run: dict, want) -> None:
    """A served part's /v1/embeddings vectors against world 1's on the same
    checkpoint and batch: within EMBED_ATOL, each cosine at least
    EMBED_MIN_COS."""
    import torch

    got = torch.tensor(run["embeddings"], dtype=torch.float32)
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"serve_sharded_cli {label}: /v1/embeddings {tuple(got.shape)}, not "
             f"{tuple(want.shape)}")
    err = float((got - want).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min())
    if err > EMBED_ATOL or cos < EMBED_MIN_COS:
        fail(f"serve_sharded_cli {label}: /v1/embeddings max |err| {err:.3e} (limit "
             f"{EMBED_ATOL}), least cosine {cos:.6f} (limit {EMBED_MIN_COS}) against world 1")
    print(f"serve_sharded_cli {label}: /v1/embeddings of {len(SHARDED_EMBED_TEXTS)} texts "
          f"through the lockstep op in {run['embed_s']:.3f} s (client clock), max |err| "
          f"{err:.3e} against world 1 (limit {EMBED_ATOL}), least cosine {cos:.6f} (limit "
          f"{EMBED_MIN_COS})", flush=True)


def _host_available() -> str:
    """The host's available memory (GiB, /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        kb = next(int(ln.split()[1]) for ln in f if ln.startswith("MemAvailable:"))
    return f"{kb / 2**20:.1f} GiB available on the host"


def gemma_world1(model_dir: str) -> dict:
    """World 1 for a gemma part: its checkpoint whole on the card, no mesh;
    the first prefill's logits (`_logits_batch`) in bf16 and the same
    prefill in f32 on the CPU, which the 2x2 ranks' logits are held to."""
    import torch

    from kubeai_tpu_torch.engine.weights import load_hf_config, load_params
    from kubeai_tpu_torch.models.registry import get_model_family

    requests = _request_specs(False)
    hf = load_hf_config(model_dir)
    family = get_model_family(hf["architectures"][0])
    cfg = family.config_from_hf(hf)
    params = load_params(family.name, model_dir, cfg, device="cuda")
    tokens, lengths = _logits_batch(requests)
    with torch.no_grad():
        logits = family.prefill(params, cfg, tokens.cuda(), lengths.cuda())[0].float().cpu()
    t0 = time.perf_counter()
    f32 = _f32_prefill_logits(family, params, cfg, requests)
    del params
    torch.cuda.empty_cache()
    print(f"serve_sharded_cli gemma world 1 ({hf['architectures'][0]}): the f32 reference "
          f"prefill on the CPU took {time.perf_counter() - t0:.2f} s (the weights' copy to "
          "the host included)", flush=True)
    return {"logits": logits, "f32_logits": f32}


def _gemma_launches(runs: dict) -> dict:
    """The gemma parts' kernel launches for the kernels line: every rank's
    count since its start (warm-up included), summed, under the
    head_dim-256 entries of KERNELS."""
    out: dict = {}
    for run in runs.values():
        for counts in _rank_fields(run["launches"], "rank").values():
            for name, n in json.loads(counts).items():
                key = f"{name}_d256"
                if key in KERNELS:
                    out[key] = out.get(key, 0) + n
    return out


def sharded_world1(model_dir: str, tmp: str) -> dict:
    """World 1 over NCCL in this process, graphs and overlap: the 8B
    checkpoint at SHARDED_LAYERS in per_layer and speculate=4, each with
    `mesh=build_mesh(MeshConfig())` beside the mesh-free engine (the
    served requests at once): every stream bit-equal, the first prefill's
    logits bit-equal, and each program's device ms from its graph against
    the mesh-free one's, with the kernels a replay adds (the collectives
    and their casts). Returns world 1's first prefill logits and the same
    prefill in f32 on the CPU, which the 2x2 ranks' logits are held to,
    and world 1's embeddings of SHARDED_EMBED_TEXTS, which part (b)'s
    served vectors are held to."""
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
    from kubeai_tpu_torch.engine.weights import load_hf_config, load_params
    from kubeai_tpu_torch.models.registry import get_model_family
    from kubeai_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    requests = _request_specs(False)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'rdv_world1')}",
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = build_mesh(MeshConfig())
        hf = load_hf_config(model_dir)
        family = get_model_family(hf["architectures"][0])
        cfg = family.config_from_hf(hf)
        params = load_params(family.name, model_dir, cfg, device="cuda")
        tokens, lengths = _embed_batch(SHARDED_EMBED_TEXTS, SHARDED_ENGINE["max_seq_len"])
        with torch.no_grad():
            ref = {"embeddings": family.hidden_states(params, cfg, tokens.cuda(),
                                                      lengths.cuda()).float().cpu()}
        for run in ("per_layer", "speculate"):
            extra, wrapper = SHARDED_REF_RUNS[run][:2]
            label = f"serve_sharded_cli world 1 {run}"
            engines, streams, launches = {}, {}, {}
            for name, m in (("mesh", mesh), ("plain", None)):
                eng = engines[name] = Engine(family, cfg, params, mesh=m,
                                             cfg=EngineConfig(**WORLD1_ENGINE, **extra))
                if eng._decode_program.graph is None:
                    fail(f"{label} {name}: no graph was captured")
                _zero_launches(eng)
                rids = [eng.add_request(p, SamplingParams(**sp)) for p, sp, _ in requests]
                got = {rid: [] for rid in rids}
                while eng.has_work():
                    for ev in eng.step():
                        got[ev.rid].append(ev.token)
                streams[name] = [got[rid] for rid in rids]
                launches[name] = {k: v for k, v in _launches(eng).items() if v}
                if not launches[name].get(wrapper):
                    fail(f"{label} {name}: {wrapper} did not launch ({launches[name]})")
            if streams["mesh"] != streams["plain"]:
                fail(f"{label}: the world-1 mesh engine's streams differ from the mesh-free "
                     "engine's")
            print(f"{label}: streams of the mesh and mesh-free engines bit-equal "
                  f"({sum(len(x) for x in streams['mesh'])} tokens); the mesh's launches "
                  f"{json.dumps(launches['mesh'])}", flush=True)
            if run == "per_layer":
                got = _prefill_logits(engines["mesh"], requests)
                if not torch.equal(got, _prefill_logits(engines["plain"], requests)):
                    fail(f"{label}: first prefill logits of world 1 differ from mesh-free")
                ref["logits"] = got
            unit = "verify window" if run == "speculate" else "decode step"
            program = "verify window" if run == "speculate" else "decode chunk"
            prof = {name: profile_program(eng, f"sharded world1 {name} {run} {unit}", program,
                                          eager=False)
                    for name, eng in engines.items()}
            rows = {}
            for name in ("mesh", "plain"):
                for e in prof[name]["rows"]:
                    rows.setdefault(e.key[:70], {})[name] = e.count / prof[name]["steps"]
            added = {k: round(v.get("mesh", 0) - v.get("plain", 0), 2)
                     for k, v in rows.items() if v.get("mesh", 0) != v.get("plain", 0)}
            m, p = prof["mesh"]["device_ms"], prof["plain"]["device_ms"]
            print(f"{label}: device {m:.4f} ms a {unit} with the mesh against {p:.4f} "
                  f"mesh-free (x{m / p:.4f}, +{m - p:.4f} ms); kernels a {unit} "
                  f"{prof['mesh']['kernels']:.1f} against {prof['plain']['kernels']:.1f}; "
                  f"added by the collectives: {json.dumps(added)}; card: {gpu_line()}",
                  flush=True)
            del engines, eng
            gc.collect()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref["f32_logits"] = _f32_prefill_logits(family, params, cfg, requests)
        print(f"serve_sharded_cli world 1: the f32 reference prefill on the CPU took "
              f"{time.perf_counter() - t0:.2f} s (the weights' copy to the host included)",
              flush=True)
        return ref
    finally:
        dist.destroy_process_group()


def serve_sharded_cli(empty_build: bool = False, gemma: bool = True) -> dict:
    """Phase 4g: sharded serving through the entry point.
    (a) `main --tpu-topology 1x1` (a world-1 mesh over NCCL, graphs) and
        `main` with no topology on the 8B width at SHARDED_LAYERS, both
        with the fused layout chosen by KUBEAI_TPU_DECODE_KERNEL (B4 must
        launch): every stream bit-equal, ready seconds and ms a served
        token of each.
    (b) `main --tpu-topology 2x2`: four ranks on the card over gloo (the 8B
        catalog entry's tp=4), default flags (--max-adapters 4): unary and
        streamed chat, an adapter loaded through the lockstep broadcast
        and a request that uses it, /v1/embeddings through the lockstep
        op (held to world 1's vectors), the resume refusal, SIGTERM.
        With `empty_build`, from a copy of the package whose
        kernel build directory is empty: exactly one rank runs nvcc while
        the others wait for its library.
    (c) `main --tpu-topology 1x2` on Mixtral-8x7B's width at
        MIXTRAL_CLI_LAYERS, its experts over the two ranks.
    (a), (b), (c) and the in-process engines of (b)'s and (c)'s
    configuration over the same ranks (`sharded_ref_rank`; at 2x2 also
    the fused layout and speculate=4), which gate them (`_sharded_gates`),
    all run at once once the checkpoints are written: the ms and seconds
    of each part are taken on a shared card and host. Then
    (e) with `gemma`, a second wave (GEMMA_SHARDED_PARTS): `main
        --tpu-topology 2x2` on Gemma-2-9B's width (per_layer; its
        reference ranks also fused) and on Gemma-7B's (--kv-dtype int8),
        each beside its in-process reference over the same ranks, then
        each checkpoint's world 1 on the card (`gemma_world1`) for the
        logits gate. Then
    (d) `sharded_world1`: world 1 over NCCL in this process, per_layer and
        speculate=4 in graphs, bit-equal to no mesh, the f32 CPU
        reference that the 2x2 ranks' first prefill logits are held to
        (`_logits_gate`), and world 1's embeddings that (b)'s are held
        to. Returns the gemma parts' launches for the kernels line."""
    import shutil
    import tempfile

    from kubeai_tpu_torch.engine.weights import save_safetensors
    from kubeai_tpu_torch.models import llama

    root = tempfile.mkdtemp(prefix="kubeai-sharded-")
    worlds, running = [], []
    try:
        t0 = time.perf_counter()
        dirs = {"llama": os.path.join(root, "llama"), "mixtral": os.path.join(root, "mixtral")}
        save_safetensors(dirs["llama"], cli_tensors(SHARDED_CONFIG), SHARDED_CONFIG)
        save_safetensors(dirs["mixtral"], mixtral_cli_tensors(), MIXTRAL_CLI_CONFIG)
        for label, config, leaves, *_ in GEMMA_SHARDED_PARTS if gemma else ():
            dirs[label] = os.path.join(root, label.replace(" ", "_"))
            save_safetensors(dirs[label], gemma_cli_tensors(config, leaves), config)
        adapter_dir = write_peft_adapter(os.path.join(root, "lora"),
                                         llama.LlamaConfig.from_hf_dict(SHARDED_CONFIG), 31)
        print(f"serve_sharded_cli: checkpoints written in {time.perf_counter() - t0:.2f} s "
              f"(8B width at {SHARDED_LAYERS} layers, "
              f"{os.path.getsize(os.path.join(dirs['llama'], 'model.safetensors')) / 1e9:.3f} "
              f"GB; Mixtral-8x7B width at {MIXTRAL_CLI_LAYERS} layers, "
              f"{os.path.getsize(os.path.join(dirs['mixtral'], 'model.safetensors')) / 1e9:.3f}"
              " GB" + "".join(
                  f"; {label} at {GEMMA_CLI_LAYERS} layers, "
                  f"{os.path.getsize(os.path.join(dirs[label], 'model.safetensors')) / 1e9:.3f} GB"
                  for label, *_ in GEMMA_SHARDED_PARTS if label in dirs) + ")", flush=True)
        print(f"serve_sharded_cli wave 1: {_host_available()}", flush=True)
        worlds = [
            _start_ref_world("2x2", dirs["llama"], 4, _request_specs(True), adapter_dir,
                             ("per_layer", "fused", "speculate"), root),
            _start_ref_world("mixtral 1x2", dirs["mixtral"], 2, _request_specs(False), None,
                             ("per_layer",), root),
        ]
        # (b) and (c) at once, beside (a) and the references.
        copy_root = None
        if empty_build:
            copy_root = os.path.join(root, "package-copy")
            shutil.copytree(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "kubeai_tpu_torch"),
                            os.path.join(copy_root, "kubeai_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
        results, errors = {}, []

        def part(label, flags, model, ranks, adapter, at):
            try:
                results[label] = sharded_cli_run(dirs[model], label, flags, ranks,
                                                 adapter_dir if adapter else None, at,
                                                 running=running, embeds=model == "llama")
            except SystemExit as e:  # fail() in this thread: raised again below
                errors.append(e)

        threads = [threading.Thread(target=part, args=(*SHARDED_PARTS[0], copy_root),
                                    daemon=True),
                   threading.Thread(target=part, args=(*SHARDED_PARTS[1], None), daemon=True)]
        for t in threads:
            t.start()
        # (a): world 1 against no mesh, in the fused layout an engine Pod
        # takes from its environment.
        fused = {"KUBEAI_TPU_DECODE_KERNEL": "fused"}
        plain = sharded_cli_run(dirs["llama"], "no topology", [], 1, env_extra=fused)
        world1 = sharded_cli_run(dirs["llama"], "1x1", ["--tpu-topology", "1x1"], 1,
                                 env_extra=fused)
        if world1["tokens"] != plain["tokens"]:
            fail(f"serve_sharded_cli 1x1: streams {world1['tokens']} differ from no "
                 f"topology's {plain['tokens']}")
        if world1["state"].get("parallel", {}).get("backend") != "nccl":
            fail(f"serve_sharded_cli 1x1: /v1/state.parallel {world1['state'].get('parallel')}")
        for name, run in (("no topology", plain), ("1x1", world1)):
            launches = json.loads(_rank_fields(run["launches"], "rank")[0])
            if not launches.get("paged_decode_attention_fused"):
                fail(f"serve_sharded_cli {name}: KUBEAI_TPU_DECODE_KERNEL=fused launched no "
                     f"B4: {launches}")
            print(f"serve_sharded_cli {name} (fused from the environment): {run['reports']} "
                  f"{run['before_load']}; ready "
                  f"{run['ready_s']:.2f} s, {run['ms_per_token']:.3f} ms a served token over "
                  f"{run['served_tokens']} tokens one request at a time (client clock, beside "
                  f"the other parts); launches since start {json.dumps(launches)}; "
                  f"{run['cold'][-1:]}; card: {gpu_line()}", flush=True)
        print(f"serve_sharded_cli 1x1: the world-1 mesh's streams bit-equal to no "
              f"topology's; ms a served token x"
              f"{world1['ms_per_token'] / plain['ms_per_token']:.4f}", flush=True)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for label, *_ in SHARDED_PARTS:
            if label not in results:
                fail(f"serve_sharded_cli {label}: the part did not finish")
        refs = _finish_worlds(worlds)
        gemma_refs, gemma_world1s = [], {}
        if gemma:
            # (e): the gemma parts and their references, a wave of their own.
            print(f"serve_sharded_cli wave 2 (gemma): {_host_available()}", flush=True)
            t_wave = time.perf_counter()
            gemma_worlds = [
                _start_ref_world(label, dirs[label], 4, _request_specs(False), None, runs, root)
                for label, _, _, _, runs, *_ in GEMMA_SHARDED_PARTS]
            worlds += gemma_worlds
            threads = [threading.Thread(target=part, args=(label, flags, label, 4, False, None),
                                        daemon=True)
                       for label, _, _, flags, *_ in GEMMA_SHARDED_PARTS]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
            gemma_refs = _finish_worlds(gemma_worlds)
            print(f"serve_sharded_cli wave 2 (gemma): {time.perf_counter() - t_wave:.2f} s",
                  flush=True)
            for label, *_ in GEMMA_SHARDED_PARTS:
                gemma_world1s[label] = timed(f"serve_sharded_cli {label} world 1", gemma_world1,
                                             dirs[label])
        # (d): world 1 over NCCL in this process, once the card is free.
        world1 = timed("serve_sharded_cli world 1", sharded_world1, dirs["llama"], root)
        b = results["2x2"]
        if empty_build:
            builders = [ln for ln in b["build"] if "with nvcc" in ln]
            if len(builders) != 1:
                fail(f"serve_sharded_cli 2x2: {len(builders)} ranks built the kernels: "
                     f"{b['build']}")
            print("serve_sharded_cli 2x2 from an empty build directory: " + " | ".join(
                ln.split("kernel library: ")[-1] for ln in b["build"]), flush=True)
        _sharded_gates("2x2", b, 4, refs[0], (8, 2))
        _logits_gate("2x2", worlds[0]["out"], 4, world1)
        _embeddings_gate("2x2", b, world1["embeddings"])
        _sharded_gates("mixtral 1x2", results["mixtral 1x2"], 2, refs[1], (16, 4))
        for (label, _, _, _, _, served, heads, head_dim), ref, w in zip(
                GEMMA_SHARDED_PARTS, gemma_refs, worlds[2:]):
            _sharded_gates(label, results[label], 4, ref, heads, head_dim, served)
            _logits_gate(label, w["out"], 4, gemma_world1s[label])
        for label, *_ in SHARDED_PARTS + (GEMMA_SHARDED_PARTS if gemma else ()):
            run = results[label]
            print(f"serve_sharded_cli {label}: ready {run['ready_s']:.2f} s, "
                  f"{run['ms_per_token']:.3f} ms a served token (time-sliced gloo ranks on "
                  f"one card, not a speed); refusals {json.dumps(run['refusals'])}; "
                  f"{run['cold'][-1:]}; card: {gpu_line()}", flush=True)
        return _gemma_launches({label: results[label] for label, *_ in GEMMA_SHARDED_PARTS
                                if label in results})
    finally:
        _kill_worlds(worlds + [{"procs": running}])
        shutil.rmtree(root, ignore_errors=True)


def report_nccl_one_card() -> None:
    """Two NCCL ranks on the one card: the error NCCL gives (not part of
    the smoke)."""
    import tempfile

    code = ("import datetime, sys, torch, torch.distributed as dist; torch.cuda.set_device(0); "
            "dist.init_process_group('nccl', init_method='file://' + sys.argv[1], "
            "rank=int(sys.argv[2]), world_size=2, timeout=datetime.timedelta(seconds=60)); "
            "x = torch.ones(4, device='cuda'); dist.all_reduce(x); torch.cuda.synchronize(); "
            "print('all_reduce', x.tolist())")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(["timeout", "-k", "5", "120", sys.executable, "-c", code,
                                   os.path.join(tmp, "rdv"), str(r)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=150)
            said = [ln for ln in out.splitlines() if "NCCL" in ln or "all_reduce" in ln
                    or "Duplicate" in ln]
            print(f"nccl two ranks on one card: rank {r} exit {p.returncode}: "
                  + " | ".join(said[-4:]), flush=True)


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
    import faulthandler

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on the card")
    # A stalled run ends here, before its time limit, with every thread's
    # stack on stderr.
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True, file=sys.stderr)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_all = time.perf_counter()
    timed("build", phase_build)
    measured = timed("kernels", phase_kernels)
    timed("model", phase_model)
    launches = timed("serve", phase_serve)
    launches.update(timed("serve_gemma", serve_gemma, dict(GEMMA_9B, num_layers=GEMMA_9B_LAYERS),
                          f"Gemma-2-9B ({GEMMA_9B_LAYERS} of 42 layers)"))
    launches.update(timed("serve_gemma1", serve_gemma, dict(GEMMA_7B, num_layers=GEMMA_7B_LAYERS),
                          f"Gemma-7B ({GEMMA_7B_LAYERS} of 28 layers)", "gemma1"))
    mixtral_launches = timed("serve_mixtral", serve_mixtral)
    print(f"serve_mixtral launches by kernel: {json.dumps(mixtral_launches)}", flush=True)
    for name, n in timed("serve_sharded_cli", serve_sharded_cli).items():
        launches[name] = launches.get(name, 0) + n
    launches.update(timed("serve_embed", serve_embed))
    timed("serve_whisper", serve_whisper)
    timed("serve_cli", serve_cli)
    timed("serve_cli_gemma", serve_cli_gemma)
    timed("serve_cli_gemma int8", serve_cli_gemma, GEMMA_CLI_CONFIG, GEMMA_CLI_LAYER_LEAVES,
          "gemma int8", "Gemma-2-9B", True)
    timed("serve_cli_gemma1", serve_cli_gemma, GEMMA1_CLI_CONFIG, GEMMA1_CLI_LAYER_LEAVES,
          "gemma1", "Gemma-7B")
    timed("serve_cli_mixtral", serve_cli_mixtral)
    print(f"phases: {time.perf_counter() - t_all:.2f} s in all", flush=True)
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
