"""OpenAI-compatible HTTP server over the engine.
Counterpart of kubeai_tpu/engine/server.py (`EngineServer`), reduced to
the serving path: GET /health and /v1/models; POST /v1/completions and
/v1/chat/completions, unary and SSE. Response bodies have the JAX
server's shape.

One serve-loop thread steps the engine and fans StepEvents out to
per-request queues; HTTP handler threads tokenize, queue the request
(with the scheduling headers X-Priority / X-Deadline-Ms / X-Client-Id)
and detokenize incrementally, applying stop strings.

Not ported yet: metrics, tracing, tenancy, drain and watchdog,
disaggregated prefill/decode, KV sharing, adapters, embeddings and the
command-line entry point.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from kubeai_tpu_torch.engine.engine import Engine, EngineDraining
from kubeai_tpu_torch.engine.sampling import SamplingParams
from kubeai_tpu_torch.engine.tokenizer import Tokenizer
from kubeai_tpu_torch.scheduling.scheduler import (
    PRIORITY_CLASSES,
    DeadlineInfeasible,
)

logger = logging.getLogger(__name__)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 1024


def _retry_after_header(seconds: float) -> str:
    return str(max(1, int(math.ceil(seconds))))


class EngineServer:
    def __init__(
        self,
        engine: Engine,
        tokenizer: Tokenizer,
        served_model_name: str,
        host: str = "127.0.0.1",
        port: int = 0,
        max_queue: int = 256,
        request_timeout: float = 600.0,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.served_model_name = served_model_name
        self.max_queue = max_queue
        self.request_timeout = request_timeout
        self._subscribers: dict[int, queue.Queue] = {}
        self._sub_lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()
        self._loop_error: BaseException | None = None
        self._loop_thread = threading.Thread(target=self._serve_loop, daemon=True)

        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status: int, payload: dict, headers: dict | None = None):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/health":
                    if outer.healthy():
                        return self._json(200, {"status": "ok"})
                    return self._json(503, {"status": "unhealthy"})
                if path == "/v1/models":
                    data = [{
                        "id": outer.served_model_name,
                        "object": "model",
                        "owned_by": "kubeai-tpu",
                    }]
                    return self._json(200, {"object": "list", "data": data})
                return self._json(404, {"error": {"message": "not found"}})

            def do_POST(self):
                path = self.path.split("?")[0]
                n = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(n) if n else b""
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError as e:
                    return self._json(400, {"error": {"message": f"bad JSON: {e}"}})
                try:
                    if path == "/v1/chat/completions":
                        return outer._handle_generate(self, body, chat=True)
                    if path == "/v1/completions":
                        return outer._handle_generate(self, body, chat=False)
                    return self._json(404, {"error": {"message": "not found"}})
                except BrokenPipeError:
                    raise
                except Exception as e:
                    logger.exception("handler error")
                    return self._json(500, {"error": {"message": str(e)}})

        self.httpd = _HTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    # -- lifecycle ------------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def healthy(self) -> bool:
        return self._loop_thread.is_alive() and self._loop_error is None

    def start(self) -> None:
        self._loop_thread.start()
        self._http_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._work.set()
        if self._loop_thread.is_alive():
            self._loop_thread.join(timeout=30)
        if self._http_thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()

    # -- engine loop ----------------------------------------------------------

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if not self.engine.has_work():
                    self._work.wait(timeout=0.01)
                    self._work.clear()
                    continue
                for ev in self.engine.step():
                    with self._sub_lock:
                        q = self._subscribers.get(ev.rid)
                    if q is not None:
                        q.put(ev)
            except Exception as e:
                # A dead serving loop flips /health; waiting requests run
                # into their timeout.
                logger.exception("serving loop crashed")
                self._loop_error = e
                return

    # -- request handling -----------------------------------------------------

    def _parse_scheduling(self, headers):
        """(priority, deadline_ms, client) from the request headers; None
        leaves the scheduler's default. Raises ValueError on malformed
        values."""
        raw_prio = (headers.get("X-Priority") or "").strip().lower()
        if raw_prio and raw_prio not in PRIORITY_CLASSES:
            raise ValueError(
                f"X-Priority must be one of {'/'.join(PRIORITY_CLASSES)}, "
                f"got {raw_prio!r}"
            )
        priority = raw_prio or None
        deadline_ms = None
        raw_ddl = (headers.get("X-Deadline-Ms") or "").strip()
        if raw_ddl:
            try:
                deadline_ms = float(raw_ddl)
            except ValueError:
                raise ValueError(
                    f"X-Deadline-Ms must be a number of milliseconds, "
                    f"got {raw_ddl!r}"
                )
            if deadline_ms <= 0:
                raise ValueError("X-Deadline-Ms must be > 0")
        client = (headers.get("X-Client-Id") or "").strip()
        return priority, deadline_ms, client

    def _shed_response(self, http, message: str, retry_after: float | None = None):
        """429 with a Retry-After computed by the scheduler and per-class
        queue depths in the body."""
        sched = self.engine.scheduler
        if retry_after is None:
            retry_after = sched.retry_after()
        return http._json(
            429,
            {
                "error": {"message": message},
                "queue": {
                    "depths": sched.class_depths(),
                    "retry_after_s": round(retry_after, 3),
                },
            },
            headers={"Retry-After": _retry_after_header(retry_after)},
        )

    def _cancel_all(self, reqs) -> None:
        for rid_i, _, _ in reqs:
            self.engine.cancel(rid_i)
            with self._sub_lock:
                self._subscribers.pop(rid_i, None)

    def _handle_generate(self, http, body: dict, chat: bool):
        model_field = str(body.get("model") or self.served_model_name)
        if model_field != self.served_model_name:
            return http._json(
                404, {"error": {"message": f"model {model_field!r} not found"}}
            )
        display = self.served_model_name
        raw_n = body.get("n")
        if raw_n is None:
            n = 1
        elif isinstance(raw_n, bool) or not isinstance(raw_n, int):
            n = 0  # falls through to the 400 below
        else:
            n = raw_n
        if not 1 <= n <= 8:
            return http._json(
                400, {"error": {"message": "n must be an integer in 1..8"}}
            )
        try:
            priority, deadline_ms, sched_client = self._parse_scheduling(
                http.headers
            )
        except ValueError as e:
            return http._json(400, {"error": {"message": str(e)}})
        if self.engine.num_pending + n > self.max_queue:
            return self._shed_response(http, "engine queue full, retry later")

        if chat:
            messages = body.get("messages") or []
            prompt_ids = self.tokenizer.apply_chat_template(messages)
        else:
            prompt = body.get("prompt", "")
            if isinstance(prompt, list):
                prompt = prompt[0] if prompt else ""
            prompt_ids = self.tokenizer.encode(str(prompt))
        if not prompt_ids:
            prompt_ids = [0]

        room = self.engine.cfg.max_seq_len - len(prompt_ids) - 1
        if room <= 0:
            return http._json(
                400,
                {"error": {"message": (
                    f"prompt too long: {len(prompt_ids)} tokens "
                    f">= context {self.engine.cfg.max_seq_len}"
                )}},
            )
        try:
            sp = self._parse_sampling(body, room)
        except ValueError as e:
            return http._json(400, {"error": {"message": str(e)}})
        stream = bool(body.get("stream", False))
        # Each choice gets a derived seed so explicit-seed requests stay
        # deterministic and diverse.
        reqs: list[tuple[int, queue.Queue, SamplingParams]] = []
        try:
            for i in range(n):
                sub_i: queue.Queue = queue.Queue()
                sp_i = (
                    sp if i == 0 or sp.seed is None
                    else dataclasses.replace(sp, seed=sp.seed + i)
                )

                def register(rid: int, _sub=sub_i) -> None:
                    # Runs under the engine lock, before the request is
                    # visible to step(): no event can be emitted
                    # unsubscribed.
                    with self._sub_lock:
                        self._subscribers[rid] = _sub

                rid_i = self.engine.add_request(
                    prompt_ids, sp_i, on_admit=register, priority=priority,
                    client=sched_client, deadline_ms=deadline_ms,
                )
                reqs.append((rid_i, sub_i, sp_i))
        except DeadlineInfeasible as e:
            self._cancel_all(reqs)
            return self._shed_response(http, str(e), retry_after=e.retry_after)
        except EngineDraining:
            self._cancel_all(reqs)
            return http._json(
                503, {"error": {"message": "server is draining, retry elsewhere"}}
            )
        except ValueError as e:
            self._cancel_all(reqs)
            return http._json(400, {"error": {"message": str(e)}})
        self._work.set()
        try:
            if stream:
                self._stream_response(http, reqs, display, chat)
            else:
                self._unary_response(http, reqs, display, chat, len(prompt_ids))
        finally:
            # Client gone or handler done: release the slots of any
            # request still decoding (no-op after normal completion).
            self._cancel_all(reqs)

    @staticmethod
    def _parse_sampling(body: dict, room: int) -> SamplingParams:
        """Validate OpenAI sampling fields; raises ValueError with a
        client-readable message on malformed input."""

        def _number(key, default, *, lo=None, hi=None, integer=False):
            raw = body.get(key)
            if raw is None:
                return default
            if isinstance(raw, bool) or not isinstance(raw, (int, float)):
                raise ValueError(f"{key} must be a number, got {raw!r}")
            if integer and not isinstance(raw, int):
                raise ValueError(f"{key} must be an integer, got {raw!r}")
            if lo is not None and raw < lo:
                raise ValueError(f"{key} must be >= {lo}, got {raw}")
            if hi is not None and raw > hi:
                raise ValueError(f"{key} must be <= {hi}, got {raw}")
            return raw

        max_tokens = body.get("max_tokens")
        if max_tokens is None:
            max_tokens = body.get("max_completion_tokens")
        if max_tokens is None:
            max_tokens = 128
        elif isinstance(max_tokens, bool) or not isinstance(max_tokens, int):
            raise ValueError(
                f"max_tokens must be a positive integer, got {max_tokens!r}"
            )
        elif max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        temperature = float(_number("temperature", 1.0, lo=0.0))
        top_p = float(_number("top_p", 1.0, hi=1.0))
        if top_p <= 0.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        top_k = int(_number("top_k", 0, lo=0, integer=True))
        return SamplingParams(
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            max_tokens=min(max_tokens, room),
            seed=body.get("seed"),
            stop=tuple(
                [body["stop"]] if isinstance(body.get("stop"), str)
                else body.get("stop") or []
            ),
        )

    def _collect(self, rid, sub, sp, on_delta=None, deadline=None):
        """Drain tokens; detokenize incrementally; apply stop strings.
        Returns (text, finish_reason, tokens). on_delta gets (delta_text,
        new_tokens) for each piece of text that is safe to send."""
        tokens: list[int] = []
        sent_tokens = 0
        emitted_len = 0
        finish = "length"
        if deadline is None:
            deadline = time.monotonic() + self.request_timeout
        while True:
            try:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise queue.Empty
                ev = sub.get(timeout=remaining)
            except queue.Empty:
                # Stalled engine or abandoned stream: stop decoding now.
                self.engine.cancel(rid)
                finish = "timeout"
                break
            tokens.append(ev.token)
            text = self.tokenizer.decode(tokens)
            stop_hit = None
            for s in sp.stop:
                idx = text.find(s, max(0, emitted_len - len(s)))
                if idx != -1:
                    stop_hit = idx
                    break
            if stop_hit is not None:
                if on_delta and stop_hit > emitted_len:
                    on_delta(text[emitted_len:stop_hit], tokens[sent_tokens:])
                self.engine.cancel(rid)
                return text[:stop_hit], "stop", tokens
            if on_delta and len(text) > emitted_len:
                # Hold back a partial UTF-8 replacement char at the tail.
                safe = text[:-1] if text.endswith("�") else text
                if len(safe) > emitted_len:
                    on_delta(safe[emitted_len:], tokens[sent_tokens:])
                    sent_tokens = len(tokens)
                    emitted_len = len(safe)
            if ev.finished:
                finish = ev.finish_reason or "stop"
                break
        text = self.tokenizer.decode(tokens)
        if on_delta and len(text) > emitted_len:
            on_delta(text[emitted_len:], tokens[sent_tokens:])
        return text, finish, tokens

    def _unary_response(self, http, reqs, display, chat, n_prompt):
        choices = []
        total_completion = 0
        any_timeout = False
        deadline = time.monotonic() + self.request_timeout
        for i, (rid, sub, sp_i) in enumerate(reqs):
            text, finish, tokens = self._collect(
                rid, sub, sp_i, deadline=deadline
            )
            completion_tokens = len(tokens)
            if finish == "timeout":
                any_timeout = True
                finish = "length"  # partial result; valid OpenAI value
            total_completion += completion_tokens
            if chat:
                choices.append({
                    "index": i,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": finish,
                })
            else:
                choices.append({"index": i, "text": text, "finish_reason": finish})
        if any_timeout and total_completion == 0:
            ra = self.engine.scheduler.retry_after()
            return http._json(
                503,
                {"error": {"message": "engine produced no tokens within "
                           f"{self.request_timeout}s"}},
                headers={"Retry-After": _retry_after_header(ra)},
            )
        payload = {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion" if chat else "text_completion",
            "created": int(time.time()),
            "model": display,
            "choices": choices,
            "usage": {
                "prompt_tokens": n_prompt,
                "completion_tokens": total_completion,
                "total_tokens": n_prompt + total_completion,
            },
        }
        http._json(200, payload)

    def _stream_response(self, http, reqs, display, chat):
        """SSE stream; with n > 1 the choices stream one after another in
        index order. Every content chunk carries `token_ids`, the raw
        tokens behind its delta; the final chunk of a choice carries only
        its finish_reason."""
        http.send_response(200)
        http.send_header("Content-Type", "text/event-stream")
        http.send_header("Cache-Control", "no-cache")
        http.send_header("Transfer-Encoding", "chunked")
        http.end_headers()
        rid_s = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        def send_chunk(obj: dict):
            data = f"data: {json.dumps(obj)}\n\n".encode()
            http.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            http.wfile.flush()

        def send_choice(choice: dict, token_ids=()):
            send_chunk({
                "id": rid_s,
                "object": "chat.completion.chunk" if chat else "text_completion",
                "created": created,
                "model": display,
                "choices": [choice],
                **({"token_ids": [int(t) for t in token_ids]} if token_ids else {}),
            })

        deadline = time.monotonic() + self.request_timeout
        for i, (rid, sub, sp_i) in enumerate(reqs):

            def on_delta(delta_text: str, new_tokens=(), _i=i):
                if chat:
                    send_choice(
                        {"index": _i, "delta": {"content": delta_text},
                         "finish_reason": None},
                        token_ids=new_tokens,
                    )
                else:
                    send_choice(
                        {"index": _i, "text": delta_text, "finish_reason": None},
                        token_ids=new_tokens,
                    )

            _text, finish, _tokens = self._collect(
                rid, sub, sp_i, on_delta=on_delta, deadline=deadline
            )
            if finish == "timeout":
                finish = "length"
            send_choice(
                {"index": i, "delta": {}, "finish_reason": finish}
                if chat
                else {"index": i, "text": "", "finish_reason": finish}
            )
        done = b"data: [DONE]\n\n"
        http.wfile.write(f"{len(done):x}\r\n".encode() + done + b"\r\n")
        http.wfile.write(b"0\r\n\r\n")
        http.wfile.flush()
