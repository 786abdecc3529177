"""Speech-to-text serving front (the SpeechToText feature).
Counterpart of kubeai_tpu/engine/whisper_server.py.

OpenAI-compatible `POST /v1/audio/transcriptions` (a multipart/form-data
upload with a `file` field holding WAV bytes) answered with
`{"text": ...}`, plus `/health`, `/v1/models` and `/metrics`
(`kubeai_engine_requests_total`, `kubeai_engine_audio_seconds_total`).
One transcription runs at a time per replica, on the device the
parameters live on (the card unless the entry point was given
`--device cpu`). Without a tokenizer the text is the token ids, space
separated, as in the JAX server.

Run: python -m kubeai_tpu_torch.engine.server --model-url <whisper dir>
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler

from kubeai_tpu_torch.engine.server import _HTTPServer
from kubeai_tpu_torch.metrics.registry import Counter, Registry
from kubeai_tpu_torch.models import whisper

logger = logging.getLogger(__name__)

_BOUNDARY_RE = re.compile(r'boundary="?([^";]+)"?')


def parse_multipart(body: bytes, content_type: str) -> dict[str, bytes]:
    """The fields of a multipart/form-data body, by name."""
    m = _BOUNDARY_RE.search(content_type)
    if not m:
        raise ValueError("missing multipart boundary")
    boundary = b"--" + m.group(1).encode()
    fields: dict[str, bytes] = {}
    for part in body.split(boundary):
        if b"\r\n\r\n" not in part:
            continue
        headers, payload = part.split(b"\r\n\r\n", 1)
        name_m = re.search(rb'name="([^"]+)"', headers)
        if not name_m:
            continue
        fields[name_m.group(1).decode()] = payload.rstrip(b"\r\n-")
    return fields


class TranscriptionServer:
    def __init__(
        self,
        params: dict,
        cfg: whisper.WhisperConfig,
        served_model_name: str,
        tokenizer=None,  # the port's Tokenizer for the text; None = ids as text
        host: str = "0.0.0.0",
        port: int = 8000,
    ):
        self.params = params
        self.cfg = cfg
        self.served_model_name = served_model_name
        self.tokenizer = tokenizer
        self.registry = Registry()
        self.requests_total = Counter(
            "kubeai_engine_requests_total", "Requests served.", self.registry
        )
        self.audio_seconds = Counter(
            "kubeai_engine_audio_seconds_total",
            "Seconds of audio transcribed.",
            self.registry,
        )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status, payload):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/health":
                    return self._json(200, {"status": "ok"})
                if path == "/metrics":
                    body = outer.registry.expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/v1/models":
                    return self._json(200, {"object": "list", "data": [{
                        "id": outer.served_model_name,
                        "object": "model",
                        "owned_by": "kubeai-tpu",
                    }]})
                self._json(404, {"error": {"message": "not found"}})

            def do_POST(self):
                path = self.path.split("?")[0]
                if path != "/v1/audio/transcriptions":
                    return self._json(404, {"error": {"message": "not found"}})
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(n) if n else b""
                try:
                    fields = parse_multipart(body, self.headers.get("Content-Type", ""))
                except ValueError as e:
                    return self._json(400, {"error": {"message": str(e)}})
                if "file" not in fields:
                    return self._json(
                        400, {"error": {"message": "missing 'file' form field"}}
                    )
                try:
                    text = outer.transcribe(fields["file"])
                except Exception as e:
                    logger.exception("transcription failed")
                    return self._json(400, {"error": {"message": str(e)}})
                self._json(200, {"text": text})

        self.httpd = _HTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # shutdown() handshakes with serve_forever; on a never-started
        # server it would wait forever.
        if self._thread is not None and self._thread.is_alive():
            self.httpd.shutdown()
        self.httpd.server_close()

    def transcribe(self, wav_bytes: bytes) -> str:
        pcm = whisper.decode_wav(wav_bytes)
        self.requests_total.inc(model=self.served_model_name)
        self.audio_seconds.inc(len(pcm) / whisper.SAMPLE_RATE)
        mel = whisper.log_mel_spectrogram(
            pcm, n_mels=self.cfg.num_mel_bins, max_frames=2 * self.cfg.max_source_positions
        )
        with self._lock:  # one transcription at a time per replica
            ids = whisper.transcribe_tokens(self.params, self.cfg, mel)
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return " ".join(str(i) for i in ids)
