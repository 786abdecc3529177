"""Fake GCS and S3 servers on 127.0.0.1 for the object-store tests of
kubeai_tpu_torch (tests/test_torch_objstore.py, test_torch_coldstart.py
and the refusal cases turned into parity cases).

Each serves the subset of its store's REST surface that the clients of
both packages speak: listing, whole and ranged downloads (200 or 206),
and uploads. Every request is logged as (method, path with query,
sorted headers), so a test can hold the port's requests to the JAX
package's. `cut_next[name] = n` sends the next download of `name` with
its full Content-Length but only `n` bytes, then closes the connection:
a mid-stream cut that the clients resume with Range."""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _byte_range(header: str | None, size: int) -> tuple[int, int] | None:
    """'bytes=a-' or 'bytes=a-b' -> inclusive (a, b) clamped to size."""
    if not header:
        return None
    start, _, end = header.removeprefix("bytes=").partition("-")
    return int(start), min(int(end), size - 1) if end else size - 1


class _FakeStore:
    """The shared part: objects, the request log, the server thread."""

    def __init__(self):
        self.objects: dict[tuple[str, str], bytes] = {}
        self.log: list[tuple] = []
        self.cut_next: dict[str, int] = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _record(self):
                outer.log.append((self.command, self.path, tuple(sorted(
                    (k.lower(), v) for k, v in self.headers.items()))))

            def send(self, status, body=b"", ctype="application/json"):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def send_object(self, name: str, data: bytes | None):
                if data is None:
                    return self.send(404, b"{}")
                rng = _byte_range(self.headers.get("Range"), len(data))
                body = data if rng is None else data[rng[0]:rng[1] + 1]
                self.send_response(200 if rng is None else 206)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                if rng is not None:
                    self.send_header("Content-Range",
                                     f"bytes {rng[0]}-{rng[1]}/{len(data)}")
                self.end_headers()
                cut = outer.cut_next.pop(name, None)
                if cut is not None:
                    self.wfile.write(body[:cut])
                    self.wfile.flush()
                    self.close_connection = True
                    return
                self.wfile.write(body)

            def body(self) -> bytes:
                return self.rfile.read(int(self.headers.get("Content-Length", 0)))

            def do_GET(self):
                self._record()
                outer.get(self)

            def do_POST(self):
                self._record()
                outer.post(self)

            def do_PUT(self):
                self._record()
                outer.put(self)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def listed(self, bucket: str, prefix: str) -> list[tuple[str, bytes]]:
        return [(n, d) for (b, n), d in sorted(self.objects.items())
                if b == bucket and n.startswith(prefix)]

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=10)

    def post(self, h):
        h.send(404, b"{}")

    def put(self, h):
        h.send(404, b"{}")


class FakeGCS(_FakeStore):
    """GCS JSON API: list, alt=media download (Range), media upload."""

    def get(self, h):
        parsed = urllib.parse.urlparse(h.path)
        parts = parsed.path.split("/")
        if parsed.path.startswith("/download/storage/v1/b/"):
            name = urllib.parse.unquote(parts[7])
            return h.send_object(name, self.objects.get((parts[5], name)))
        if parsed.path.startswith("/storage/v1/b/"):
            prefix = urllib.parse.parse_qs(parsed.query).get("prefix", [""])[0]
            items = [{"name": n, "size": str(len(d))}
                     for n, d in self.listed(parts[4], prefix)]
            return h.send(200, json.dumps({"items": items}).encode())
        h.send(404, b"{}")

    def post(self, h):
        parsed = urllib.parse.urlparse(h.path)
        if not parsed.path.startswith("/upload/storage/v1/b/"):
            return h.send(404, b"{}")
        name = urllib.parse.parse_qs(parsed.query)["name"][0]
        self.objects[(parsed.path.split("/")[5], name)] = h.body()
        h.send(200, b"{}")


class FakeS3(_FakeStore):
    """S3 REST (path-style): ListObjectsV2, GET (Range) and PUT objects.
    Signatures are logged, not checked."""

    def get(self, h):
        parsed = urllib.parse.urlparse(h.path)
        bucket, _, key = parsed.path.lstrip("/").partition("/")
        q = urllib.parse.parse_qs(parsed.query)
        if "list-type" in q:
            contents = "".join(
                f"<Contents><Key>{n}</Key><Size>{len(d)}</Size></Contents>"
                for n, d in self.listed(bucket, q.get("prefix", [""])[0]))
            return h.send(200, (
                '<ListBucketResult xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                f"<IsTruncated>false</IsTruncated>{contents}</ListBucketResult>"
            ).encode(), "application/xml")
        key = urllib.parse.unquote(key)
        h.send_object(key, self.objects.get((bucket, key)))

    def put(self, h):
        bucket, _, key = urllib.parse.urlparse(h.path).path.lstrip("/").partition("/")
        self.objects[(bucket, urllib.parse.unquote(key))] = h.body()
        h.send(200, b"")
