"""Zero-dependency object-store clients: GCS (JSON API) and S3 (SigV4).
Counterpart of kubeai_tpu/objstore.py, of which this is a copy: the port
imports nothing of the JAX package, and the two issue the same requests
(methods, paths, query strings and headers), so a bucket written by
either package reads the same from the other. Only the buffering
differs: ranged reads land in one buffer and uploads go out in 1 MiB
blocks (`_read_exact`, `SEND_BLOCK`).

The stores are spoken natively, with the standard library only:

  gs://bucket/prefix   — GCS JSON API over HTTPS. Auth from the GKE
      metadata server when available, anonymous otherwise.
      STORAGE_EMULATOR_HOST / endpoint override points at the
      fake-gcs-server surface used in tests.
  s3://bucket/prefix   — S3 REST with AWS Signature V4 (hand-rolled:
      hmac+sha256 only). Credentials from AWS_ACCESS_KEY_ID/
      AWS_SECRET_ACCESS_KEY; unsigned requests when absent (test fakes,
      public buckets). AWS_ENDPOINT_URL overrides for MinIO-style fakes.
  oss://bucket/prefix  — Alibaba OSS through its S3-compatible surface:
      the S3 client with OSS_ENDPOINT (+ OSS_ACCESS_KEY_ID/SECRET).

  file://dir/prefix    — a plain directory behind the same client
      interface (PVC-mounted snapshot volumes, tests, runs with no
      bucket in reach).

Streaming discipline: downloads go object→file in fixed-size chunks
(never whole-object in memory), one object at a time — the weight
loader's shard-at-a-time path builds on this. Every wire operation
retries transient failures (5xx/429, connection resets, short reads)
with capped exponential backoff + jitter; an interrupted download
RESUMES from the bytes already on disk via a Range request instead of
restarting. Retries are counted in `RETRIES` and exported as
`kubeai_objstore_retries_total`.

Users: `engine/weights.py::resolve_model_dir` (--model-url, --draft-url
and adapters' lora_url), `engine/coldstart.py` (`SnapshotStore`) and the
server's KV spill (`KVSpillStore`, --kv-spill-url).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import json
import logging
import os
import random
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET

logger = logging.getLogger(__name__)

CHUNK = 1 << 20  # 1 MiB copy chunks


class ObjStoreError(RuntimeError):
    pass


class TransientStoreError(ObjStoreError):
    """A store response worth retrying (5xx, 429): the bytes may well
    arrive on the next attempt. Non-transient 4xx stay plain
    `ObjStoreError` and fail immediately."""


class SnapshotMismatch(ObjStoreError):
    """A snapshot manifest whose fingerprint does not match the booting
    engine's — serving from it could silently run a stale layout, so
    callers MUST fall back to the full load path."""


# -- transient-failure retry discipline ---------------------------------------
#
# One flaky read used to fail the whole operation (a multi-GB weight
# download restarted from byte 0 on a connection reset). Every request
# now runs under `with_retries`: capped exponential backoff with full
# jitter, counted in RETRIES (scraped into kubeai_objstore_retries_total
# at collect time by the instrument bundles).

RETRIES = {"total": 0.0}  # read by metrics.registry.ObjstoreRetries

RETRY_ATTEMPTS = int(os.environ.get("KUBEAI_OBJSTORE_RETRIES", "4"))
RETRY_BASE_S = 0.2
RETRY_CAP_S = 8.0

# Module-level so tests (and latency-sensitive embedders) can replace
# the sleeper without threading a parameter through every client call.
RETRY_SLEEP = time.sleep


def _is_transient(exc: BaseException) -> bool:
    """Worth retrying: our own transient marker, connection-layer
    failures (reset/aborted/refused mid-pool, broken pipe), timeouts,
    and short reads (`IncompleteRead`, `RemoteDisconnected`)."""
    return isinstance(
        exc,
        (
            TransientStoreError,
            ConnectionError,
            TimeoutError,
            http.client.IncompleteRead,
            http.client.BadStatusLine,
        ),
    )


def with_retries(desc: str, fn, *, attempts: int | None = None,
                 sleep=None, rng=None):
    """Run `fn()` retrying transient failures up to `attempts` extra
    times with capped exponential backoff + full jitter. `fn` must be
    safe to re-run whole (each client attempt opens a fresh
    connection); download resume is handled inside `get_to_file`, not
    here."""
    attempts = RETRY_ATTEMPTS if attempts is None else attempts
    sleep = sleep if sleep is not None else RETRY_SLEEP
    rng = rng if rng is not None else random.random
    for i in range(attempts + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — filtered below
            if not _is_transient(e) or i >= attempts:
                raise
            RETRIES["total"] += 1
            delay = min(RETRY_CAP_S, RETRY_BASE_S * (2 ** i)) * (
                0.5 + rng()
            )
            logger.warning(
                "objstore %s: %s — retry %d/%d in %.2fs",
                desc, e, i + 1, attempts, delay,
            )
            sleep(delay)


def _status_error(op: str, status: int, detail: str = "") -> ObjStoreError:
    msg = f"{op}: {status}" + (f" {detail}" if detail else "")
    if status >= 500 or status == 429:
        return TransientStoreError(msg)
    return ObjStoreError(msg)


class _RangeIgnored(TransientStoreError):
    """The server answered a nonzero Range request with 200-whole-object.
    Appending that stream would duplicate the resumed prefix, so the
    download restarts from byte 0 instead."""


def _read_exact(resp, n: int, desc: str) -> bytearray:
    """Read exactly n bytes from a response, straight into one buffer
    (no chunk list, no second copy: the ranged parts of a parallel fetch
    read several times faster so); a cleanly-closed short stream raises
    IncompleteRead so the retry layer re-requests."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = resp.readinto(view[got:])
        if not k:
            raise http.client.IncompleteRead(bytes(buf[:got]), n - got)
        got += k
    return buf


def _ranged_get_to_file(open_stream, desc: str, dest_path: str) -> None:
    """Streaming download with mid-stream resume: on a transient failure
    the next attempt re-requests `bytes=<bytes_on_disk>-` and APPENDS,
    instead of redownloading the whole object. A fresh call always
    truncates dest, so stale partials from a previous process never
    leak into the result. `open_stream(start)` must return a
    (response, connection) pair positioned at byte `start`."""
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    state = {"offset": 0}

    def attempt():
        try:
            resp, conn = open_stream(state["offset"])
        except _RangeIgnored:
            state["offset"] = 0
            resp, conn = open_stream(0)
        try:
            # http.client's read(amt) returns b"" on a premature close
            # instead of raising, so a mid-stream cut would otherwise
            # pass for end-of-object and leave a silently truncated
            # file. Hold it to the advertised Content-Length ourselves.
            expected = resp.length
            received = 0
            with open(dest_path, "wb" if state["offset"] == 0 else "ab") as f:
                while True:
                    chunk = resp.read(CHUNK)
                    if not chunk:
                        break
                    f.write(chunk)
                    received += len(chunk)
                    state["offset"] += len(chunk)
            if expected is not None and received < expected:
                raise http.client.IncompleteRead(b"", expected - received)
        finally:
            conn.close()

    with_retries(f"get {desc}", attempt)


def parse_url(url: str) -> tuple[str, str, str]:
    """'gs://bucket/a/b' -> ('gs', 'bucket', 'a/b')."""
    parsed = urllib.parse.urlparse(url)
    return parsed.scheme, parsed.netloc, parsed.path.lstrip("/")


def client_for(url: str):
    scheme, _, _ = parse_url(url)
    if scheme == "gs":
        return GCSClient()
    if scheme == "s3":
        return S3Client()
    if scheme == "oss":
        return S3Client(
            endpoint=os.environ.get("OSS_ENDPOINT"),
            access_key=os.environ.get("OSS_ACCESS_KEY_ID"),
            secret_key=os.environ.get("OSS_ACCESS_KEY_SECRET"),
        )
    if scheme == "file":
        return LocalDirClient()
    raise ObjStoreError(f"unsupported object-store scheme {scheme!r}")


# Upload bodies go out in 1 MiB blocks, not http.client's 8 KiB: the
# same bytes on the wire in 128x fewer sends.
SEND_BLOCK = 1 << 20


def _http(endpoint: str, default_host: str, timeout: float = 120.0):
    """HTTPConnection for an endpoint override (scheme optional) or the
    default HTTPS host."""
    kw = dict(timeout=timeout, blocksize=SEND_BLOCK)
    if endpoint:
        if "://" not in endpoint:
            endpoint = "http://" + endpoint
        p = urllib.parse.urlparse(endpoint)
        if p.scheme == "https":
            return http.client.HTTPSConnection(p.hostname, p.port or 443, **kw)
        return http.client.HTTPConnection(p.hostname, p.port or 80, **kw)
    return http.client.HTTPSConnection(default_host, 443, **kw)


_META_LOCK = threading.Lock()
_META_TOKEN: tuple[str, float] | None = None
_META_NEGATIVE_UNTIL = [0.0]  # cache "no SA / unreachable" for 60s


def gcp_metadata_token(required: bool = False) -> str | None:
    """OAuth token from the GKE metadata server (workload identity /
    node SA), cached with 60s expiry skew. None (anonymous fallback)
    ONLY for the definitive no-credentials signals — unreachable server
    or 404 no-default-SA — and that negative result is cached for 60s so
    hot paths don't re-poll a 5s-timeout endpoint. Transient errors
    (429/5xx) raise: silently downgrading to anonymous would turn them
    into misleading permission errors downstream."""
    global _META_TOKEN
    import time

    now = time.time()
    with _META_LOCK:
        if _META_TOKEN and _META_TOKEN[1] > now + 60:
            return _META_TOKEN[0]
        if _META_NEGATIVE_UNTIL[0] > now and not required:
            return None
        try:
            conn = http.client.HTTPConnection(
                "metadata.google.internal", 80, timeout=5
            )
            conn.request(
                "GET",
                "/computeMetadata/v1/instance/service-accounts/default/token",
                headers={"Metadata-Flavor": "Google"},
            )
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
        except OSError as e:
            _META_NEGATIVE_UNTIL[0] = now + 60
            if required:
                raise ObjStoreError(f"metadata server unreachable: {e}")
            return None
        if resp.status == 404:  # reachable, no default service account
            _META_NEGATIVE_UNTIL[0] = now + 60
            if required:
                raise ObjStoreError("metadata server: no default service account")
            return None
        if resp.status != 200:  # transient (429/5xx): surface, don't downgrade
            raise ObjStoreError(
                f"metadata token: {resp.status} {body[:120]!r}"
            )
        data = json.loads(body)
        _META_TOKEN = (
            data["access_token"],
            now + float(data.get("expires_in", 300)),
        )
        return _META_TOKEN[0]


class GCSClient:
    """GCS JSON API: list / download (alt=media, chunked) / upload."""

    def __init__(self, endpoint: str | None = None):
        self.endpoint = endpoint or os.environ.get("STORAGE_EMULATOR_HOST")

    def _auth(self) -> dict:
        if self.endpoint:
            return {}
        token = gcp_metadata_token()
        return {"Authorization": f"Bearer {token}"} if token else {}

    def _conn(self):
        return _http(self.endpoint, "storage.googleapis.com")

    def list(self, bucket: str, prefix: str) -> list[dict]:
        """[{name, size}] under prefix (paginated)."""
        items, page = [], None
        while True:
            q = {"prefix": prefix, "maxResults": "1000"}
            if page:
                q["pageToken"] = page

            def attempt():
                conn = self._conn()
                try:
                    conn.request(
                        "GET",
                        f"/storage/v1/b/{urllib.parse.quote(bucket, safe='')}/o?"
                        + urllib.parse.urlencode(q),
                        headers=self._auth(),
                    )
                    resp = conn.getresponse()
                    body = resp.read()
                    if resp.status >= 400:
                        raise _status_error(
                            f"gcs list {bucket}/{prefix}",
                            resp.status, repr(body[:200]),
                        )
                    return body
                finally:
                    conn.close()

            out = json.loads(
                with_retries(f"list gs://{bucket}/{prefix}", attempt)
            )
            items += [
                {"name": o["name"], "size": int(o.get("size", 0))}
                for o in out.get("items", [])
            ]
            page = out.get("nextPageToken")
            if not page:
                return items

    def _object_path(self, bucket: str, name: str) -> str:
        return (
            f"/download/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
            f"/o/{urllib.parse.quote(name, safe='')}?alt=media"
        )

    def get_to_file(self, bucket: str, name: str, dest_path: str) -> None:
        _ranged_get_to_file(
            lambda start: self._open_stream(bucket, name, start),
            f"gs://{bucket}/{name}", dest_path,
        )

    def get_range(self, bucket: str, name: str, start: int, end: int) -> bytearray:
        """Inclusive byte range [start, end] of one object."""
        def attempt():
            resp, conn = self._open_stream(bucket, name, start, end)
            try:
                return _read_exact(
                    resp, end - start + 1, f"gs://{bucket}/{name}"
                )
            finally:
                conn.close()

        return with_retries(
            f"get gs://{bucket}/{name}[{start}-{end}]", attempt
        )

    def _open_stream(
        self, bucket: str, name: str, start: int = 0, end: int | None = None
    ):
        """(response, connection) streaming the object from `start`
        (to `end` inclusive when given). Returns a NON-206 response for
        start=0; a server that ignores a nonzero Range raises so the
        caller restarts from scratch instead of appending a duplicate
        prefix."""
        headers = self._auth()
        if start > 0 or end is not None:
            headers = dict(headers)
            headers["Range"] = (
                f"bytes={start}-" if end is None else f"bytes={start}-{end}"
            )
        conn = self._conn()
        try:
            conn.request("GET", self._object_path(bucket, name), headers=headers)
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        if resp.status >= 400:
            conn.close()
            raise _status_error(f"gcs get {bucket}/{name}", resp.status)
        if (start > 0 or end is not None) and resp.status != 206:
            conn.close()
            raise _RangeIgnored(
                f"gcs get {bucket}/{name}: server ignored Range "
                f"(status {resp.status})"
            )
        return resp, conn

    def put_from_file(self, bucket: str, name: str, src_path: str) -> None:
        size = os.path.getsize(src_path)

        def attempt():
            conn = self._conn()
            try:
                with open(src_path, "rb") as f:
                    headers = {
                        "Content-Length": str(size),
                        "Content-Type": "application/octet-stream",
                    }
                    headers.update(self._auth())
                    conn.request(
                        "POST",
                        f"/upload/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
                        f"/o?uploadType=media&name={urllib.parse.quote(name, safe='')}",
                        body=f,
                        headers=headers,
                    )
                    resp = conn.getresponse()
                    resp.read()
                    if resp.status >= 400:
                        raise _status_error(
                            f"gcs put {bucket}/{name}", resp.status
                        )
            finally:
                conn.close()

        with_retries(f"put gs://{bucket}/{name}", attempt)


def sigv4_sign(
    method: str,
    path: str,
    query: str,
    extra_headers: dict[str, str],
    payload_hash: str,
    *,
    service: str,
    region: str,
    host: str,
    access_key: str,
    secret_key: str,
) -> dict:
    """AWS Signature Version 4 over (host, x-amz-date, extra_headers)."""
    now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    headers = {"host": host, "x-amz-date": amz_date}
    headers.update({k.lower(): v for k, v in extra_headers.items()})
    names = sorted(headers)
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in names)
    signed = ";".join(names)
    canonical = "\n".join(
        [method, path, query, canonical_headers, signed, payload_hash]
    )
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    to_sign = "\n".join(
        [
            "AWS4-HMAC-SHA256",
            amz_date,
            scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ]
    )

    def hm(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = hm(("AWS4" + secret_key).encode(), datestamp)
    k = hm(k, region)
    k = hm(k, service)
    k = hm(k, "aws4_request")
    sig = hmac.new(k, to_sign.encode(), hashlib.sha256).hexdigest()
    out = {k: v for k, v in extra_headers.items()}
    out["x-amz-date"] = amz_date
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={sig}"
    )
    return out


class S3Client:
    """S3 REST (path-style) with optional SigV4 signing."""

    def __init__(
        self,
        endpoint: str | None = None,
        access_key: str | None = None,
        secret_key: str | None = None,
        region: str | None = None,
    ):
        self.endpoint = endpoint or os.environ.get("AWS_ENDPOINT_URL")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY")
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")

    def _host(self) -> str:
        if self.endpoint:
            return urllib.parse.urlparse(
                self.endpoint if "://" in self.endpoint
                else "http://" + self.endpoint
            ).netloc
        return f"s3.{self.region}.amazonaws.com"

    def _conn(self):
        return _http(self.endpoint, f"s3.{self.region}.amazonaws.com")

    def _sign(
        self, method: str, path: str, query: str, payload_hash: str
    ) -> dict:
        """AWS Signature Version 4 (headers-only, single-chunk)."""
        if not self.access_key or not self.secret_key:
            return {}  # unsigned: fakes/public buckets
        return sigv4_sign(
            method, path, query,
            {"x-amz-content-sha256": payload_hash},
            payload_hash,
            service="s3", region=self.region, host=self._host(),
            access_key=self.access_key, secret_key=self.secret_key,
        )

    EMPTY_SHA = hashlib.sha256(b"").hexdigest()

    def list(self, bucket: str, prefix: str) -> list[dict]:
        items, token = [], None
        while True:
            q = {"list-type": "2", "prefix": prefix, "max-keys": "1000"}
            if token:
                q["continuation-token"] = token
            # SigV4 canonicalizes with %20, not '+': quote, not quote_plus.
            query = urllib.parse.urlencode(
                sorted(q.items()), quote_via=urllib.parse.quote
            )
            path = f"/{bucket}"

            def attempt():
                conn = self._conn()
                try:
                    headers = self._sign("GET", path, query, self.EMPTY_SHA)
                    conn.request("GET", f"{path}?{query}", headers=headers)
                    resp = conn.getresponse()
                    body = resp.read()
                    if resp.status >= 400:
                        raise _status_error(
                            f"s3 list {bucket}/{prefix}",
                            resp.status, repr(body[:200]),
                        )
                    return body
                finally:
                    conn.close()

            body = with_retries(f"list s3://{bucket}/{prefix}", attempt)
            ns = {"s3": "http://s3.amazonaws.com/doc/2006-03-01/"}
            root = ET.fromstring(body)
            # Tolerate namespaced and namespace-less XML (fakes).
            def findall(tag):
                return root.findall(f"s3:{tag}", ns) or root.findall(tag)

            for c in findall("Contents"):
                key = c.find("s3:Key", ns)
                key = key if key is not None else c.find("Key")
                size = c.find("s3:Size", ns)
                size = size if size is not None else c.find("Size")
                items.append(
                    {"name": key.text, "size": int(size.text if size is not None else 0)}
                )
            trunc = findall("IsTruncated")
            token_el = findall("NextContinuationToken")
            if trunc and trunc[0].text == "true" and token_el:
                token = token_el[0].text
            else:
                return items

    def get_to_file(self, bucket: str, name: str, dest_path: str) -> None:
        _ranged_get_to_file(
            lambda start: self._open_stream(bucket, name, start),
            f"s3://{bucket}/{name}", dest_path,
        )

    def get_range(self, bucket: str, name: str, start: int, end: int) -> bytearray:
        """Inclusive byte range [start, end] of one object."""
        def attempt():
            resp, conn = self._open_stream(bucket, name, start, end)
            try:
                return _read_exact(
                    resp, end - start + 1, f"s3://{bucket}/{name}"
                )
            finally:
                conn.close()

        return with_retries(
            f"get s3://{bucket}/{name}[{start}-{end}]", attempt
        )

    def _open_stream(
        self, bucket: str, name: str, start: int = 0, end: int | None = None
    ):
        """(response, connection) streaming the object from `start` (to
        `end` inclusive when given). Range is an unsigned header — SigV4
        only commits to (host, x-amz-date, x-amz-content-sha256) here."""
        path = f"/{bucket}/{urllib.parse.quote(name)}"
        headers = dict(self._sign("GET", path, "", self.EMPTY_SHA))
        if start > 0 or end is not None:
            headers["Range"] = (
                f"bytes={start}-" if end is None else f"bytes={start}-{end}"
            )
        conn = self._conn()
        try:
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        if resp.status >= 400:
            conn.close()
            raise _status_error(f"s3 get {bucket}/{name}", resp.status)
        if (start > 0 or end is not None) and resp.status != 206:
            conn.close()
            raise _RangeIgnored(
                f"s3 get {bucket}/{name}: server ignored Range "
                f"(status {resp.status})"
            )
        return resp, conn

    def put_from_file(self, bucket: str, name: str, src_path: str) -> None:
        path = f"/{bucket}/{urllib.parse.quote(name)}"

        # Sign with UNSIGNED-PAYLOAD so the file streams without a
        # whole-file hash pass into memory.
        def attempt():
            conn = self._conn()
            try:
                with open(src_path, "rb") as f:
                    headers = {
                        "Content-Length": str(os.path.getsize(src_path)),
                    }
                    headers.update(
                        self._sign("PUT", path, "", "UNSIGNED-PAYLOAD")
                    )
                    conn.request("PUT", path, body=f, headers=headers)
                    resp = conn.getresponse()
                    resp.read()
                    if resp.status >= 400:
                        raise _status_error(
                            f"s3 put {bucket}/{name}", resp.status
                        )
            finally:
                conn.close()

        with_retries(f"put s3://{bucket}/{name}", attempt)


class LocalDirClient:
    """A plain directory behind the object-store client interface
    (file:// URLs): PVC-mounted snapshot volumes, tests, and bench runs
    with no bucket in reach. `parse_url("file:///var/snap")` yields
    bucket "" and prefix "var/snap", so names resolve from `root`
    (the filesystem root by default)."""

    def __init__(self, root: str = "/"):
        self.root = root

    def _path(self, bucket: str, name: str) -> str:
        parts = [p for p in (bucket, name) if p]
        return os.path.join(self.root, *parts) if parts else self.root

    def list(self, bucket: str, prefix: str) -> list[dict]:
        """String-prefix semantics like the real stores: a prefix naming
        a directory lists its whole tree; one naming a file lists it."""
        base = self._path(bucket, prefix)
        items = []
        if os.path.isfile(base):
            items.append({"name": prefix, "size": os.path.getsize(base)})
        if os.path.isdir(base):
            for root, _dirs, files in os.walk(base):
                for fname in files:
                    full = os.path.join(root, fname)
                    rel = os.path.relpath(full, base)
                    name = f"{prefix.rstrip('/')}/{rel}" if prefix else rel
                    items.append(
                        {"name": name, "size": os.path.getsize(full)}
                    )
        return sorted(items, key=lambda o: o["name"])

    def get_to_file(self, bucket: str, name: str, dest_path: str) -> None:
        src = self._path(bucket, name)
        if not os.path.isfile(src):
            raise ObjStoreError(f"file get {src}: not found")
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        with open(src, "rb") as s, open(dest_path, "wb") as d:
            while True:
                chunk = s.read(CHUNK)
                if not chunk:
                    break
                d.write(chunk)

    def get_range(self, bucket: str, name: str, start: int, end: int) -> bytes:
        src = self._path(bucket, name)
        if not os.path.isfile(src):
            raise ObjStoreError(f"file get {src}: not found")
        with open(src, "rb") as f:
            f.seek(start)
            return f.read(end - start + 1)

    def put_from_file(self, bucket: str, name: str, src_path: str) -> None:
        dest = self._path(bucket, name)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        tmp = dest + ".inflight"
        with open(src_path, "rb") as s, open(tmp, "wb") as d:
            while True:
                chunk = s.read(CHUNK)
                if not chunk:
                    break
                d.write(chunk)
        os.replace(tmp, dest)  # objects appear atomically, like a store


def download_prefix(url: str, dest_dir: str, client=None) -> list[str]:
    """Download every object under `url` into dest_dir (relative names),
    one object at a time, chunked to disk. Returns the local paths."""
    scheme, bucket, prefix = parse_url(url)
    client = client or client_for(url)
    objects = client.list(bucket, prefix)
    # Store listing is plain string-prefix matching: 'models/llama' also
    # matches 'models/llama-70b/...'. Keep only the directory itself.
    if prefix and not prefix.endswith("/"):
        objects = [
            o for o in objects
            if o["name"] == prefix or o["name"].startswith(prefix + "/")
        ]
    if not objects:
        raise ObjStoreError(f"no objects under {url}")
    out = []
    for obj in objects:
        rel = obj["name"][len(prefix):].lstrip("/") if prefix else obj["name"]
        if not rel:  # the prefix itself as an object
            rel = os.path.basename(obj["name"])
        dest = os.path.join(dest_dir, rel)
        logger.info("downloading %s/%s (%d bytes)", bucket, obj["name"], obj["size"])
        client.get_to_file(bucket, obj["name"], dest)
        out.append(dest)
    return out


def upload_dir(src_dir: str, url: str, client=None) -> list[str]:
    """Upload a directory tree under the destination prefix."""
    scheme, bucket, prefix = parse_url(url)
    client = client or client_for(url)
    uploaded = []
    for root, _, files in os.walk(src_dir):
        for fname in files:
            full = os.path.join(root, fname)
            rel = os.path.relpath(full, src_dir)
            key = f"{prefix.rstrip('/')}/{rel}" if prefix else rel
            logger.info("uploading %s -> %s/%s", rel, bucket, key)
            client.put_from_file(bucket, key, full)
            uploaded.append(key)
    return uploaded


def fetch_object_parallel(
    client,
    bucket: str,
    name: str,
    size: int,
    dest_path: str,
    *,
    part_bytes: int = 8 << 20,
    max_workers: int = 8,
) -> None:
    """Chunk-parallel ranged download of ONE object: the dest file is
    preallocated, then worker threads each GET an independent byte range
    (individually retried; fresh connection per request) and pwrite it
    into place. Small objects and clients without `get_range` fall back
    to the sequential streaming path."""
    if size <= part_bytes or not hasattr(client, "get_range"):
        client.get_to_file(bucket, name, dest_path)
        return
    os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
    with open(dest_path, "wb") as f:
        f.truncate(size)
    ranges = [
        (s, min(s + part_bytes, size) - 1) for s in range(0, size, part_bytes)
    ]
    import concurrent.futures

    fd = os.open(dest_path, os.O_WRONLY)
    try:
        def fetch(rng):
            start, end = rng
            os.pwrite(fd, client.get_range(bucket, name, start, end), start)

        with concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers
        ) as ex:
            # list() re-raises the first worker failure
            list(ex.map(fetch, ranges))
    finally:
        os.close(fd)


SNAPSHOT_VERSION = 1
SNAPSHOT_MANIFEST = "MANIFEST.json"


class SnapshotStore:
    """Engine boot snapshots: the tree the engine is built from (the
    port's native checkpoint, `engine/weights.py::save_native_checkpoint`)
    plus the compile artefact, so a replica's birth costs a streamed
    restore instead of a checkpoint conversion and a build. In the port
    the artefact is the kernel library (`ops/_build.py`), where the JAX
    package bundles its persistent compilation cache.

    Layout under `<url>/<model>/<fingerprint>/`:

      params/...      the native checkpoint (one object per file)
      kernels/...     the kernel library, under the hash of its sources
                      and flags (empty where none was built, as on the
                      CPU)
      MANIFEST.json   uploaded LAST — its presence marks the snapshot
                      complete. A crashed publisher leaves no manifest,
                      so a partial tree is never restored; the next full
                      boot simply overwrites it.

    The fingerprint folds in everything that changes the on-device
    layout or the compiled program (model id, engine config, device
    signature, snapshot schema version). `fetch` re-validates the
    manifest against the expected fingerprint and raises
    `SnapshotMismatch` on drift: a stale layout must NEVER be served —
    callers fall back to the full-load path and republish, self-healing
    the key."""

    def __init__(self, url: str, client=None):
        self.url = url.rstrip("/")
        self.client = client or client_for(self.url)
        _scheme, self.bucket, self.base_prefix = parse_url(self.url)

    @staticmethod
    def fingerprint(
        model: str,
        engine_config: dict,
        mesh_shape,
        version: int = SNAPSHOT_VERSION,
    ) -> str:
        """The key of a snapshot. `mesh_shape` is the JAX package's mesh
        signature there and the port's `coldstart.device_signature` here:
        the formula is the JAX package's, so only what goes in differs."""
        blob = json.dumps(
            {
                "model": model,
                "engine_config": engine_config,
                "mesh_shape": list(mesh_shape),
                "snapshot_version": version,
            },
            sort_keys=True,
            default=str,
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def _prefix(self, model: str, fingerprint: str) -> str:
        parts = [self.base_prefix, model.replace("/", "--"), fingerprint]
        return "/".join(p for p in parts if p)

    def manifest(self, model: str, fingerprint: str) -> dict | None:
        """The manifest iff a COMPLETE snapshot exists at this key.
        Store trouble (including exhausted retries) reads as absent:
        boot falls back to the full-load path rather than crash-looping
        on an unreachable bucket."""
        import tempfile

        key = f"{self._prefix(model, fingerprint)}/{SNAPSHOT_MANIFEST}"
        tmp = tempfile.mktemp()
        try:
            self.client.get_to_file(self.bucket, key, tmp)
            with open(tmp) as f:
                return json.load(f)
        except (ObjStoreError, json.JSONDecodeError):
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def fetch(
        self,
        model: str,
        fingerprint: str,
        dest_dir: str,
        *,
        max_workers: int = 8,
    ) -> dict | None:
        """Download the snapshot tree into dest_dir (params/ +
        kernels/), chunk-parallel per object. Returns the manifest,
        None when absent, or raises `SnapshotMismatch` when the manifest
        disagrees with the expected fingerprint."""
        man = self.manifest(model, fingerprint)
        if man is None:
            return None
        if man.get("fingerprint") != fingerprint:
            raise SnapshotMismatch(
                f"snapshot at {self._prefix(model, fingerprint)} carries "
                f"fingerprint {man.get('fingerprint')!r}, expected "
                f"{fingerprint!r} — falling back to full load"
            )
        prefix = self._prefix(model, fingerprint)
        for obj in self.client.list(self.bucket, prefix + "/"):
            rel = obj["name"][len(prefix):].lstrip("/")
            if not rel or rel == SNAPSHOT_MANIFEST:
                continue
            fetch_object_parallel(
                self.client,
                self.bucket,
                obj["name"],
                obj["size"],
                os.path.join(dest_dir, rel),
                max_workers=max_workers,
            )
        return man

    def publish(
        self, model: str, fingerprint: str, src_dir: str, *, meta: dict | None = None
    ) -> dict:
        """Upload a snapshot directory; MANIFEST.json goes LAST so a
        half-uploaded tree is never mistaken for a complete snapshot.
        Republishing over an existing key overwrites it (self-heal)."""
        import tempfile

        prefix = self._prefix(model, fingerprint)
        uploaded = []
        for root, _dirs, files in os.walk(src_dir):
            for fname in sorted(files):
                if fname == SNAPSHOT_MANIFEST:
                    continue
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, src_dir)
                self.client.put_from_file(self.bucket, f"{prefix}/{rel}", full)
                uploaded.append(rel)
        man = {
            "fingerprint": fingerprint,
            "model": model,
            "snapshot_version": SNAPSHOT_VERSION,
            "objects": sorted(uploaded),
            **(meta or {}),
        }
        with tempfile.NamedTemporaryFile(
            "w", suffix=".json", delete=False
        ) as f:
            json.dump(man, f)
            tmp = f.name
        try:
            self.client.put_from_file(
                self.bucket, f"{prefix}/{SNAPSHOT_MANIFEST}", tmp
            )
        finally:
            os.unlink(tmp)
        return man


class KVSpillStore:
    """Spill/fill store for evicted hot-prefix KV pages (the objstore leg
    of the cluster KV-sharing tier). Each entry is one serialized
    single-page `KVPageExport` blob keyed by its chain hash (hex), so a
    fill is a plain GET and needs no index.

    Two backends behind one interface:
      - in-memory LRU (url=""): the default and the test surface — spill
        stays a node-local optimization with a hard byte cap;
      - object store (gs://, s3://, oss://, file://): pages persist as
        `<prefix>/<hash>.kvp` objects via the zero-dependency clients
        above, shared fleet-wide.

    Every method is best-effort by contract: the callers (eviction hook,
    fetch fallback) treat any failure as a miss and recompute.
    """

    def __init__(self, url: str = "", max_bytes: int = 256 << 20):
        from collections import OrderedDict

        self.url = url
        self.max_bytes = max_bytes
        self._mem: "OrderedDict[str, bytes]" = OrderedDict()
        self._mem_bytes = 0
        self.puts = 0
        self.gets = 0
        self.hits = 0

    def _key(self, hash_hex: str) -> tuple[str, str]:
        _scheme, bucket, prefix = parse_url(self.url)
        name = f"{hash_hex}.kvp"
        return bucket, f"{prefix.rstrip('/')}/{name}" if prefix else name

    def put(self, hash_hex: str, blob: bytes) -> None:
        self.puts += 1
        if not self.url:
            if len(blob) > self.max_bytes:
                return
            old = self._mem.pop(hash_hex, None)
            if old is not None:
                self._mem_bytes -= len(old)
            self._mem[hash_hex] = blob
            self._mem_bytes += len(blob)
            while self._mem_bytes > self.max_bytes and self._mem:
                _h, dropped = self._mem.popitem(last=False)
                self._mem_bytes -= len(dropped)
            return
        import tempfile

        bucket, key = self._key(hash_hex)
        client = client_for(self.url)
        with tempfile.NamedTemporaryFile(delete=False) as f:
            f.write(blob)
            tmp = f.name
        try:
            client.put_from_file(bucket, key, tmp)
        finally:
            os.unlink(tmp)

    def get(self, hash_hex: str) -> bytes | None:
        self.gets += 1
        if not self.url:
            blob = self._mem.get(hash_hex)
            if blob is not None:
                self._mem.move_to_end(hash_hex)
                self.hits += 1
            return blob
        import tempfile

        bucket, key = self._key(hash_hex)
        client = client_for(self.url)
        tmp = tempfile.mktemp()
        try:
            client.get_to_file(bucket, key, tmp)
            with open(tmp, "rb") as f:
                blob = f.read()
            self.hits += 1
            return blob
        except Exception:
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
