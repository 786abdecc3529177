"""The object-store layer of kubeai_tpu_torch (objstore.py and the
object-store branch of `engine/weights.py::resolve_model_dir`) against
the JAX package's, on the CPU.

- `sigv4_sign` is bit-equal on fixed inputs (the clock frozen), the
  retry schedule of `with_retries` and its `RETRIES` count are equal
  under the same `rng` and `sleep`, and `_is_transient` agrees on a table
  of exceptions.
- Against fake GCS and S3 servers (tests/torch_objstore_fakes.py), both
  packages' clients send the same requests, header for header: list, get,
  get_range, put, a mid-stream cut resumed with Range, `download_prefix`
  (whose files are bit-equal), `upload_dir` and `fetch_object_parallel`.
- A weights cache directory written by the JAX loader is reused by the
  port without a request, and the port writes the same directory.
- `KVSpillStore` over gs:// and file://: a page put by one package is got
  byte for byte by the other, in both directions.
"""

import datetime
import http.client
import os
import random

import pytest
import torch

from torch_objstore_fakes import FakeGCS, FakeS3

from kubeai_tpu import objstore as jstore
from kubeai_tpu.engine import weights as jweights
from kubeai_tpu_torch import objstore as tstore
from kubeai_tpu_torch.engine import weights as tweights

PACKAGES = {"jax": jstore, "torch": tstore}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs many tiny ops: one intra-op thread keeps
    them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Frozen(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 18, 12, 34, 56, tzinfo=tz)


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages read the one `datetime` module: SigV4's date and
    signature are fixed while the test runs."""
    monkeypatch.setattr(datetime, "datetime", _Frozen)


@pytest.fixture
def no_sleep(monkeypatch):
    for pkg in PACKAGES.values():
        monkeypatch.setattr(pkg, "RETRY_SLEEP", lambda s: None)


@pytest.fixture
def gcs(monkeypatch):
    fake = FakeGCS()
    monkeypatch.setenv("STORAGE_EMULATOR_HOST", fake.endpoint)
    yield fake
    fake.close()


@pytest.fixture
def s3(monkeypatch):
    fake = FakeS3()
    monkeypatch.setenv("AWS_ENDPOINT_URL", fake.endpoint)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIDEXAMPLE")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY")
    yield fake
    fake.close()


# ---- signing, retries, transient failures -------------------------------------


@pytest.mark.parametrize("method,path,query,extra,payload,service,region", [
    ("GET", "/bucket/a%20b.bin", "", {"x-amz-content-sha256": "e3b0"}, "e3b0", "s3",
     "us-east-1"),
    ("PUT", "/b/k", "", {"x-amz-content-sha256": "UNSIGNED-PAYLOAD"}, "UNSIGNED-PAYLOAD",
     "s3", "eu-west-2"),
    ("GET", "/b", "list-type=2&max-keys=1000&prefix=models%2Fllama", {}, "e3b0", "s3",
     "us-east-1"),
    ("POST", "/", "", {"Content-Type": "application/x-www-form-urlencoded"}, "abcd",
     "sqs", "ap-south-1"),
], ids=["get", "put", "list", "other-service"])
def test_sigv4_sign_bit_equal(frozen_clock, method, path, query, extra, payload,
                              service, region):
    kw = dict(service=service, region=region, host="127.0.0.1:9000",
              access_key="AKIDEXAMPLE", secret_key="secret/key+1")
    got = tstore.sigv4_sign(method, path, query, extra, payload, **kw)
    want = jstore.sigv4_sign(method, path, query, extra, payload, **kw)
    assert got == want
    assert got["x-amz-date"] == "20261018T123456Z"


@pytest.mark.parametrize("failures,attempts", [(0, 4), (2, 4), (4, 4), (5, 4), (3, 1)])
def test_with_retries_schedule_matches_jax(failures, attempts):
    """The same delays (capped exponential backoff, jitter from the same
    rng) and the same RETRIES count; past the attempts, the last error
    is raised."""
    results = {}
    for name, pkg in PACKAGES.items():
        delays, calls = [], []
        rng = random.Random(11)

        def fn():
            calls.append(1)
            if len(calls) <= failures:
                raise pkg.TransientStoreError(f"503 #{len(calls)}")
            return "ok"

        before = pkg.RETRIES["total"]
        try:
            out = pkg.with_retries("op", fn, attempts=attempts, sleep=delays.append,
                                   rng=rng.random)
        except pkg.TransientStoreError as e:
            out = f"raised {e}"
        results[name] = (out, delays, len(calls), pkg.RETRIES["total"] - before)
    assert results["torch"] == results["jax"]
    assert results["torch"][2] == min(failures, attempts) + 1


def test_is_transient_matches_jax():
    def table(pkg):
        return [
            pkg.TransientStoreError("503"), pkg.ObjStoreError("403"),
            pkg.SnapshotMismatch("fp"), pkg._RangeIgnored("200"),
            pkg._status_error("get", 503), pkg._status_error("get", 429),
            pkg._status_error("get", 404), ConnectionResetError(), ConnectionRefusedError(),
            BrokenPipeError(), TimeoutError(), http.client.IncompleteRead(b"ab", 3),
            http.client.RemoteDisconnected("gone"), http.client.BadStatusLine("x"),
            OSError("disk"), ValueError("x"), KeyError("k"),
        ]

    got = [tstore._is_transient(e) for e in table(tstore)]
    assert got == [jstore._is_transient(e) for e in table(jstore)]
    assert got[:7] == [True, False, False, True, True, True, False]


def test_parse_url_and_clients_match_jax(monkeypatch):
    monkeypatch.setenv("OSS_ENDPOINT", "http://127.0.0.1:1")
    for url in ("gs://b/p/q", "s3://b/models/llama", "oss://b/x", "file:///var/snap",
                "gs://b"):
        assert tstore.parse_url(url) == jstore.parse_url(url)
        got, want = tstore.client_for(url), jstore.client_for(url)
        assert type(got).__name__ == type(want).__name__
        assert vars(got) == vars(want)
    for pkg in PACKAGES.values():
        with pytest.raises(pkg.ObjStoreError, match="unsupported"):
            pkg.client_for("ftp://b/x")


# ---- the wire, against fake stores --------------------------------------------


def _client(kind: str, pkg):
    return pkg.GCSClient() if kind == "gcs" else pkg.S3Client()


@pytest.mark.parametrize("kind", ["gcs", "s3"])
def test_requests_match_jax(kind, gcs, s3, frozen_clock, no_sleep, tmp_path):
    """list, get_to_file, get_range, put_from_file, a mid-stream cut
    resumed with `Range: bytes=N-`, and a ranged read cut and retried:
    the same requests from both packages, and the same bytes back."""
    fake = gcs if kind == "gcs" else s3
    payload = bytes(range(256)) * 40 + b"tail"
    src = tmp_path / "src.bin"
    src.write_bytes(payload)
    logs, got = {}, {}
    for name, pkg in PACKAGES.items():
        fake.objects.clear()
        fake.log.clear()
        client = _client(kind, pkg)
        client.put_from_file("bkt", "models/m one/w.bin", str(src))
        client.put_from_file("bkt", "models/m one/config.json", str(src))
        listed = client.list("bkt", "models/m one")
        fake.cut_next["models/m one/w.bin"] = 3000
        dest = tmp_path / name / "w.bin"
        client.get_to_file("bkt", "models/m one/w.bin", str(dest))
        fake.cut_next["models/m one/w.bin"] = 10
        part = client.get_range("bkt", "models/m one/w.bin", 100, 5099)
        logs[name] = list(fake.log)
        got[name] = (listed, dest.read_bytes(), part)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == payload and got["torch"][2] == payload[100:5100]
    assert logs["torch"] == logs["jax"]
    ranges = [dict(h).get("range") for _, _, h in logs["torch"]]
    assert "bytes=3000-" in ranges and ranges.count("bytes=100-5099") == 2


@pytest.mark.parametrize("kind", ["gcs", "s3"])
def test_download_prefix_and_upload_dir_match_jax(kind, gcs, s3, frozen_clock, tmp_path):
    """`upload_dir` then `download_prefix` (the string-prefix filter keeps
    'models/llama' from taking 'models/llama-70b'), and
    `fetch_object_parallel` in 4 KiB parts: the same requests, bit-equal
    files."""
    fake = gcs if kind == "gcs" else s3
    scheme = "gs" if kind == "gcs" else "s3"
    src = tmp_path / "ckpt"
    (src / "sub").mkdir(parents=True)
    (src / "config.json").write_text('{"a": 1}')
    (src / "sub" / "model.safetensors").write_bytes(os.urandom(20000))
    logs, files = {}, {}
    for name, pkg in PACKAGES.items():
        fake.objects.clear()
        fake.objects[("bkt", "models/llama-70b/other")] = b"not mine"
        fake.log.clear()
        uploaded = pkg.upload_dir(str(src), f"{scheme}://bkt/models/llama")
        out = tmp_path / f"out-{name}"
        paths = pkg.download_prefix(f"{scheme}://bkt/models/llama", str(out))
        pkg.fetch_object_parallel(
            _client(kind, pkg), "bkt", "models/llama/sub/model.safetensors", 20000,
            str(out / "parallel.bin"), part_bytes=4096, max_workers=1)
        logs[name] = list(fake.log)
        files[name] = (sorted(uploaded), sorted(os.path.relpath(p, out) for p in paths),
                       {p: open(os.path.join(out, p), "rb").read()
                        for p in ("config.json", "sub/model.safetensors", "parallel.bin")})
    assert files["torch"] == files["jax"]
    assert files["torch"][1] == ["config.json", "sub/model.safetensors"]
    assert files["torch"][2]["parallel.bin"] == (src / "sub" / "model.safetensors").read_bytes()
    assert logs["torch"] == logs["jax"]
    for pkg in PACKAGES.values():
        with pytest.raises(pkg.ObjStoreError, match="no objects"):
            pkg.download_prefix(f"{scheme}://bkt/absent", str(tmp_path / "none"))


def test_weights_cache_shared_with_jax(s3, frozen_clock, monkeypatch, tmp_path):
    """The JAX loader's cache directory for an s3:// checkpoint is the
    port's: the port resolves it without a request. In a cache of its
    own the port writes the same directory, marker included, from the
    same requests."""
    ckpt = tmp_path / "ckpt"
    tweights.save_safetensors(str(ckpt), {"w": torch.arange(12, dtype=torch.bfloat16)},
                              {"architectures": ["LlamaForCausalLM"]})
    tstore.upload_dir(str(ckpt), "s3://bkt/models/tiny")
    url = "s3://bkt/models/tiny"
    monkeypatch.setenv("KUBEAI_WEIGHTS_CACHE", str(tmp_path / "shared"))
    s3.log.clear()
    jdir = jweights.resolve_model_dir(url)
    jlog = list(s3.log)
    assert jlog and os.path.exists(os.path.join(jdir, ".kubeai-complete"))
    s3.log.clear()
    assert tweights.resolve_model_dir(url) == jdir
    assert s3.log == []
    monkeypatch.setenv("KUBEAI_WEIGHTS_CACHE", str(tmp_path / "own"))
    tdir = tweights.resolve_model_dir(url)
    assert s3.log == jlog
    assert os.path.basename(tdir) == os.path.basename(jdir)
    for fname in ("config.json", "model.safetensors", ".kubeai-complete"):
        with open(os.path.join(tdir, fname), "rb") as a, open(os.path.join(jdir, fname), "rb") as b:
            assert a.read() == b.read(), fname
    assert [f for f in os.listdir(tmp_path / "own") if f.startswith(".")] == []
    with pytest.raises(tweights.WeightLoadError, match="no objects"):
        tweights.resolve_model_dir("s3://bkt/models/absent")


@pytest.mark.parametrize("scheme", ["gs", "file"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_kv_spill_pages_cross_packages(gcs, scheme, writer, tmp_path):
    """A page blob put by one package's KVSpillStore is got byte for byte
    by the other's; a missing hash is a miss (None) on both."""
    url = "gs://spill/kv/pages" if scheme == "gs" else f"file://{tmp_path}/spill"
    reader = "torch" if writer == "jax" else "jax"
    stores = {name: pkg.KVSpillStore(url) for name, pkg in PACKAGES.items()}
    blob = os.urandom(4096) + b"KVP1"
    stores[writer].put("ab12cd", blob)
    assert stores[reader].get("ab12cd") == blob
    assert stores[reader].get("ffff") is None and stores[writer].get("ffff") is None
    assert (stores[reader].gets, stores[reader].hits) == (2, 1)
    if scheme == "gs":
        assert set(gcs.objects) == {("spill", "kv/pages/ab12cd.kvp")}
    else:
        assert (tmp_path / "spill" / "ab12cd.kvp").read_bytes() == blob
