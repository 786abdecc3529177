"""Restore-first boots of kubeai_tpu_torch (`engine/coldstart.py`, the
native checkpoint of `engine/weights.py`, the kernel-library hooks of
`ops/_build.py`) against the JAX package, on the CPU, over file://
buckets.

- Publish, then restore: the restored tree is bit-equal to the published
  one (bf16, f32, and int8 leaves with their N-major layout and a tied
  head); the phases and events are the JAX manager's; the manifest is
  uploaded last, and a tree without one reads `absent`; a wrong manifest
  reads `mismatch` and the boot loads in full.
- The kernel library: published under its hash, put in place on restore
  with no temporary file left, so `_build.build` would find it.
- A JAX-published snapshot in the same bucket reads `absent` to the
  port, and the port's reads `absent` to the JAX package.
- A restored engine's greedy and seeded streams equal the full-load
  engine's and `kubeai_tpu.engine.Engine.generate`'s. As in
  tests/unit/test_coldstart.py, a fallback loads other weights, so a
  silent fallback fails the test.
- Through `main` (full, restored, and a changed config with
  --snapshot-no-publish), then over HTTP: the served texts, and
  `/v1/state.cold_start` and `/metrics` under the JAX server's names.
"""

import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testutil import http_get, http_post

from kubeai_tpu import objstore as jstore
from kubeai_tpu.engine import Engine as JEngine
from kubeai_tpu.engine import EngineConfig as JEngineConfig
from kubeai_tpu.engine.coldstart import EVENTS as JEVENTS
from kubeai_tpu.engine.coldstart import PHASES as JPHASES
from kubeai_tpu.engine.coldstart import ColdStartManager as JColdStartManager
from kubeai_tpu.engine.sampling import SamplingParams as JSamplingParams
from kubeai_tpu.engine.server import EngineMetrics as JEngineMetrics
from kubeai_tpu.metrics import registry as jregistry
from kubeai_tpu.models import llama as jl
from kubeai_tpu.parallel.mesh import single_device_mesh
from kubeai_tpu_torch import objstore as tstore
from kubeai_tpu_torch.device import NoCudaDevice
from kubeai_tpu_torch.engine import Engine, EngineConfig, SamplingParams
from kubeai_tpu_torch.engine import server as server_mod
from kubeai_tpu_torch.engine.coldstart import (
    EVENTS,
    PHASES,
    PORT_TAG,
    ColdStartManager,
    device_signature,
)
from kubeai_tpu_torch.engine.quantization import quantize_params
from kubeai_tpu_torch.engine.server import EngineServer
from kubeai_tpu_torch.engine.tokenizer import ByteTokenizer
from kubeai_tpu_torch.engine.weights import (
    load_native_checkpoint,
    save_native_checkpoint,
    save_safetensors,
)
from kubeai_tpu_torch.models import llama as tl
from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.parity import params_from_numpy

TOK = ByteTokenizer()
MODEL = "snap-llama"
ECFG = dict(num_slots=4, max_seq_len=128, decode_chunk=4)
SAMPLING = {
    "greedy": dict(temperature=0.0, max_tokens=12),
    "seeded": dict(temperature=0.8, top_k=16, top_p=0.9, max_tokens=12, seed=5),
}
PROMPTS = [TOK.encode("The cold start was"), TOK.encode("Snapshots restore")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs many tiny ops: one intra-op thread keeps
    them from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=TOK.vocab_size),
                               dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=TOK.vocab_size),
                               dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _other_weights(tcfg):
    """What a silent fallback would serve: weights from another seed."""
    return tl.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, tree


def _bit_equal(a, b) -> None:
    """The same leaves, dtypes, shapes, strides and bytes."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for name, t in la.items():
        u = lb[name]
        assert t.dtype == u.dtype and t.shape == u.shape and t.stride() == u.stride(), name
        assert torch.equal(t.contiguous().view(-1).view(torch.uint8),
                           u.contiguous().view(-1).view(torch.uint8)), name


@pytest.fixture(scope="module")
def boots(models, tmp_path_factory):
    """Two port boots against one file:// bucket: the first loads in
    full and publishes, the second restores (its fallback would load
    other weights)."""
    _, _, tcfg, tparams = models
    root = tmp_path_factory.mktemp("snap")
    url = f"file://{root}/bucket"
    mgr1 = ColdStartManager(url, MODEL, ECFG, "cpu", work_dir=str(root / "boot1"))
    params1 = mgr1.acquire_params(lambda: tparams)
    assert mgr1.maybe_publish(params1) is True
    mgr2 = ColdStartManager(url, MODEL, ECFG, "cpu", work_dir=str(root / "boot2"))
    params2 = mgr2.acquire_params(lambda: _other_weights(tcfg))
    return root, url, mgr1, params1, mgr2, params2


@pytest.fixture(scope="module")
def jax_boots(models, tmp_path_factory):
    """The JAX package's two boots (orbax tree, compilation cache) of the
    same model name and engine config in a bucket of their own."""
    _, jparams, _, _ = models
    root = tmp_path_factory.mktemp("jsnap")
    url = f"file://{root}/bucket"
    mesh = single_device_mesh()
    try:
        j1 = JColdStartManager(url, MODEL, ECFG, mesh, work_dir=str(root / "boot1"))
        j1.acquire_params(lambda: jparams)
        assert j1.maybe_publish(jparams) is True
        j2 = JColdStartManager(url, MODEL, ECFG, mesh, work_dir=str(root / "boot2"))
        j2.acquire_params(lambda: jparams)
        assert j2.tracker.restored
        yield url, j1, j2
    finally:
        with contextlib.suppress(Exception):
            jax.config.update("jax_compilation_cache_dir", None)


def test_publish_then_restore_round_trip(boots, jax_boots):
    _, _, mgr1, params1, mgr2, params2 = boots
    _, j1, j2 = jax_boots
    assert mgr1.fingerprint == mgr2.fingerprint
    assert params1 is not params2
    _bit_equal(params1, params2)
    assert mgr1.tracker.events == j1.tracker.events == ["absent", "published"]
    assert mgr2.tracker.events == j2.tracker.events == ["restored"]
    assert set(mgr1.tracker.phases) == set(j1.tracker.phases) == {"fetch", "load"}
    assert set(mgr2.tracker.phases) == set(j2.tracker.phases) == {"fetch", "restore"}
    assert (mgr1.tracker.restored, mgr2.tracker.restored) == (False, True)
    assert (PHASES, EVENTS) == (JPHASES, JEVENTS)
    # Restored boots never publish; the CPU has no kernel library.
    assert mgr2.maybe_publish(params2) is False
    assert mgr2.library_restored is None


@pytest.mark.parametrize("tree", ["f32", "bf16-tied", "int8"])
def test_native_checkpoint_round_trip(models, tmp_path, tree):
    """The tree params_from_numpy carries comes back bit for bit: every
    dtype, shape and stride, a tied lm_head as one tensor, int8 weights
    N-major (the kernel's layout) with their f32 scales."""
    _, _, tcfg, tparams = models
    if tree == "f32":
        params = tparams
    else:
        params = tl.init_params(dataclasses.replace(tcfg, dtype=torch.bfloat16),
                                torch.Generator().manual_seed(3), device="cpu")
        params["lm_head"] = params["embed"]
        if tree == "int8":
            params = quantize_params(params)
    save_native_checkpoint(str(tmp_path / "ckpt"), params)
    got = load_native_checkpoint(str(tmp_path / "ckpt"), "cpu")
    _bit_equal(params, got)
    if tree != "f32":
        assert got["lm_head"] is got["embed"]
    if tree == "int8":
        w8 = got["layers"]["wq"]["w8"]
        assert w8.dtype == torch.int8 and w8.transpose(-1, -2).is_contiguous()
        assert got["layers"]["wq"]["scale"].dtype == torch.float32
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["params.safetensors", "tree.json"]


class _RecordingClient(tstore.LocalDirClient):
    def __init__(self):
        super().__init__()
        self.puts = []

    def put_from_file(self, bucket, name, src_path):
        self.puts.append(name)
        super().put_from_file(bucket, name, src_path)


def test_manifest_last_and_partial_tree_absent(models, tmp_path):
    """MANIFEST.json is the last object uploaded; a tree without it (a
    publisher that died) reads `absent` and the boot loads in full."""
    _, _, tcfg, tparams = models
    url = f"file://{tmp_path}/bucket"
    client = _RecordingClient()
    store = tstore.SnapshotStore(url, client=client)
    mgr = ColdStartManager(url, MODEL, ECFG, "cpu", work_dir=str(tmp_path / "w1"), store=store)
    assert mgr.maybe_publish(mgr.acquire_params(lambda: tparams))
    assert client.puts[-1].endswith("/MANIFEST.json")
    assert [p for p in client.puts if p.endswith("MANIFEST.json")] == client.puts[-1:]
    prefix = client.puts[-1].rsplit("/", 1)[0]
    assert sorted(p[len(prefix) + 1:] for p in client.puts) == [
        "MANIFEST.json", "params/params.safetensors", "params/tree.json"]
    os.unlink(os.path.join("/", prefix, "MANIFEST.json"))
    other = _other_weights(tcfg)
    again = ColdStartManager(url, MODEL, ECFG, "cpu", work_dir=str(tmp_path / "w2"))
    assert again.acquire_params(lambda: other) is other
    assert again.tracker.events == ["absent"] and not again.tracker.restored
    assert "load" in again.tracker.phases and "restore" not in again.tracker.phases


def test_wrong_manifest_is_a_mismatch_then_full_load(boots, models, tmp_path):
    """A manifest under this boot's key that carries another fingerprint
    is never restored: `mismatch`, then the full load."""
    root, url, mgr1, *_ = boots
    _, _, tcfg, _ = models
    bucket = f"file://{tmp_path}/bucket"
    src = os.path.join(str(root), "bucket", MODEL, mgr1.fingerprint)
    tstore.upload_dir(src, f"{bucket}/{MODEL}/{mgr1.fingerprint}")
    man = os.path.join(str(tmp_path), "bucket", MODEL, mgr1.fingerprint, "MANIFEST.json")
    with open(man) as f:
        body = json.load(f)
    body["fingerprint"] = "0123456789abcdef"
    with open(man, "w") as f:
        json.dump(body, f)
    other = _other_weights(tcfg)
    mgr = ColdStartManager(bucket, MODEL, ECFG, "cpu", work_dir=str(tmp_path / "w"))
    assert mgr.acquire_params(lambda: other) is other
    assert mgr.tracker.events == ["mismatch"] and not mgr.tracker.restored
    jmgr = JColdStartManager(bucket, MODEL, ECFG, single_device_mesh(),
                             work_dir=str(tmp_path / "jw"))
    assert jmgr.fingerprint != mgr.fingerprint


def test_snapshots_never_cross_packages(boots, jax_boots, models, tmp_path):
    """The same model name and engine config: the JAX snapshot reads
    `absent` to the port and the port's reads `absent` to the JAX
    package. The fingerprint formula is the JAX one; only the device
    signature, which carries the port's tag, differs."""
    _, port_url, mgr1, *_ = boots
    jax_url, j1, _ = jax_boots
    _, jparams, tcfg, _ = models
    assert mgr1.fingerprint != j1.fingerprint
    sig = device_signature("cpu")
    assert sig[0] == PORT_TAG and f"torch={torch.__version__}" in sig
    assert f"kernels={_build.build_dir().name}" in sig
    assert mgr1.fingerprint == tstore.SnapshotStore.fingerprint(MODEL, ECFG, sig) \
        == jstore.SnapshotStore.fingerprint(MODEL, ECFG, sig)
    other = _other_weights(tcfg)
    port = ColdStartManager(jax_url, MODEL, ECFG, "cpu", work_dir=str(tmp_path / "p"))
    assert port.acquire_params(lambda: other) is other
    assert port.tracker.events == ["absent"]
    jmgr = JColdStartManager(port_url, MODEL, ECFG, single_device_mesh(),
                             work_dir=str(tmp_path / "j"))
    assert jmgr.acquire_params(lambda: jparams) is jparams
    assert jmgr.tracker.events == ["absent"]


def test_kernel_library_travels_in_the_snapshot(models, tmp_path, monkeypatch):
    """A boot that found a library publishes it under its hash; a boot
    whose build/ is empty restores it into place (renamed whole, no
    temporary left), where `_build.build` finds it without nvcc."""
    _, _, _, tparams = models
    url = f"file://{tmp_path}/bucket"
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build-a" / "kernels")
    lib = _build.build_dir() / _build.LIB_NAME
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"\x7fELF library bytes")
    assert _build.installed_library() == lib
    mgr = ColdStartManager(url, MODEL, ECFG, "cpu", work_dir=str(tmp_path / "w1"))
    assert mgr.maybe_publish(mgr.acquire_params(lambda: tparams))
    stored = tmp_path / "bucket" / MODEL / mgr.fingerprint / "kernels" / lib.parent.name
    assert (stored / _build.LIB_NAME).read_bytes() == lib.read_bytes()
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build-b" / "kernels")
    assert _build.installed_library() is None
    mgr2 = ColdStartManager(url, MODEL, ECFG, "cpu", work_dir=str(tmp_path / "w2"))
    mgr2.acquire_params(lambda: None)
    assert mgr2.tracker.events == ["restored"]
    assert mgr2.library_restored == str(_build.build_dir() / _build.LIB_NAME)
    assert _build.installed_library().read_bytes() == lib.read_bytes()
    assert _build.build() == _build.installed_library()  # found: no nvcc
    assert os.listdir(_build.build_dir()) == [_build.LIB_NAME]


def test_manager_raises_without_a_card(monkeypatch, tmp_path):
    """No device named: cuda, which raises without a card, as every
    entry point does; the restore too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        ColdStartManager("", MODEL, ECFG)
    with pytest.raises(NoCudaDevice):
        load_native_checkpoint(str(tmp_path))
    assert ColdStartManager("", MODEL, ECFG, "cpu").acquire_params(lambda: 7) == 7


# ---- streams ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_streams(models):
    jcfg, jparams, _, _ = models
    eng = JEngine("llama", jcfg, jparams, cfg=JEngineConfig(
        cache_dtype=jnp.float32, step_overlap="off", **ECFG),
        eos_token_ids=TOK.eos_token_ids)
    return {name: eng.generate(PROMPTS, JSamplingParams(**sp))
            for name, sp in SAMPLING.items()}


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_restored_streams_equal_full_load_and_jax(boots, models, jax_streams, sampling):
    _, _, _, params1, _, params2 = boots
    _, _, tcfg, _ = models
    streams = []
    for params in (params1, params2):
        eng = Engine("llama", tcfg, params, cfg=EngineConfig(cache_dtype=torch.float32, **ECFG),
                     eos_token_ids=TOK.eos_token_ids, device="cpu")
        streams.append(eng.generate(PROMPTS, SamplingParams(**SAMPLING[sampling])))
    assert streams[0] == streams[1] == jax_streams[sampling]
    assert all(len(s) > 0 for s in streams[1])


# ---- through main, then HTTP ------------------------------------------------------


HF = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 300,
      "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
      "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0,
      "max_position_embeddings": 512, "tie_word_embeddings": False}


def _write_checkpoint(path: str, seed: int) -> dict:
    """A llama checkpoint under Hugging Face names from port weights
    drawn from `seed`; returns the weights (bf16)."""
    cfg = tl.LlamaConfig.from_hf_dict(HF)
    p = tl.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    L = p["layers"]
    out = {"model.embed_tokens.weight": p["embed"], "model.norm.weight": p["final_norm"],
           "lm_head.weight": p["lm_head"]}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    for i in range(cfg.num_layers):
        out[f"model.layers.{i}.input_layernorm.weight"] = L["input_norm"][i]
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = L["post_attn_norm"][i]
        for leaf, hf in names.items():
            out[f"model.layers.{i}.{hf}.weight"] = L[leaf][i].T.contiguous()
    save_safetensors(path, out, HF)
    return p


class _Built(Exception):
    pass


@pytest.fixture(scope="module")
def main_boots(tmp_path_factory):
    """Three `main` boots over one file:// snapshot bucket, each stopped
    where it would start its server: (a) checkpoint A in full, publishing;
    (b) checkpoint B (other weights, the same config), which must restore
    A's tree; (c) checkpoint A with another engine config and
    --snapshot-no-publish: a miss and a full load that publishes nothing."""
    root = tmp_path_factory.mktemp("main-snap")
    ck = {name: str(root / name) for name in ("a", "b")}
    weights = {name: _write_checkpoint(path, seed) for (name, path), seed
               in zip(ck.items(), (1, 2))}
    url = f"file://{root}/bucket"
    common = ["--device", "cpu", "--max-seq-len", "128", "--served-model-name", "tiny",
              "--snapshot-url", url]
    runs = {"full": [ck["a"], "--num-slots", "2", "--snapshot-dir", str(root / "w1")],
            "restored": [ck["b"], "--num-slots", "2", "--snapshot-dir", str(root / "w2")],
            "missed": [ck["a"], "--num-slots", "3", "--snapshot-dir", str(root / "w3"),
                       "--snapshot-no-publish"]}
    built = {}
    with pytest.MonkeyPatch.context() as mp:
        for label, argv in runs.items():
            def capture(engine, tokenizer, name, _label=label, **kw):
                built[_label] = (engine, tokenizer, name, kw)
                raise _Built

            mp.setattr(server_mod, "EngineServer", capture)
            with pytest.raises(_Built):
                server_mod.main(["--model-url", *argv, *common])
    return root, weights, built


def test_main_boots_follow_the_snapshot(main_boots):
    root, weights, built = main_boots
    cold = {label: b[3]["cold_start"] for label, b in built.items()}
    assert [cold[k]["events"] for k in ("full", "restored", "missed")] == [
        ["absent", "published"], ["restored"], ["absent"]]
    assert cold["full"]["fingerprint"] == cold["restored"]["fingerprint"] \
        != cold["missed"]["fingerprint"]
    assert set(cold["restored"]["phases"]) == {"fetch", "restore", "compile", "warmup"}
    assert set(cold["missed"]["phases"]) == {"fetch", "load", "compile", "warmup"}
    # The restored boot serves A's tree, not the B checkpoint it named.
    embed = built["restored"][0].params["embed"]
    assert torch.equal(embed, weights["a"]["embed"])
    assert not torch.equal(embed, weights["b"]["embed"])
    keys = os.listdir(root / "bucket" / "tiny")
    assert keys == [cold["full"]["fingerprint"]]
    assert set(EVENTS) >= {e for c in cold.values() for e in c["events"]}


def _coldstart_series(text: str) -> dict:
    return {k: v for k, v in jregistry.parse_prometheus_text(text).items()
            if k[0].startswith(("kubeai_coldstart_", "kubeai_objstore_"))}


def test_main_boots_over_http_match_jax_names(main_boots, jax_boots):
    """Each boot's server over HTTP: the full and restored boots serve
    the same greedy text; `/v1/state.cold_start` is the boot's record and
    `/metrics` carries its cold-start and object-store series under the
    JAX server's names and labels (the JAX series from its own boots'
    records through the JAX EngineMetrics)."""
    _, _, built = main_boots
    _, j1, j2 = jax_boots
    want = {}
    for label, jmgr in (("full", j1), ("restored", j2)):
        snap = jmgr.tracker.snapshot()
        # The JAX main times these two around its warm-up generates.
        snap["phases"].update(compile=0.0, warmup=0.0)
        jm = JEngineMetrics()
        jm.record_coldstart(snap)
        want[label] = _coldstart_series(jm.registry.expose())
    texts = {}
    for label in ("full", "restored", "missed"):
        engine, tokenizer, name, kw = built[label]
        srv = EngineServer(engine, tokenizer, name, host="127.0.0.1", port=0,
                           cold_start=kw["cold_start"])
        srv.start()
        try:
            addr = f"127.0.0.1:{srv.port}"
            status, body = http_post(addr, "/v1/completions", {
                "model": "tiny", "prompt": "Hello, snapshots!", "max_tokens": 10,
                "temperature": 0})
            assert status == 200, body
            texts[label] = json.loads(body)["choices"][0]["text"]
            state = json.loads(http_get(addr, "/v1/state")[1])
            assert state["cold_start"] == kw["cold_start"]
            got = _coldstart_series(http_get(addr, "/metrics")[1].decode())
        finally:
            srv.stop()
        restored = 1.0 if label == "restored" else 0.0
        assert got[("kubeai_coldstart_restored", ())] == restored
        assert got[("kubeai_objstore_retries_total", ())] >= 0
        for ev in kw["cold_start"]["events"]:
            assert got[("kubeai_coldstart_snapshot_events_total", (("event", ev),))] == 1
        if label in want:
            assert set(got) == set(want[label]), label
    assert texts["full"] == texts["restored"] == texts["missed"]
    assert texts["full"]
