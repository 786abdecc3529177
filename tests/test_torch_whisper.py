"""Whisper (the SpeechToText feature) in kubeai_tpu_torch, on the CPU in
f32, against Hugging Face's WhisperForConditionalGeneration and the JAX
package.

The model is the JAX test's tiny HF config (tests/unit/test_whisper.py)
with every weight redrawn at std 0.3 and every bias at 0.1: at HF's
std-0.02 init the encoder's outputs are too small for its conv padding to
show.

- The audio frontend: `decode_wav` and `log_mel_spectrogram` equal the
  JAX functions' arrays (8-, 16- and 32-bit, mono and stereo, 8, 16 and
  22.05 kHz).
- The encoder: the conv stack and `encode` within 1e-4 of HF's
  WhisperEncoder. This is where the port departs from the JAX package
  (ROADMAP fault C12): the JAX encoder's stride-2 conv pads "SAME", one
  frame later than HF's, and fails the same check.
- Past the convs, against JAX at 1e-4: the encoder layers (through the
  JAX package's own `_layer_norm`, `_mha` and `_ffn`) on the same conv
  output, `decoder_logits` on the same encoder states (and HF's decoder),
  and `transcribe_tokens` token-equal to the JAX function's on the same
  encoder states (8 tokens) and to HF's greedy loop.
- The loader: a checkpoint saved by HF loads bit-equal to the JAX
  loader's tree; `whisper_hf_tensors` writes one that HF loads and that
  reads back bit-equal.
- The transcription server against the JAX server over the same weights
  (conv2's kernel zeroed on both sides, so their encoders agree despite
  C12): every route's status and body, the 404s and 400s, and /metrics;
  with tokenizer files, the same text through `load_tokenizer`'s
  HFTokenizer as through the JAX server's AutoTokenizer.
- `main`'s SpeechToText branch: `python -m kubeai_tpu_torch.engine.server
  --device cpu` on a whisper checkpoint serves the in-process token ids
  as text (no tokenizer files: ids), and SIGINT stops it with exit 0.
"""

import dataclasses
import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeai_tpu.engine import weights as jweights
from kubeai_tpu.engine.whisper_server import TranscriptionServer as JTranscriptionServer
from kubeai_tpu.metrics import registry as jregistry
from kubeai_tpu.models import whisper as jw
from kubeai_tpu_torch.engine import weights
from kubeai_tpu_torch.engine.whisper_server import TranscriptionServer, parse_multipart
from kubeai_tpu_torch.metrics import registry as tregistry
from kubeai_tpu_torch.models import whisper as tw
from kubeai_tpu_torch.parity import whisper_params_from_numpy

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HF_CONFIG = dict(
    vocab_size=128, num_mel_bins=16, d_model=32, encoder_layers=2,
    encoder_attention_heads=2, decoder_layers=2, decoder_attention_heads=2,
    encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=32,
    max_target_positions=32, decoder_start_token_id=1, eos_token_id=2, pad_token_id=0,
)
FRAMES = 2 * HF_CONFIG["max_source_positions"]  # HF's encoder takes exactly this


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side runs many tiny ops: one intra-op thread keeps them
    from spinning against the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """(checkpoint dir, HF model, port config, port params, JAX params)."""
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(HFWhisperConfig(**HF_CONFIG)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_norm" in name:
                continue
            p.copy_(torch.randn(p.shape, generator=gen) * (0.3 if p.dim() > 1 else 0.1))
    d = str(tmp_path_factory.mktemp("hf-whisper"))
    model.save_pretrained(d, safe_serialization=True)
    cfg = tw.WhisperConfig.from_hf_dict(weights.load_hf_config(d))
    params = weights.load_params("whisper", d, cfg, dtype=torch.float32, device="cpu")
    jcfg = jw.WhisperConfig.from_hf_dict(jweights.load_hf_config(d))
    jparams = jweights.load_whisper_params(d, jcfg, dtype=jnp.float32)
    return d, model, cfg, params, jparams


def _mel(seed: int, frames: int = FRAMES) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (HF_CONFIG["num_mel_bins"], frames)).astype(np.float32)


def _wav(seconds: float, sr: int = 16000, channels: int = 1, width: int = 2,
         freq: float = 440.0) -> bytes:
    t = np.arange(int(seconds * sr)) / sr
    tone = np.sin(2 * np.pi * freq * t) * 0.5 + 0.1 * np.sin(2 * np.pi * 3 * freq * t)
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    pcm = (np.repeat(tone[:, None], channels, 1) * np.iinfo(dtype).max).astype(dtype)
    buf = io.BytesIO()
    with wave.open(buf, "w") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


# ---- the audio frontend -----------------------------------------------------------


@pytest.mark.parametrize("sr,channels,width", [
    (8000, 1, 2), (16000, 2, 2), (16000, 1, 4), (22050, 1, 1)])
def test_decode_wav_and_log_mel_match_jax(sr, channels, width):
    data = _wav(0.7, sr, channels, width)
    pcm = tw.decode_wav(data)
    np.testing.assert_array_equal(pcm, jw.decode_wav(data))
    for n_mels, max_frames in ((80, 3000), (16, 64), (16, None)):
        np.testing.assert_array_equal(
            tw.log_mel_spectrogram(pcm, n_mels, max_frames),
            jw.log_mel_spectrogram(pcm, n_mels, max_frames))


# ---- the encoder: HF's convs, JAX's layers -----------------------------------------


def _hf_conv_stack(model, mel: np.ndarray) -> np.ndarray:
    enc = model.model.encoder
    x = torch.from_numpy(mel)[None]
    with torch.no_grad():
        x = torch.nn.functional.gelu(enc.conv1(x))
        x = torch.nn.functional.gelu(enc.conv2(x))
    return x.transpose(1, 2).numpy()


def test_encoder_matches_hf_where_jax_departs(hf):
    """The conv stack and the encoder within 1e-4 of HF's; the JAX
    encoder, whose stride-2 conv pads one frame later (fault C12), is far
    outside it on the same weights."""
    _, model, cfg, params, jparams = hf
    mel = _mel(2)
    with torch.no_grad():
        got_conv = tw._conv_stack(params, torch.from_numpy(mel)[None])
        got = tw.encode(params, cfg, torch.from_numpy(mel)[None])
        want = model.model.encoder(torch.from_numpy(mel)[None]).last_hidden_state
    np.testing.assert_allclose(got_conv.numpy(), _hf_conv_stack(model, mel), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    jax_enc = np.asarray(jw.encode(jparams, jw.WhisperConfig.from_hf_dict(HF_CONFIG),
                                   jnp.asarray(mel[None])))
    assert np.abs(jax_enc - want.numpy()).max() > 100 * ATOL


def _jax_encoder_layers(jparams, jcfg, x):
    """kubeai_tpu/models/whisper.py::encode past its convs, through the
    JAX package's own layer functions."""
    x = x + jparams["enc_pos"][: x.shape[1]]
    for lp in jparams["enc_layers"]:
        h = jw._layer_norm(x, lp["ln1"])
        x = x + jw._mha(h, h, lp["attn"], jcfg.encoder_heads)
        h = jw._layer_norm(x, lp["ln2"])
        x = x + jw._ffn(h, lp["ffn"])
    return jw._layer_norm(x, jparams["enc_ln"])


def test_encoder_layers_match_jax(hf):
    _, _, cfg, params, jparams = hf
    with torch.no_grad():
        conv = tw._conv_stack(params, torch.from_numpy(_mel(3))[None])
        got = tw._encoder_layers(params, cfg, conv)
    want = _jax_encoder_layers(jparams, jw.WhisperConfig.from_hf_dict(HF_CONFIG),
                               jnp.asarray(conv.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _enc_states(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (1, HF_CONFIG["max_source_positions"], HF_CONFIG["d_model"])).astype(np.float32)


def test_decoder_logits_match_jax_and_hf(hf):
    _, model, cfg, params, jparams = hf
    enc = _enc_states(4)
    tokens = np.array([[1, 5, 9, 11, 3, 70]], np.int64)
    with torch.no_grad():
        got = tw.decoder_logits(params, cfg, torch.from_numpy(tokens), torch.from_numpy(enc))
        hf_states = model.model.decoder(input_ids=torch.from_numpy(tokens),
                                        encoder_hidden_states=torch.from_numpy(enc))
        want_hf = model.proj_out(hf_states.last_hidden_state)
    want = jw.decoder_logits(jparams, jw.WhisperConfig.from_hf_dict(HF_CONFIG),
                             jnp.asarray(tokens.astype(np.int32)), jnp.asarray(enc))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 6, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_hf.numpy(), atol=ATOL, rtol=0)


def test_transcribe_tokens_match_jax_on_the_same_encoder_states(hf, monkeypatch):
    _, _, cfg, params, jparams = hf
    enc = _enc_states(5)
    monkeypatch.setattr(tw, "encode", lambda p, c, mel: torch.from_numpy(enc))
    monkeypatch.setattr(jw, "encode", lambda p, c, mel: jnp.asarray(enc))
    mel = _mel(6)
    got = tw.transcribe_tokens(params, cfg, mel, max_tokens=8)
    want = jw.transcribe_tokens(jparams, jw.WhisperConfig.from_hf_dict(HF_CONFIG), mel,
                                max_tokens=8)
    assert got == want and len(set(got)) > 1


def test_transcribe_tokens_match_hf_greedy(hf):
    """The port's greedy loop against a plain HF one (hf.generate adds
    suppress-token processors that are not raw greedy decoding)."""
    _, model, cfg, params, _ = hf
    mel = _mel(7)
    got = tw.transcribe_tokens(params, cfg, mel, max_tokens=8)
    tokens, want = [cfg.decoder_start_token_id], []
    with torch.no_grad():
        for _ in range(8):
            logits = model(input_features=torch.from_numpy(mel)[None],
                           decoder_input_ids=torch.tensor([tokens])).logits[0, -1]
            tok = int(logits.argmax())
            if tok == cfg.eos_token_id:
                break
            tokens.append(tok)
            want.append(tok)
    assert got == want and len(got) > 0


# ---- the loader -------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def test_loader_matches_jax_and_writer_round_trips(hf, tmp_path):
    from transformers import WhisperForConditionalGeneration

    d, model, cfg, params, jparams = hf
    got, want = dict(_leaves(params)), dict(_leaves(jparams))
    # 11 top-level leaves, 15 an encoder layer, 24 a decoder layer.
    assert set(got) == set(want) and len(got) == 11 + 15 * 2 + 24 * 2
    for name, t in got.items():
        w = np.asarray(want[name])
        assert t.dtype == torch.float32 and tuple(t.shape) == w.shape, name
        assert np.array_equal(t.numpy(), w), name
    # The writer's names and layouts are HF's: HF loads the written
    # checkpoint into the same state, and the loader reads it back.
    out = str(tmp_path / "written")
    weights.save_safetensors(out, weights.whisper_hf_tensors(params, cfg),
                             {"architectures": ["WhisperForConditionalGeneration"],
                              **HF_CONFIG})
    back = weights.load_params("whisper", out, cfg, dtype=torch.float32, device="cpu")
    for name, t in _leaves(back):
        assert torch.equal(t, got[name]), name
    reloaded = WhisperForConditionalGeneration.from_pretrained(out).eval()
    theirs = model.state_dict()
    for name, t in reloaded.state_dict().items():
        assert torch.equal(t, theirs[name]), name


# ---- the transcription server -----------------------------------------------------


@pytest.fixture(scope="module")
def transcription_servers():
    """(JAX server, port server) over the JAX tiny init, conv2's kernel
    zeroed (its bias drawn), at most 8 decoded tokens."""
    cfg = dataclasses.replace(jw.WhisperConfig.tiny(), max_target_positions=9)
    tree = jax.tree.map(np.asarray, jw.init_params(cfg, jax.random.PRNGKey(2)))
    tree["conv2_w"] = np.zeros_like(tree["conv2_w"])
    tree["conv2_b"] = np.random.default_rng(3).normal(0, 1, tree["conv2_b"].shape).astype(
        np.float32)
    tcfg = dataclasses.replace(tw.WhisperConfig.tiny(), max_target_positions=9)
    jsrv = JTranscriptionServer(jax.tree.map(jnp.asarray, tree), cfg, "whisper-tiny",
                                host="127.0.0.1", port=0)
    tsrv = TranscriptionServer(whisper_params_from_numpy(tree, "cpu"), tcfg, "whisper-tiny",
                               host="127.0.0.1", port=0)
    jsrv.start()
    tsrv.start()
    yield jsrv, tsrv
    tsrv.stop()
    jsrv.stop()


def _multipart(fields: dict, boundary: str = "XBOUND") -> tuple[bytes, str]:
    body = b"".join(
        (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
         f"filename=\"a.wav\"\r\nContent-Type: audio/wav\r\n\r\n").encode() + data + b"\r\n"
        for name, data in fields.items())
    return body + f"--{boundary}--\r\n".encode(), f'multipart/form-data; boundary="{boundary}"'


def _request(port: int, method: str, path: str, body: bytes = b"",
             content_type: str | None = None) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    headers = {"Content-Type": content_type} if content_type else {}
    conn.request(method, path, body=body or None, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


SERVER_CASES = {
    "tone": ("POST", "/v1/audio/transcriptions", *_multipart({"file": _wav(0.5)})),
    "stereo-8k": ("POST", "/v1/audio/transcriptions",
                  *_multipart({"file": _wav(0.3, 8000, 2, 2, 300.0), "model": b"w"})),
    "no-file": ("POST", "/v1/audio/transcriptions", *_multipart({"model": b"whisper"})),
    "no-boundary": ("POST", "/v1/audio/transcriptions", b"x", "multipart/form-data"),
    "not-wav": ("POST", "/v1/audio/transcriptions", *_multipart({"file": b"RIFX-nope"})),
    "other-post": ("POST", "/v1/chat/completions", b"{}", "application/json"),
    "health": ("GET", "/health", b"", None),
    "models": ("GET", "/v1/models", b"", None),
    "other-get": ("GET", "/nope", b"", None),
}


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_transcription_server_matches_jax(transcription_servers, case):
    method, path, body, ctype = SERVER_CASES[case]
    jsrv, tsrv = transcription_servers
    js, jbody = _request(jsrv.port, method, path, body, ctype)
    ts_, tbody = _request(tsrv.port, method, path, body, ctype)
    assert ts_ == js
    assert json.loads(tbody) == json.loads(jbody)
    if case == "tone":
        assert ts_ == 200 and json.loads(tbody)["text"]


def test_transcription_metrics_match_jax(transcription_servers):
    jsrv, tsrv = transcription_servers
    body, ctype = _multipart({"file": _wav(0.25, freq=200.0)})
    parsed = []
    for srv, registry in ((jsrv, jregistry), (tsrv, tregistry)):
        assert _request(srv.port, "POST", "/v1/audio/transcriptions", body, ctype)[0] == 200
        status, text = _request(srv.port, "GET", "/metrics")
        assert status == 200
        parsed.append(registry.parse_prometheus_text(text.decode()))
    assert parsed[1] == parsed[0]
    assert parsed[1][("kubeai_engine_requests_total", (("model", "whisper-tiny"),))] >= 1


def test_transcription_text_through_a_tokenizer_matches_jax(transcription_servers, tmp_path):
    """Tokenizer files beside the weights: the port's server decodes through
    `load_tokenizer`'s HFTokenizer, the JAX server through AutoTokenizer
    with skip_special_tokens, to the same text."""
    from tokenizers import Tokenizer as RawTokenizer
    from tokenizers import models, pre_tokenizers
    from transformers import AutoTokenizer, PreTrainedTokenizerFast

    from kubeai_tpu_torch.engine.tokenizer import HFTokenizer, load_tokenizer

    jsrv0, tsrv0 = transcription_servers
    names = ["<pad>", "<|startoftranscript|>", "<|endoftext|>"]
    names += [f"w{i}" for i in range(len(names), tsrv0.cfg.vocab_size)]
    raw = RawTokenizer(models.WordLevel({n: i for i, n in enumerate(names)}, unk_token="<pad>"))
    raw.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    PreTrainedTokenizerFast(
        tokenizer_object=raw, unk_token="<pad>", bos_token="<|startoftranscript|>",
        eos_token="<|endoftext|>",
    ).save_pretrained(tmp_path)
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, HFTokenizer)
    jsrv = JTranscriptionServer(jsrv0.params, jsrv0.cfg, "whisper-tiny",
                                tokenizer=AutoTokenizer.from_pretrained(tmp_path),
                                host="127.0.0.1", port=0)
    tsrv = TranscriptionServer(tsrv0.params, tsrv0.cfg, "whisper-tiny", tokenizer=tok,
                               host="127.0.0.1", port=0)
    jsrv.start()
    tsrv.start()
    try:
        body, ctype = _multipart({"file": _wav(0.5)})
        js, jbody = _request(jsrv.port, "POST", "/v1/audio/transcriptions", body, ctype)
        ts_, tbody = _request(tsrv.port, "POST", "/v1/audio/transcriptions", body, ctype)
    finally:
        tsrv.stop()
        jsrv.stop()
    assert ts_ == js == 200
    assert json.loads(tbody) == json.loads(jbody)
    assert json.loads(tbody)["text"].startswith("w")


def test_parse_multipart_matches_jax():
    from kubeai_tpu.engine.whisper_server import parse_multipart as jparse

    body, ctype = _multipart({"file": b"\x00\x01 data -\r\n", "model": b"whisper-1"}, "b-1")
    assert parse_multipart(body, ctype) == jparse(body, ctype)
    for ctype in ("multipart/form-data", "text/plain"):
        with pytest.raises(ValueError, match="missing multipart boundary"):
            parse_multipart(body, ctype)


# ---- main's SpeechToText branch --------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_serves_whisper_on_cpu(tmp_path):
    cfg = dataclasses.replace(tw.WhisperConfig.tiny(), max_target_positions=9)
    params = tw.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    hf_cfg = {"architectures": ["WhisperForConditionalGeneration"],
              "vocab_size": cfg.vocab_size, "num_mel_bins": cfg.num_mel_bins,
              "d_model": cfg.d_model, "encoder_layers": cfg.encoder_layers,
              "encoder_attention_heads": cfg.encoder_heads,
              "decoder_layers": cfg.decoder_layers,
              "decoder_attention_heads": cfg.decoder_heads, "encoder_ffn_dim": cfg.ffn_dim,
              "max_source_positions": cfg.max_source_positions,
              "max_target_positions": cfg.max_target_positions,
              "decoder_start_token_id": 1, "eos_token_id": 2}
    weights.save_safetensors(str(tmp_path), weights.whisper_hf_tensors(params, cfg), hf_cfg)
    wav = _wav(0.4, freq=500.0)
    mel = tw.log_mel_spectrogram(tw.decode_wav(wav), cfg.num_mel_bins,
                                 2 * cfg.max_source_positions)
    want = " ".join(str(i) for i in tw.transcribe_tokens(params, cfg, mel))
    port = _free_port()
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeai_tpu_torch.engine.server", "--model-url",
         str(tmp_path), "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         "--served-model-name", "whisper-tiny"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                if _request(port, "GET", "/health")[0] == 200:
                    break
            except OSError:
                pass
            if proc.poll() is not None or time.monotonic() > deadline:
                pytest.fail(f"server did not come up: {proc.stdout.read().decode()[-2000:]}")
            time.sleep(0.2)
        status, body = _request(port, "POST", "/v1/audio/transcriptions",
                                *_multipart({"file": wav}))
        assert status == 200 and json.loads(body) == {"text": want}
        status, body = _request(port, "GET", "/v1/models")
        assert json.loads(body)["data"][0]["id"] == "whisper-tiny"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
