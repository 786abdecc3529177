"""Whisper encoder-decoder: the SpeechToText feature.
Counterpart of kubeai_tpu/models/whisper.py.

A log-mel frontend (numpy, as in the JAX package), a conv-downsampled
transformer encoder, and a causal decoder with cross-attention, decoded
greedily. Transcription is not served by the slot engine: the greedy
loop re-runs the decoder over the growing sequence, as the JAX version
does (a KV-cached decoder is a later speed item, ROADMAP B).

Parameters are a plain dict with the JAX package's nested layout (lists
of layer dicts; the convs' kernels as [k, in, out]), so the tests carry
one tree across (kubeai_tpu_torch.parity.whisper_params_from_numpy).
They are f32, as the checkpoint loader makes them. Attention is plain
torch (matmul and softmax), as the JAX version's is plain jnp: no Pallas
kernel serves Whisper, so none is ported.

One departure from the JAX version (ROADMAP fault C12): the encoder's
second conv (kernel 3, stride 2) pads one frame on each side, as Hugging
Face's WhisperEncoder and OpenAI's Whisper do. The JAX version's
padding="SAME" pads none on the left at an even frame count, so each of
its encoder frames reads the window one input frame later.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from kubeai_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_heads: int = 6
    decoder_layers: int = 4
    decoder_heads: int = 6
    ffn_dim: int = 1536
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257
    dtype: Any = torch.float32

    @staticmethod
    def from_hf_dict(d: dict) -> "WhisperConfig":
        return WhisperConfig(
            vocab_size=d["vocab_size"],
            num_mel_bins=d.get("num_mel_bins", 80),
            d_model=d["d_model"],
            encoder_layers=d["encoder_layers"],
            encoder_heads=d["encoder_attention_heads"],
            decoder_layers=d["decoder_layers"],
            decoder_heads=d["decoder_attention_heads"],
            ffn_dim=d.get("encoder_ffn_dim", 4 * d["d_model"]),
            max_source_positions=d.get("max_source_positions", 1500),
            max_target_positions=d.get("max_target_positions", 448),
            decoder_start_token_id=d.get("decoder_start_token_id", 50258),
            eos_token_id=d.get("eos_token_id", 50257),
        )

    @staticmethod
    def tiny(vocab_size: int = 256) -> "WhisperConfig":
        return WhisperConfig(
            vocab_size=vocab_size,
            num_mel_bins=16,
            d_model=32,
            encoder_layers=2,
            encoder_heads=2,
            decoder_layers=2,
            decoder_heads=2,
            ffn_dim=64,
            max_source_positions=50,
            max_target_positions=32,
            decoder_start_token_id=1,
            eos_token_id=2,
        )


# ---- audio frontend ---------------------------------------------------------

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160


def _mel_filterbank(n_mels: int, n_fft: int = N_FFT, sr: int = SAMPLE_RATE):
    """Slaney-style mel filterbank (numpy, no deps)."""
    fmin, fmax = 0.0, sr / 2

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, c, hi = bins[i], bins[i + 1], bins[i + 2]
        if c > lo:
            fb[i, lo:c] = (np.arange(lo, c) - lo) / (c - lo)
        if hi > c:
            fb[i, c:hi] = (hi - np.arange(c, hi)) / (hi - c)
    return fb


def log_mel_spectrogram(
    audio: np.ndarray, n_mels: int = 80, max_frames: int | None = None
) -> np.ndarray:
    """float32 PCM [-1, 1] @ 16 kHz -> [n_mels, T] log-mel features."""
    window = np.hanning(N_FFT + 1)[:-1]
    n = len(audio)
    frames = max(1, 1 + (n - N_FFT) // HOP) if n >= N_FFT else 1
    padded = np.pad(audio, (0, max(0, N_FFT + frames * HOP - n)))
    stft = np.stack(
        [
            np.fft.rfft(padded[i * HOP : i * HOP + N_FFT] * window)
            for i in range(frames)
        ],
        axis=1,
    )
    power = np.abs(stft) ** 2
    mel = _mel_filterbank(n_mels) @ power
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    if max_frames is not None:
        if log_spec.shape[1] < max_frames:
            log_spec = np.pad(
                log_spec, ((0, 0), (0, max_frames - log_spec.shape[1]))
            )
        else:
            log_spec = log_spec[:, :max_frames]
    return log_spec.astype(np.float32)


def decode_wav(data: bytes) -> np.ndarray:
    """WAV bytes -> mono float32 PCM (resampled to 16 kHz by linear
    interpolation; stdlib only)."""
    import io
    import wave

    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}.get(width)
    if dtype is None:
        raise ValueError(f"unsupported WAV sample width {width}")
    pcm = np.frombuffer(raw, dtype).astype(np.float32)
    pcm /= float(np.iinfo(dtype).max)
    if ch > 1:
        pcm = pcm.reshape(-1, ch).mean(axis=1)
    if sr != SAMPLE_RATE:
        t_new = np.linspace(0, len(pcm) - 1, int(len(pcm) * SAMPLE_RATE / sr))
        pcm = np.interp(t_new, np.arange(len(pcm)), pcm).astype(np.float32)
    return pcm


# ---- parameters -------------------------------------------------------------


def init_params(
    cfg: WhisperConfig,
    generator: torch.Generator | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Random init (tests and the smoke), drawn from `generator`, which
    must live on the target device (default: one on that device seeded
    with 0). The target device defaults to cuda."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dt = cfg.dtype
    E, F_ = cfg.d_model, cfg.ffn_dim

    def rnd(shape, scale=0.05):
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dt)

    def zeros(n):
        return torch.zeros((n,), dtype=dt, device=dev)

    def attn_block():
        return {
            "wq": rnd((E, E)), "bq": zeros(E),
            "wk": rnd((E, E)),
            "wv": rnd((E, E)), "bv": zeros(E),
            "wo": rnd((E, E)), "bo": zeros(E),
        }

    def ln():
        return {"w": torch.ones((E,), dtype=dt, device=dev), "b": zeros(E)}

    def ffn():
        return {"w1": rnd((E, F_)), "b1": zeros(F_), "w2": rnd((F_, E)), "b2": zeros(E)}

    return {
        "conv1_w": rnd((3, cfg.num_mel_bins, E)),
        "conv1_b": zeros(E),
        "conv2_w": rnd((3, E, E)),
        "conv2_b": zeros(E),
        "enc_pos": rnd((cfg.max_source_positions, E), 0.02),
        "enc_layers": [
            {"ln1": ln(), "attn": attn_block(), "ln2": ln(), "ffn": ffn()}
            for _ in range(cfg.encoder_layers)
        ],
        "enc_ln": ln(),
        "dec_embed": rnd((cfg.vocab_size, E), 0.02),
        "dec_pos": rnd((cfg.max_target_positions, E), 0.02),
        "dec_layers": [
            {"ln1": ln(), "self_attn": attn_block(), "ln2": ln(),
             "cross_attn": attn_block(), "ln3": ln(), "ffn": ffn()}
            for _ in range(cfg.decoder_layers)
        ],
        "dec_ln": ln(),
    }


# ---- model ------------------------------------------------------------------


def _layer_norm(x, p):
    """LayerNorm in f32 (the biased variance, eps 1e-5), as the JAX
    version computes it; one fused kernel on the card."""
    return F.layer_norm(x.float(), x.shape[-1:], p["w"].float(), p["b"].float(),
                        1e-5).to(x.dtype)


def _mha(q_x, kv_x, p, heads, causal=False):
    E = q_x.shape[-1]
    D = E // heads
    q = (q_x @ p["wq"] + p["bq"]).reshape(*q_x.shape[:-1], heads, D)
    k = (kv_x @ p["wk"]).reshape(*kv_x.shape[:-1], heads, D)
    v = (kv_x @ p["wv"] + p["bv"]).reshape(*kv_x.shape[:-1], heads, D)
    # [B, H, Sq, D] x [B, H, D, Sk]
    logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * (D ** -0.5)
    if causal:
        Sq, Sk = q_x.shape[1], kv_x.shape[1]
        dev = q_x.device
        mask = (torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
                >= torch.arange(Sk, device=dev)[None, :])
        logits = torch.where(mask[None, None], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits.float(), dim=-1).to(q_x.dtype)
    out = torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)  # [B, Sq, H, D]
    return out.reshape(*q_x.shape[:-1], E) @ p["wo"] + p["bo"]


def _ffn(x, p):
    return F.gelu(x @ p["w1"] + p["b1"], approximate="none") @ p["w2"] + p["b2"]


def _conv3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """A kernel-3 conv over time, padding one frame on each side: x [B, in,
    T], w [3, in, out] (the JAX layout) -> [B, out, (T - 1) // stride + 1].
    cuDNN runs f32 convolutions in TF32 by default; with TF32 off the card
    computes what the CPU computes."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv1d(x, w.permute(2, 1, 0), b, stride=stride, padding=1)


def _conv_stack(params: dict, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, n_mels, T] -> [B, ceil(T / 2), E]: two GELU convs of kernel
    3, strides 1 and 2, each padding one frame on each side, as Hugging
    Face's and OpenAI's Whisper do (module docstring)."""
    x = mel.to(params["conv1_w"].dtype)
    x = F.gelu(_conv3(x, params["conv1_w"], params["conv1_b"], 1), approximate="none")
    x = F.gelu(_conv3(x, params["conv2_w"], params["conv2_b"], 2), approximate="none")
    return x.transpose(1, 2)


def _encoder_layers(params: dict, cfg: WhisperConfig, x: torch.Tensor) -> torch.Tensor:
    """The conv stack's output [B, T', E] -> encoder states: positions,
    the encoder layers, the final norm."""
    x = x + params["enc_pos"][: x.shape[1]]
    for lp in params["enc_layers"]:
        h = _layer_norm(x, lp["ln1"])
        x = x + _mha(h, h, lp["attn"], cfg.encoder_heads)
        h = _layer_norm(x, lp["ln2"])
        x = x + _ffn(h, lp["ffn"])
    return _layer_norm(x, params["enc_ln"])


def encode(params: dict, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: [B, n_mels, T] -> encoder states [B, ceil(T / 2), E]."""
    return _encoder_layers(params, cfg, _conv_stack(params, mel))


def _decoder_states(params, cfg, tokens, enc):
    """tokens [B, S] + encoder states -> final decoder states [B, S, E]."""
    x = params["dec_embed"][tokens] + params["dec_pos"][: tokens.shape[1]]
    for lp in params["dec_layers"]:
        h = _layer_norm(x, lp["ln1"])
        x = x + _mha(h, h, lp["self_attn"], cfg.decoder_heads, causal=True)
        h = _layer_norm(x, lp["ln2"])
        x = x + _mha(h, enc, lp["cross_attn"], cfg.decoder_heads)
        h = _layer_norm(x, lp["ln3"])
        x = x + _ffn(h, lp["ffn"])
    return _layer_norm(x, params["dec_ln"])


def _logits(x, embed):
    return torch.matmul(x.float(), embed.float().t())


def decoder_logits(
    params: dict, cfg: WhisperConfig, tokens: torch.Tensor, enc: torch.Tensor
) -> torch.Tensor:
    """tokens [B, S] + encoder states -> f32 logits [B, S, V] (the full
    forward; tied to the token embedding)."""
    return _logits(_decoder_states(params, cfg, tokens, enc), params["dec_embed"])


@torch.no_grad()
def transcribe_tokens(
    params: dict,
    cfg: WhisperConfig,
    mel: np.ndarray,  # [n_mels, T]
    max_tokens: int = 0,
) -> list[int]:
    """Greedy decode on the parameters' device; returns the generated
    token ids (without the start token). Each step re-runs the decoder
    over the whole sequence and takes the last row's logits."""
    max_tokens = max_tokens or (cfg.max_target_positions - 1)
    dev = params["dec_embed"].device
    enc = encode(params, cfg, torch.from_numpy(np.asarray(mel, np.float32))[None].to(dev))
    tokens = [cfg.decoder_start_token_id]
    out: list[int] = []
    for _ in range(max_tokens):
        if len(tokens) >= cfg.max_target_positions:
            break
        x = _decoder_states(params, cfg, torch.tensor([tokens], device=dev), enc)
        tok = int(torch.argmax(_logits(x[0, -1], params["dec_embed"])))
        if tok == cfg.eos_token_id:
            break
        tokens.append(tok)
        out.append(tok)
    return out
