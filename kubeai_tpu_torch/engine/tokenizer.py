"""Tokenizer seam: Hugging Face tokenizers where `transformers` is
installed and the checkpoint carries one, a byte-level fallback
otherwise. Counterpart of kubeai_tpu/engine/tokenizer.py, copied.

Chat templating follows the tokenizer's own template when present
(`apply_chat_template`), else a minimal generic template: the engine
serves /v1/chat/completions either way.
"""

from __future__ import annotations

import logging
import os
from typing import Protocol, Sequence

logger = logging.getLogger(__name__)


class Tokenizer(Protocol):
    eos_token_ids: tuple[int, ...]

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    def apply_chat_template(self, messages: list[dict]) -> list[int]: ...


class ByteTokenizer:
    """Offline tokenizer: UTF-8 bytes + 256 as EOS. Vocab 257."""

    vocab_size = 257
    eos_token_ids = (256,)

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace"
        )

    def apply_chat_template(self, messages: list[dict]) -> list[int]:
        return self.encode(_generic_chat_text(messages))


class HFTokenizer:
    def __init__(self, model_dir: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(model_dir)
        eos = self._tok.eos_token_id
        ids = []
        if eos is not None:
            ids.append(int(eos))
        # Llama-3 end-of-turn token also terminates generation.
        for special in ("<|eot_id|>", "<|im_end|>", "<|end|>"):
            try:
                tid = self._tok.convert_tokens_to_ids(special)
                if tid is not None and tid >= 0 and tid not in ids:
                    ids.append(int(tid))
            except Exception:
                pass
        self.eos_token_ids = tuple(ids)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: list[dict]) -> list[int]:
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(
                messages, add_generation_prompt=True
            )
        return self.encode(_generic_chat_text(messages))


def _generic_chat_text(messages: list[dict]) -> str:
    parts = []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, list):
            content = " ".join(
                p.get("text", "") for p in content
                if isinstance(p, dict) and p.get("type") == "text"
            )
        parts.append(f"{m.get('role', 'user')}: {content}")
    parts.append("assistant:")
    return "\n".join(parts)


# Files of a Hugging Face tokenizer; a directory without any of them has
# none (some transformers versions build an empty one from config.json).
TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json",
)


def load_tokenizer(model_dir: str | None) -> Tokenizer:
    """The checkpoint's Hugging Face tokenizer, or ByteTokenizer when the
    directory has none or `transformers` is not installed. Logs which."""
    if not (model_dir and os.path.isdir(model_dir)):
        logger.info("tokenizer: ByteTokenizer (no model directory)")
        return ByteTokenizer()
    if not any(os.path.exists(os.path.join(model_dir, f)) for f in TOKENIZER_FILES):
        logger.info("tokenizer: ByteTokenizer (no tokenizer files in %s)", model_dir)
        return ByteTokenizer()
    try:
        tok = HFTokenizer(model_dir)
    except Exception as e:
        logger.info("tokenizer: ByteTokenizer (no Hugging Face tokenizer in %s: %s)",
                    model_dir, type(e).__name__)
        return ByteTokenizer()
    logger.info("tokenizer: Hugging Face tokenizer from %s", model_dir)
    return tok

