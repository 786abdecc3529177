"""Tokenizer seam. Counterpart of kubeai_tpu/engine/tokenizer.py.

The byte-level tokenizer and the generic chat template are copied from
the JAX package. The HuggingFace tokenizer waits for the slice that loads
real weights.
"""

from __future__ import annotations

from typing import Protocol, Sequence


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
