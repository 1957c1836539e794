"""Byte-level tokenizer and incremental stream decoder.

Trimmed copy of ``gofr_tpu/tokenizer.py``: ``TOKENIZER=byte`` gives one id
per byte (0..255) with the specials <pad>, <bos>, <eos> above them. BPE
merge files and HF ``tokenizer.json`` are not ported yet.
"""

from __future__ import annotations

import codecs
from typing import Optional

SPECIAL_TOKENS = ("<pad>", "<bos>", "<eos>")


class Tokenizer:
    def __init__(self, n_special: int = len(SPECIAL_TOKENS)):
        self.n_special = n_special

    @classmethod
    def byte_level(cls, n_special: int = len(SPECIAL_TOKENS)) -> "Tokenizer":
        return cls(n_special)

    def special_id(self, name: str) -> int:
        idx = SPECIAL_TOKENS.index(f"<{name}>")
        if idx >= self.n_special:
            raise ValueError(f"tokenizer has no <{name}> (n_special={self.n_special})")
        return 256 + idx

    def encode(self, text: str | bytes) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return list(data)

    def decode_bytes(self, ids: list[int]) -> bytes:
        return bytes(i for i in ids if 0 <= i < 256)

    def decode(self, ids: list[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def stream_decoder(self) -> "StreamDecoder":
        return StreamDecoder(self)


class StreamDecoder:
    """Feeds ids one at a time and emits text as soon as whole UTF-8
    sequences are available; a partial sequence stays buffered."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._dec = codecs.getincrementaldecoder("utf-8")(errors="replace")

    def feed(self, token_id: int) -> str:
        if not 0 <= token_id < 256:
            return ""  # special ids carry no bytes
        return self._dec.decode(bytes([token_id]))

    def flush(self) -> str:
        return self._dec.decode(b"", final=True)


def load_tokenizer(config) -> Optional[Tokenizer]:
    """``TOKENIZER=byte`` -> the byte tokenizer; otherwise None (id-only)."""
    if config.get_or_default("TOKENIZER", "") == "byte":
        return Tokenizer.byte_level()
    return None
