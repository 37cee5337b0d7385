"""Tokenizer wrapper with incremental (streaming) detokenization.

Wraps a HuggingFace ``tokenizer.json`` through the ``tokenizers`` binding.
The streaming decoder keeps prefix/read offsets so multi-token glyphs and
sentencepiece space markers render correctly as tokens trickle in.  The
counterpart of ``dynamo_tpu/llm/tokenizer.py``; a checkpoint that ships
only a sentencepiece ``tokenizer.model`` is not read yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

__all__ = ["TokenizerWrapper", "DecodeStream"]


class TokenizerWrapper:
    def __init__(self, tokenizer):
        self._tk = tokenizer

    @classmethod
    def from_file(cls, path: str | Path) -> "TokenizerWrapper":
        from tokenizers import Tokenizer

        p = Path(path)
        if p.is_dir():
            p = p / "tokenizer.json"
        if p.suffix == ".model" or not p.exists() and p.with_name("tokenizer.model").exists():
            raise NotImplementedError(
                f"{p}: sentencepiece tokenizer.model files are not read yet; "
                "the checkpoint needs a tokenizer.json")
        return cls(Tokenizer.from_file(str(p)))

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        return self._tk.encode(text, add_special_tokens=add_special_tokens).ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tk.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tk.token_to_id(token)

    def id_to_token(self, token_id: int) -> Optional[str]:
        return self._tk.id_to_token(token_id)

    def decode_stream(self, skip_special_tokens: bool = True) -> "DecodeStream":
        return DecodeStream(self, skip_special_tokens)


class DecodeStream:
    """Incremental detokenizer (vLLM-style prefix/read offsets).

    ``step(token_id)`` returns the new text produced by this token, or ""
    while the tokenizer is mid-glyph (e.g. partial UTF-8 from BPE bytes).
    """

    def __init__(self, tokenizer: TokenizerWrapper, skip_special_tokens: bool = True):
        self._tk = tokenizer
        self._skip = skip_special_tokens
        self._ids: list[int] = []
        self._prefix_offset = 0
        self._read_offset = 0

    def step(self, token_id: int) -> str:
        self._ids.append(token_id)
        prefix_text = self._tk.decode(
            self._ids[self._prefix_offset : self._read_offset], self._skip
        )
        full_text = self._tk.decode(self._ids[self._prefix_offset :], self._skip)
        if full_text.endswith("�"):
            return ""  # mid-glyph; wait for more tokens
        new_text = full_text[len(prefix_text) :]
        self._prefix_offset = self._read_offset
        self._read_offset = len(self._ids)
        return new_text
