"""SentencePiece ``tokenizer.model`` support — no sentencepiece package.

A copy of the JAX package's ``llm/sentencepiece.py``: the same parse and
the same ``tokenizer.json``, byte for byte.  Reference parity:
lib/llm/src/tokenizers.rs wraps BOTH HF tokenizer.json and SentencePiece
models.  Both packages standardise on the ``tokenizers`` runtime (same
Rust core the reference uses); a checkpoint that ships only
``tokenizer.model`` gets its model PARSED here (the file is a small
protobuf — pieces, scores, trainer/normalizer specs) and MATERIALISED as
an equivalent ``tokenizer.json`` (Unigram + byte-fallback + the model's
own precompiled normalizer charsmap), exactly like the GGUF path
materialises its embedded vocab (llm/gguf.py:build_hf_tokenizer).

The conversion mirrors transformers' SpmConverter/LlamaConverter
pipeline: Precompiled(charsmap) → Prepend("▁") (dummy prefix) →
Replace(" ","▁") normalizers; Unigram(vocab, unk_id, byte_fallback);
Replace/ByteFallback/Fuse/Strip decoders.  SP-BPE models (model_type=2)
are rejected loudly — their merges are not recoverable from scores.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

__all__ = ["SpModel", "parse_model_proto", "build_hf_tokenizer",
           "materialize_tokenizer", "is_sentencepiece_model"]

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
UNIGRAM, BPE = 1, 2


@dataclass
class SpModel:
    pieces: list[tuple[str, float, int]] = field(default_factory=list)
    model_type: int = UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    precompiled_charsmap: bytes = b""


def _varint(data: bytes, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = data[i]
        v |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return v, i
        shift += 7


def _signed(v: int) -> int:
    """Protobuf int32/int64 varints are two's-complement 64-bit."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(data: bytes):
    """Iterate (field_number, wire_type, value) over a protobuf message;
    value is int for varint/fixed, bytes for length-delimited."""
    i, n = 0, len(data)
    while i < n:
        key, i = _varint(data, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(data, i)
        elif wt == 1:
            v, i = int.from_bytes(data[i:i + 8], "little"), i + 8
        elif wt == 2:
            ln, i = _varint(data, i)
            v, i = data[i:i + ln], i + ln
        elif wt == 5:
            v, i = int.from_bytes(data[i:i + 4], "little"), i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fnum, wt, v


def _f32(v: int) -> float:
    import struct

    return struct.unpack("<f", v.to_bytes(4, "little"))[0]


def parse_model_proto(data: bytes) -> SpModel:
    """Parse a sentencepiece ModelProto (the ``tokenizer.model`` bytes)."""
    sp = SpModel()
    for fnum, wt, v in _fields(data):
        if fnum == 1 and wt == 2:  # repeated SentencePiece
            piece, score, ptype = "", 0.0, NORMAL
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:
                    piece = v2.decode("utf-8", errors="replace")
                elif f2 == 2 and w2 == 5:
                    score = _f32(v2)
                elif f2 == 3 and w2 == 0:
                    ptype = v2
            sp.pieces.append((piece, score, ptype))
        elif fnum == 2 and wt == 2:  # TrainerSpec
            for f2, w2, v2 in _fields(v):
                if w2 != 0:
                    continue
                if f2 == 3:
                    sp.model_type = v2
                elif f2 == 40:
                    sp.unk_id = _signed(v2)
                elif f2 == 41:
                    sp.bos_id = _signed(v2)
                elif f2 == 42:
                    sp.eos_id = _signed(v2)
                elif f2 == 43:
                    sp.pad_id = _signed(v2)
        elif fnum == 3 and wt == 2:  # NormalizerSpec
            for f2, w2, v2 in _fields(v):
                if f2 == 2 and w2 == 2:
                    sp.precompiled_charsmap = v2
                elif f2 == 3 and w2 == 0:
                    sp.add_dummy_prefix = bool(v2)
                elif f2 == 4 and w2 == 0:
                    sp.remove_extra_whitespaces = bool(v2)
    if not sp.pieces:
        raise ValueError("no pieces in sentencepiece model (not a ModelProto?)")
    return sp


def build_hf_tokenizer(sp: SpModel):
    """SpModel → ``tokenizers.Tokenizer`` (Unigram pipeline)."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers

    if sp.model_type != UNIGRAM:
        raise NotImplementedError(
            f"sentencepiece model_type {sp.model_type} (only unigram "
            "models materialise; SP-BPE merges are not stored)"
        )
    byte_fallback = any(t == BYTE for _, _, t in sp.pieces)
    vocab = [(p, s) for p, s, _ in sp.pieces]
    unk = sp.unk_id if 0 <= sp.unk_id < len(vocab) else 0
    tok = Tokenizer(models.Unigram(vocab, unk, byte_fallback))

    norms = []
    if sp.precompiled_charsmap:
        # the model's own NFKC-ish charsmap applies verbatim — the
        # tokenizers crate executes it natively
        norms.append(normalizers.Precompiled(sp.precompiled_charsmap))
    if sp.remove_extra_whitespaces:
        # sentencepiece default: collapse whitespace runs BEFORE the
        # space→▁ mapping (transformers SpmConverter does the same)
        from tokenizers import Regex

        norms.append(normalizers.Replace(Regex(" {2,}"), " "))
    if sp.add_dummy_prefix:
        norms.append(normalizers.Prepend("▁"))
    norms.append(normalizers.Replace(" ", "▁"))
    tok.normalizer = normalizers.Sequence(norms)

    decs = [decoders.Replace("▁", " "), decoders.ByteFallback(),
            decoders.Fuse()]
    if sp.add_dummy_prefix:
        decs.append(decoders.Strip(" ", 1, 0))
    tok.decoder = decoders.Sequence(decs)

    specials = [
        AddedToken(p, special=True, normalized=False)
        for p, _, t in sp.pieces if t == CONTROL
    ]
    if specials:
        tok.add_special_tokens(specials)
    return tok


def is_sentencepiece_model(path: str | Path) -> bool:
    p = Path(path)
    return p.is_file() and p.suffix == ".model"


def materialize_tokenizer(model_file: str | Path,
                          out: Optional[str | Path] = None) -> Path:
    """Parse ``tokenizer.model`` and write the equivalent
    ``tokenizer.json`` (default: next to it; falls back to the model
    cache when the directory is read-only).

    Concurrency/staleness: the write is temp-file + atomic rename (two
    workers racing never expose a half-written JSON to a third), and an
    existing materialisation is reused only when at least as new as the
    source .model (a replaced checkpoint re-materialises)."""
    import os

    src = Path(model_file)
    dst = Path(out) if out else src.parent / "tokenizer.json"
    if dst.exists() and dst.stat().st_mtime >= src.stat().st_mtime:
        return dst
    tok = build_hf_tokenizer(parse_model_proto(src.read_bytes()))

    def atomic_save(path: Path) -> None:
        tmp = path.with_name(f".{path.name}.tmp-{os.getpid()}")
        tok.save(str(tmp))
        os.replace(tmp, path)

    try:
        atomic_save(dst)
    except Exception:
        from dynamo_tpu_torch.llm.model_store import DEFAULT_CACHE

        alt = DEFAULT_CACHE / "sp-materialized"
        alt.mkdir(parents=True, exist_ok=True)
        import hashlib

        h = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        dst = alt / f"{src.stem}-{h}.tokenizer.json"
        if not dst.exists():
            atomic_save(dst)
    return dst
