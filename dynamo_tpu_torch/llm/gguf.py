"""GGUF checkpoint support: metadata, tokenizer, and weight extraction.

The counterpart of ``dynamo_tpu/llm/gguf.py``: the same reader, writer
and dequantisation in numpy, bit for bit.  GGUF is a checkpoint format the
port serves directly (metadata → ModelConfig, tensors → the port's state
dict through ``models/loader.py``, vocab → tokenizer), dequantising
Q8_0/Q4_0 and K-quant blocks to float32 on the host before the loader
rounds them to the compute dtype (and, with ``quantize``, requantises
them to the port's int8 layer by layer).

Format (spec v3): magic "GGUF", little-endian; u32 version, u64 tensor
count, u64 metadata-kv count; metadata KVs; tensor infos (name, dims,
ggml type, data offset); alignment padding; tensor data.  ggml dims are
fastest-varying-first, so a [out, in] torch weight appears as dims
[in, out] and reads back via reshape(dims[::-1]).

Q/K attention weights are stored rope-permuted by llama.cpp's converter
(rows reordered for interleaved rotary); ``unpermute_qk`` restores the HF
rotate-half layout our model uses.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO, Optional

import numpy as np

__all__ = ["GGUFFile", "GGUFTensorInfo", "write_gguf", "load_gguf_model"]

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
ALIGNMENT = 32

# metadata value types
(
    T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STRING, T_ARRAY,
    T_U64, T_I64, T_F64,
) = range(13)

_SCALAR_FMT = {
    T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h", T_U32: "<I",
    T_I32: "<i", T_F32: "<f", T_U64: "<Q", T_I64: "<q", T_F64: "<d",
}

# ggml tensor dtypes we understand
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q8_0 = 2, 8
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
GGML_BF16 = 30

_Q4_BLOCK, _Q8_BLOCK = 32, 32
_QK_K = 256  # K-quant super-block size
# K-quant super-block byte sizes (ggml block_q{4,5,6}_K layouts)
_Q4K_BYTES, _Q5K_BYTES, _Q6K_BYTES = 144, 176, 210


@dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy order (reversed ggml dims)
    ggml_type: int
    offset: int  # relative to data section start

    @property
    def n_elements(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1


# --------------------------------------------------------------------- read --


def _read_string(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype == T_STRING:
        return _read_string(f)
    if vtype == T_BOOL:
        return bool(f.read(1)[0])
    if vtype == T_ARRAY:
        (etype,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, etype) for _ in range(count)]
    fmt = _SCALAR_FMT[vtype]
    (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
    return v


class GGUFFile:
    """Parsed GGUF container: metadata dict + lazy tensor access."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        with open(self.path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            (version,) = struct.unpack("<I", f.read(4))
            if version not in (2, 3):
                raise ValueError(f"{path}: unsupported GGUF version {version}")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = _read_string(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.metadata[key] = _read_value(f, vtype)
            for _ in range(n_tensors):
                name = _read_string(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                ggml_type, offset = struct.unpack("<IQ", f.read(12))
                self.tensors[name] = GGUFTensorInfo(
                    name, tuple(reversed(dims)), ggml_type, offset
                )
            align = self.metadata.get("general.alignment", ALIGNMENT)
            pos = f.tell()
            self._data_start = (pos + align - 1) // align * align

    # ------------------------------------------------------------- tensor io
    def _raw(self, info: GGUFTensorInfo) -> bytes:
        nbytes = _tensor_nbytes(info)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + info.offset)
            return f.read(nbytes)

    def load_tensor(self, name: str, dtype=np.float32) -> np.ndarray:
        """Read + dequantise one tensor to ``dtype`` in numpy layout."""
        info = self.tensors[name]
        raw = self._raw(info)
        t = info.ggml_type
        if t == GGML_F32:
            arr = np.frombuffer(raw, np.float32)
        elif t == GGML_F16:
            arr = np.frombuffer(raw, np.float16).astype(np.float32)
        elif t == GGML_BF16:
            # bf16 is the high half of an f32
            arr = (np.frombuffer(raw, np.uint16).astype(np.uint32) << 16).view(np.float32)
        elif t == GGML_Q8_0:
            arr = _dequant_q8_0(raw, info.n_elements)
        elif t == GGML_Q4_0:
            arr = _dequant_q4_0(raw, info.n_elements)
        elif t == GGML_Q4_K:
            arr = _dequant_q4_k(raw, info.n_elements)
        elif t == GGML_Q5_K:
            arr = _dequant_q5_k(raw, info.n_elements)
        elif t == GGML_Q6_K:
            arr = _dequant_q6_k(raw, info.n_elements)
        else:
            raise NotImplementedError(f"ggml tensor type {t} ({name})")
        return arr.reshape(info.shape).astype(dtype)

    # ------------------------------------------------------------- metadata
    @property
    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "llama")

    def field(self, suffix: str, default=None):
        """Architecture-scoped metadata: field("block_count") →
        metadata["llama.block_count"]."""
        return self.metadata.get(f"{self.architecture}.{suffix}", default)

    def model_config_dict(self) -> dict:
        """HF-config-shaped dict (feeds ModelConfig.from_hf_config)."""
        n_heads = self.field("attention.head_count")
        vocab = self.metadata.get("tokenizer.ggml.tokens")
        return {
            "architectures": ["LlamaForCausalLM"],
            "vocab_size": self.field("vocab_size", len(vocab) if vocab else None),
            "hidden_size": self.field("embedding_length"),
            "intermediate_size": self.field("feed_forward_length"),
            "num_hidden_layers": self.field("block_count"),
            "num_attention_heads": n_heads,
            "num_key_value_heads": self.field("attention.head_count_kv", n_heads),
            "rope_theta": self.field("rope.freq_base", 10000.0),
            "rms_norm_eps": self.field("attention.layer_norm_rms_epsilon", 1e-5),
            "max_position_embeddings": self.field("context_length", 4096),
            "tie_word_embeddings": "output.weight" not in self.tensors,
        }

    # ------------------------------------------------------------- tokenizer
    def tokenizer_vocab(self) -> tuple[str, list[str], list[float]]:
        """(model kind, tokens, scores) from tokenizer.ggml.* metadata."""
        kind = self.metadata.get("tokenizer.ggml.model", "llama")
        tokens = self.metadata.get("tokenizer.ggml.tokens", [])
        scores = self.metadata.get("tokenizer.ggml.scores", [0.0] * len(tokens))
        return kind, tokens, scores

    def build_hf_tokenizer(self):
        """Construct a `tokenizers.Tokenizer` from the embedded vocab
        (gguf_tokenizer.rs parity).  BPE ("gpt2") uses the stored merges;
        SentencePiece ("llama") becomes a Unigram model with byte fallback.
        """
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers

        kind, tokens, scores = self.tokenizer_vocab()
        if not tokens:
            raise ValueError("no tokenizer vocabulary embedded in GGUF")
        if kind == "gpt2":
            vocab = {t: i for i, t in enumerate(tokens)}
            merges = [
                tuple(m.split(" ", 1))
                for m in self.metadata.get("tokenizer.ggml.merges", [])
            ]
            tok = Tokenizer(models.BPE(vocab=vocab, merges=merges))
            tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
            tok.decoder = decoders.ByteLevel()
        else:  # sentencepiece-style
            tok = Tokenizer(
                models.Unigram([(t, float(s)) for t, s in zip(tokens, scores)], 0, True)
            )
            tok.decoder = decoders.Replace("▁", " ")
        return tok

    def eos_token_ids(self) -> list[int]:
        eos = self.metadata.get("tokenizer.ggml.eos_token_id")
        return [int(eos)] if eos is not None else []


def _tensor_nbytes(info: GGUFTensorInfo) -> int:
    n = info.n_elements
    t = info.ggml_type
    if t == GGML_F32:
        return n * 4
    if t in (GGML_F16, GGML_BF16):
        return n * 2
    if t == GGML_Q8_0:
        return n // _Q8_BLOCK * 34  # f16 scale + 32×i8
    if t == GGML_Q4_0:
        return n // _Q4_BLOCK * 18  # f16 scale + 16 nibble bytes
    if t == GGML_Q4_K:
        return n // _QK_K * _Q4K_BYTES
    if t == GGML_Q5_K:
        return n // _QK_K * _Q5K_BYTES
    if t == GGML_Q6_K:
        return n // _QK_K * _Q6K_BYTES
    raise NotImplementedError(f"ggml tensor type {t}")


def _dequant_q8_0(raw: bytes, n: int) -> np.ndarray:
    blocks = n // _Q8_BLOCK
    rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"), ("qs", "i1", _Q8_BLOCK)]),
                        count=blocks)
    return (rec["d"].astype(np.float32)[:, None] * rec["qs"].astype(np.float32)).reshape(-1)


def _dequant_q4_0(raw: bytes, n: int) -> np.ndarray:
    blocks = n // _Q4_BLOCK
    rec = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"), ("qs", "u1", 16)]),
                        count=blocks)
    lo = (rec["qs"] & 0x0F).astype(np.int8) - 8
    hi = (rec["qs"] >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)  # [blocks, 32]
    return (rec["d"].astype(np.float32)[:, None] * q).reshape(-1)


def _k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the shared K-quant 6-bit (scale, min) encoding: 12 bytes →
    8 sub-block scales + 8 mins per super-block (ggml get_scale_min_k4).
    ``scales`` [B, 12] uint8 → (sc [B, 8], mn [B, 8]) float32."""
    q = scales.astype(np.uint8)
    sc = np.empty(q.shape[:-1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    sc[..., :4] = q[..., 0:4] & 63
    mn[..., :4] = q[..., 4:8] & 63
    sc[..., 4:] = (q[..., 8:12] & 0x0F) | ((q[..., 0:4] >> 6) << 4)
    mn[..., 4:] = (q[..., 8:12] >> 4) | ((q[..., 4:8] >> 6) << 4)
    return sc.astype(np.float32), mn.astype(np.float32)


def _dequant_q4_k(raw: bytes, n: int) -> np.ndarray:
    """block_q4_K: {f16 d, f16 dmin, u8 scales[12], u8 qs[128]} per 256
    values — 8 sub-blocks of 32, value = d·sc·q − dmin·mn, with each
    32-byte qs chunk holding sub-block 2j in low nibbles and 2j+1 in
    high nibbles."""
    blocks = n // _QK_K
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", 12),
         ("qs", "u1", 128)]), count=blocks)
    sc, mn = _k_scale_min(rec["scales"])               # [B, 8]
    d = rec["d"].astype(np.float32)[:, None, None]     # [B, 1, 1]
    dmin = rec["dmin"].astype(np.float32)[:, None, None]
    qs = rec["qs"].reshape(blocks, 4, 32)              # 4 chunks of 32B
    lo = (qs & 0x0F).astype(np.float32)                # sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(np.float32)                  # sub-blocks 1,3,5,7
    q = np.stack([lo, hi], axis=2).reshape(blocks, 8, 32)
    out = d * sc[:, :, None] * q - dmin * mn[:, :, None]
    return out.reshape(-1)


def _dequant_q5_k(raw: bytes, n: int) -> np.ndarray:
    """block_q5_K: Q4_K plus qh[32] carrying each value's 5th bit — the
    bit for sub-block j lives at qh bit j (shifting mask per 64-value
    chunk in the scalar code = bit index per sub-block here)."""
    blocks = n // _QK_K
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", 12),
         ("qh", "u1", 32), ("qs", "u1", 128)]), count=blocks)
    sc, mn = _k_scale_min(rec["scales"])
    d = rec["d"].astype(np.float32)[:, None, None]
    dmin = rec["dmin"].astype(np.float32)[:, None, None]
    qs = rec["qs"].reshape(blocks, 4, 32)
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    q = np.stack([lo, hi], axis=2).reshape(blocks, 8, 32)
    qh = rec["qh"]                                     # [B, 32]
    bits = (qh[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    out = d * sc[:, :, None] * (q + bits.astype(np.float32) * 16.0) \
        - dmin * mn[:, :, None]
    return out.reshape(-1)


def _dequant_q6_k(raw: bytes, n: int) -> np.ndarray:
    """block_q6_K: {u8 ql[128], u8 qh[64], i8 scales[16], f16 d} per 256
    values — 16 sub-blocks of 16, q = ((ql nibble) | (qh 2 bits << 4))
    − 32, value = d·scales[sub]·q.  Laid out in two 128-value halves;
    within a half, position l∈[0,32) of quarter k reads ql[l + 32·(k&1)]
    nibble (k<2 low, k≥2 high) and qh[l] bits (2k, 2k+1)."""
    blocks = n // _QK_K
    rec = np.frombuffer(raw, dtype=np.dtype(
        [("ql", "u1", 128), ("qh", "u1", 64), ("scales", "i1", 16),
         ("d", "<f2")]), count=blocks)
    d = rec["d"].astype(np.float32)
    scales = rec["scales"].astype(np.float32)          # [B, 16]
    ql = rec["ql"].reshape(blocks, 2, 2, 32)           # [B, half, lohalf, 32]
    qh = rec["qh"].reshape(blocks, 2, 32)              # [B, half, 32]
    out = np.empty((blocks, 2, 4, 32), np.float32)     # [B, half, quarter, 32]
    for k in range(4):                                 # quarter within a half
        nib = ql[:, :, k & 1]                          # [B, half, 32]
        nib = (nib & 0x0F) if k < 2 else (nib >> 4)
        high = (qh >> (2 * k)) & 3
        out[:, :, k] = (nib | (high << 4)).astype(np.float32) - 32.0
    # scale index: sub-block of 16 → scales[(half·128 + quarter·32 + l)//16]
    idx = (np.arange(_QK_K) // 16).reshape(2, 4, 32)
    out *= scales[:, idx]
    out *= d[:, None, None, None]
    return out.reshape(-1)


# ----------------------------------------------------------- HF weight maps --


def unpermute_qk(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Invert llama.cpp's rope permutation on a [out, in] Q/K weight
    (convert_hf_to_gguf permute: reshape(h, 2, dh/2, in).swapaxes(1, 2))."""
    out, rest = w.shape[0], w.shape[1:]
    dh = out // n_heads
    return (
        w.reshape(n_heads, dh // 2, 2, *rest)
        .swapaxes(1, 2)
        .reshape(w.shape)
    )


def permute_qk(w: np.ndarray, n_heads: int) -> np.ndarray:
    """llama.cpp's converter permutation (used by write_gguf/tests)."""
    out, rest = w.shape[0], w.shape[1:]
    dh = out // n_heads
    return (
        w.reshape(n_heads, 2, dh // 2, *rest)
        .swapaxes(1, 2)
        .reshape(w.shape)
    )


class _GGUFStateDict:
    """Adapts GGUF tensor names to the HF state-dict names the loader reads
    (``models/loader.py``'s ``SafetensorsDir`` interface: ``in`` and
    ``get``), unpermuting Q/K on the fly; each tensor is dequantised to
    float32 and moved to ``device`` when the loader asks for it."""

    _MAP = {
        "model.embed_tokens.weight": "token_embd.weight",
        "model.norm.weight": "output_norm.weight",
        "lm_head.weight": "output.weight",
    }
    _LAYER_MAP = {
        "input_layernorm.weight": "attn_norm.weight",
        "self_attn.q_proj.weight": "attn_q.weight",
        "self_attn.k_proj.weight": "attn_k.weight",
        "self_attn.v_proj.weight": "attn_v.weight",
        "self_attn.o_proj.weight": "attn_output.weight",
        "post_attention_layernorm.weight": "ffn_norm.weight",
        "mlp.gate_proj.weight": "ffn_gate.weight",
        "mlp.up_proj.weight": "ffn_up.weight",
        "mlp.down_proj.weight": "ffn_down.weight",
    }

    def __init__(self, gf: GGUFFile, n_heads: int, n_kv_heads: int, device=None):
        self.gf = gf
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.device = device

    def _gguf_name(self, hf_name: str) -> str:
        if hf_name in self._MAP:
            return self._MAP[hf_name]
        if hf_name.startswith("model.layers."):
            _, _, i, rest = hf_name.split(".", 3)
            return f"blk.{i}.{self._LAYER_MAP[rest]}"
        raise KeyError(hf_name)

    def __getitem__(self, hf_name: str) -> np.ndarray:
        arr = self.gf.load_tensor(self._gguf_name(hf_name))
        if "q_proj" in hf_name:
            arr = unpermute_qk(arr, self.n_heads)
        elif "k_proj" in hf_name:
            arr = unpermute_qk(arr, self.n_kv_heads)
        return arr

    def __contains__(self, hf_name: str) -> bool:
        try:
            return self._gguf_name(hf_name) in self.gf.tensors
        except KeyError:
            return False

    def get(self, hf_name: str):
        import torch

        return torch.from_numpy(np.ascontiguousarray(self[hf_name])).to(self.device)


def load_gguf_model(path: str | Path, dtype: str = "bfloat16", device=None,
                    quantize: bool = False, mesh=None):
    """(ModelConfig, state dict on ``device``) straight from a GGUF file —
    the llama.cpp-model entry point the reference routes to an external
    engine.  ``quantize``: int8 weights, quantised as they are read.  On a
    ``mesh``, this rank's slice (read on the host, then cut)."""
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.models.loader import load_state

    gf = GGUFFile(path)
    cfg = ModelConfig.from_hf_config(gf.model_config_dict(), dtype=dtype)
    import torch

    dev = resolve_device(device)
    read = torch.device("cpu") if mesh is not None and mesh.size > 1 else dev
    files = _GGUFStateDict(gf, cfg.num_heads, cfg.num_kv_heads, read)
    return cfg, load_state(cfg, files, dev, quantize, mesh=mesh)


# -------------------------------------------------------------------- write --


def _write_string(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)) + b)


def _value_type(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_U32 if 0 <= v < 2**32 else T_I64
    if isinstance(v, float):
        return T_F32
    if isinstance(v, str):
        return T_STRING
    raise TypeError(type(v))


def _write_value(f: BinaryIO, v: Any) -> None:
    if isinstance(v, bool):
        f.write(struct.pack("<B", int(v)))
    elif isinstance(v, int):
        f.write(struct.pack("<I" if 0 <= v < 2**32 else "<q", v))
    elif isinstance(v, float):
        f.write(struct.pack("<f", v))
    elif isinstance(v, str):
        _write_string(f, v)
    else:
        raise TypeError(type(v))


def _quant_q8_0(arr: np.ndarray) -> bytes:
    flat = arr.reshape(-1, _Q8_BLOCK).astype(np.float32)
    d = np.abs(flat).max(axis=1) / 127.0
    d_safe = np.where(d == 0, 1.0, d)
    qs = np.clip(np.round(flat / d_safe[:, None]), -127, 127).astype(np.int8)
    rec = np.zeros(len(flat), dtype=np.dtype([("d", "<f2"), ("qs", "i1", _Q8_BLOCK)]))
    rec["d"] = d.astype(np.float16)
    rec["qs"] = qs
    return rec.tobytes()


def write_gguf(
    path: str | Path,
    metadata: dict[str, Any],
    tensors: dict[str, np.ndarray],
    quantize: Optional[dict[str, int]] = None,
    raw: Optional[dict[str, tuple[int, tuple[int, ...], bytes]]] = None,
) -> None:
    """Minimal GGUF v3 writer (tests + export).  ``quantize`` maps tensor
    name → ggml type (default F32).  ``raw`` carries PRE-QUANTIZED
    tensors verbatim as name → (ggml_type, shape, payload bytes) —
    repacking K-quant tensors this writer cannot produce itself."""
    quantize = quantize or {}
    raw = raw or {}
    overlap = set(tensors) & set(raw)
    if overlap:
        # strict readers (llama.cpp) reject duplicate tensor names —
        # fail at write time, not at someone else's load time
        raise ValueError(f"tensor names in both tensors and raw: {overlap}")
    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", GGUF_VERSION))
        f.write(struct.pack("<QQ", len(tensors) + len(raw), len(metadata)))
        for k, v in metadata.items():
            _write_string(f, k)
            if isinstance(v, list):
                f.write(struct.pack("<I", T_ARRAY))
                etype = _value_type(v[0]) if v else T_U32
                f.write(struct.pack("<IQ", etype, len(v)))
                for item in v:
                    _write_value(f, item)
            else:
                f.write(struct.pack("<I", _value_type(v)))
                _write_value(f, v)

        payloads: list[bytes] = []
        offset = 0

        def emit_info(name: str, shape: tuple[int, ...], t: int,
                      data: bytes) -> None:
            nonlocal offset
            _write_string(f, name)
            dims = tuple(reversed(shape))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", t, offset))
            payloads.append(data)
            offset += (len(data) + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT

        for name, arr in tensors.items():
            t = quantize.get(name, GGML_F32)
            if t == GGML_F32:
                data = np.ascontiguousarray(arr, np.float32).tobytes()
            elif t == GGML_F16:
                data = np.ascontiguousarray(arr, np.float16).tobytes()
            elif t == GGML_Q8_0:
                data = _quant_q8_0(arr)
            else:
                raise NotImplementedError(f"write type {t}")
            emit_info(name, arr.shape, t, data)
        for name, (t, shape, data) in raw.items():
            emit_info(name, tuple(shape), t, bytes(data))

        pos = f.tell()
        f.write(b"\x00" * ((pos + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT - pos))
        for data in payloads:
            f.write(data)
            pad = (len(data) + ALIGNMENT - 1) // ALIGNMENT * ALIGNMENT - len(data)
            f.write(b"\x00" * pad)
