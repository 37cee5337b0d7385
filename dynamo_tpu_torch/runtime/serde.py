"""Wire serde for runtime messages.

A copy of the JAX package's ``runtime/serde.py``: the same JSON bytes for
the same values, so the two packages' processes read each other's frames.

Dataclasses used in cross-process requests/responses register here; the
wire form is JSON with a "__type__" tag.  Plain JSON data passes through
untouched.  (The reference uses serde-JSON two-part messages the same way;
pipeline/network.rs.)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Type

_REGISTRY: dict[str, Type] = {}


def register(cls: Type) -> Type:
    _REGISTRY[cls.__name__] = cls
    return cls


def _encode_obj(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {f.name: _encode_obj(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if type(obj).__name__ in _REGISTRY:
            d["__type__"] = type(obj).__name__
        return d
    if isinstance(obj, dict):
        return {k: _encode_obj(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode_obj(v) for v in obj]
    if hasattr(obj, "value") and obj.__class__.__module__ != "builtins":  # enums
        try:
            json.dumps(obj)
            return obj
        except TypeError:
            return obj.value
    return obj


def _decode_obj(data: Any) -> Any:
    if isinstance(data, dict):
        decoded = {k: _decode_obj(v) for k, v in data.items()}
        tname = decoded.pop("__type__", None)
        if tname and tname in _REGISTRY:
            cls = _REGISTRY[tname]
            fields = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in decoded.items() if k in fields})
        return decoded
    if isinstance(data, list):
        return [_decode_obj(v) for v in data]
    return data


def dumps(obj: Any) -> bytes:
    return json.dumps(_encode_obj(obj), separators=(",", ":")).encode()


def loads(raw: bytes) -> Any:
    if not raw:
        return None
    return _decode_obj(json.loads(raw))


def register_llm_types() -> None:
    """Register the LLM protocol dataclasses (idempotent)."""
    from dynamo_tpu_torch.llm import protocols as p

    for cls in (p.SamplingOptions, p.StopConditions, p.BackendInput, p.LLMEngineOutput):
        register(cls)
