"""Layered runtime configuration.

A copy of the JAX package's ``runtime/config.py`` (the same ``DYNTPU_*``
variables, so one environment configures either package's processes).

defaults → config file (TOML/YAML/JSON) → DYNTPU_* environment variables,
mirroring the reference's figment stack (lib/runtime/src/config.rs:34-108)
with the env prefix renamed from DYN_RUNTIME_/DYN_WORKER_ to DYNTPU_.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

ENV_PREFIX = "DYNTPU_"

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off", ""}


def env_is_truthy(name: str, default: bool = False) -> bool:
    """Reference config.rs:145-176 truthiness helpers."""
    val = os.environ.get(name)
    if val is None:
        return default
    v = val.strip().lower()
    if v in _TRUTHY:
        return True
    if v in _FALSY:
        return False
    raise ValueError(f"env var {name}={val!r} is not a boolean")


@dataclass
class RuntimeConfig:
    """Settings for a worker process."""

    namespace: str = "dynamo"
    component: str = ""
    endpoint: str = ""
    # control-plane coordinator address (the etcd+NATS replacement)
    coordinator_url: str = "tcp://127.0.0.1:6180"
    # static mode: no coordinator, endpoints wired in-process (ref: is_static)
    is_static: bool = False
    # lease TTL for liveness (ref: etcd lease, transports/etcd/lease.rs)
    lease_ttl_s: float = 10.0
    # response-plane TCP server bind
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral
    num_worker_threads: int = 0  # 0 = asyncio default executor
    extra: dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_settings(cls, config_path: Optional[str] = None) -> "RuntimeConfig":
        cfg = cls()
        path = config_path or os.environ.get(ENV_PREFIX + "CONFIG")
        if path:
            cfg = cfg._merged(_load_file(Path(path)))
        cfg = cfg._merged(_env_overrides())
        return cfg

    def _merged(self, overrides: dict[str, Any]) -> "RuntimeConfig":
        known = {f.name: f for f in dataclasses.fields(self)}
        out = dataclasses.replace(self)
        for k, v in overrides.items():
            k = k.lower()
            if k in known and k != "extra":
                typ = known[k].type
                if typ == "bool" and isinstance(v, str):
                    v = v.strip().lower() in _TRUTHY
                elif typ == "int" and isinstance(v, str):
                    v = int(v)
                elif typ == "float" and isinstance(v, str):
                    v = float(v)
                setattr(out, k, v)
            else:
                out.extra[k] = v
        return out


def _load_file(path: Path) -> dict[str, Any]:
    text = path.read_text()
    if path.suffix == ".toml":
        return tomllib.loads(text)
    if path.suffix in (".yaml", ".yml"):
        import yaml

        return yaml.safe_load(text) or {}
    return json.loads(text)


def _env_overrides() -> dict[str, Any]:
    out = {}
    for key, val in os.environ.items():
        if key.startswith(ENV_PREFIX) and key != ENV_PREFIX + "CONFIG":
            out[key[len(ENV_PREFIX) :].lower()] = val
    return out
