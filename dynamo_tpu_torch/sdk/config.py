"""ServiceConfig — per-service args from YAML with Common inheritance.

A copy of the JAX package's ``sdk/config.py``, field for field and under
the same ``DYNTPU_SERVICE_CONFIG`` variable, so a config written by either
package's supervisor reads the same in the other's workers.

Reference parity: deploy/dynamo/sdk/src/dynamo/sdk/lib/config.py (+ its
test_config.py): top-level keys are service names mapping to arg dicts; a
``Common`` block holds shared values which services opt into via a
``common-configs: [key, ...]`` list; the whole config can be overridden /
injected through the DYNTPU_SERVICE_CONFIG env var (JSON) so spawned
worker processes inherit it without re-reading files.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Optional

__all__ = ["ServiceConfig", "CONFIG_ENV"]

CONFIG_ENV = "DYNTPU_SERVICE_CONFIG"
COMMON_KEY = "Common"
INHERIT_KEY = "common-configs"


class ServiceConfig:
    def __init__(self, data: Optional[dict] = None):
        self.data: dict[str, Any] = data or {}

    # ------------------------------------------------------------------ load
    @classmethod
    def from_yaml(cls, path: str | Path) -> "ServiceConfig":
        import yaml

        with open(path) as f:
            return cls(yaml.safe_load(f) or {})

    @classmethod
    def from_env(cls) -> "ServiceConfig":
        raw = os.environ.get(CONFIG_ENV)
        return cls(json.loads(raw)) if raw else cls()

    def to_env(self) -> dict[str, str]:
        """Env var form for worker subprocesses."""
        return {CONFIG_ENV: json.dumps(self.data)}

    # ----------------------------------------------------------------- query
    def for_service(self, name: str) -> dict[str, Any]:
        """Args for one service: its block, with any ``common-configs`` keys
        filled from the Common block (service-local values win)."""
        block = dict(self.data.get(name, {}))
        common = self.data.get(COMMON_KEY, {})
        for key in block.pop(INHERIT_KEY, []):
            if key not in block and key in common:
                block[key] = common[key]
        return block

    def merged_with(self, overrides: dict) -> "ServiceConfig":
        """New config with service blocks deep-merged (overrides win)."""
        out = {k: dict(v) if isinstance(v, dict) else v for k, v in self.data.items()}
        for svc, block in overrides.items():
            if isinstance(block, dict):
                out.setdefault(svc, {}).update(block)
            else:
                out[svc] = block
        return ServiceConfig(out)
