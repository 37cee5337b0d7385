"""Logging init: DYNTPU_LOG filter, optional JSONL structured output.

A copy of the JAX package's ``runtime/logging.py``, for the port's
``dynamo_tpu_torch`` loggers.

Reference parity: lib/runtime/src/logging.rs:62-290 (DYN_LOG env filter,
DYN_LOGGING_JSONL structured mode, custom formatter).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

_INITIALIZED = False


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


def init(level: str | None = None) -> None:
    """Idempotent logging setup for workers and CLIs."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    _INITIALIZED = True
    level = level or os.environ.get("DYNTPU_LOG", "INFO")
    handler = logging.StreamHandler(sys.stderr)
    if os.environ.get("DYNTPU_LOGGING_JSONL", "").lower() in ("1", "true"):
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s")
        )
    root = logging.getLogger("dynamo_tpu_torch")
    root.setLevel(level.upper())
    root.addHandler(handler)
    root.propagate = False
