"""JSONL recorder/replayer of router events.

The counterpart of ``dynamo_tpu/llm/kv_router/recorder.py``, with its
file format (one ``event_to_wire`` object a line, plus ``ts`` and ``v``).
Distributed routing behavior is testable offline: record each worker's KV
events to JSONL, replay them into a fresh indexer, and assert routing
decisions — no cluster needed (reference: lib/llm/src/recorder.rs:38,
kv_router/recorder.rs, replay fixtures in lib/llm/tests/data/replays/).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Iterator, Optional, TextIO

from dynamo_tpu_torch.llm.kv.events import KvCacheEvent, event_from_wire, event_to_wire
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer

__all__ = ["KvRecorder", "iter_events", "replay_into"]


RECORDING_VERSION = 1


class KvRecorder:
    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._fh: Optional[TextIO] = None
        self._count = 0

    def __enter__(self) -> "KvRecorder":
        self._fh = self._path.open("a")
        return self

    def __exit__(self, *exc) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def record(self, event_id: int, worker_id: int, event: KvCacheEvent) -> None:
        if self._fh is None:
            self._fh = self._path.open("a")
        line = event_to_wire(event_id, worker_id, event)
        line["ts"] = time.time()
        # recordings outlive the process: tag the format so a future
        # replayer can detect old captures (event_from_wire drops both
        # "ts" and "v" as unknown keys on replay)
        line["v"] = RECORDING_VERSION
        self._fh.write(json.dumps(line) + "\n")
        self._fh.flush()
        self._count += 1

    @property
    def count(self) -> int:
        return self._count


def iter_events(path: str | Path) -> Iterator[tuple[int, int, KvCacheEvent]]:
    with Path(path).open() as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield event_from_wire(json.loads(line))


def replay_into(path: str | Path, indexer: KvIndexer) -> int:
    """Feed a recorded JSONL stream into an indexer; returns event count."""
    n = 0
    for event_id, worker_id, ev in iter_events(path):
        indexer.apply_event(worker_id, ev, event_id)
        n += 1
    return n
