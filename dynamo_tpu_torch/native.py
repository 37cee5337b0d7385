"""The host helpers in C++: the KV prefix index, threaded block copies and
the KV event queue.

The counterpart of ``dynamo_tpu/native.py``, with its API and names.  The
sources are the port's own copy (``csrc/host/``: ``kv_index.cpp``,
``block_copy.cpp``, ``event_queue.cpp`` and their C header), compiled by
``g++`` into one shared library with a plain C interface and loaded with
``ctypes.CDLL`` (a call releases the GIL, so the offload thread's copy runs
beside the engine loop).  The library lands in ``dynamo_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags, as the CUDA kernels'
library does.  Nothing is built at import time: the first use builds, and a
failed build raises with the compiler's log.  There is no pure-Python
fallback behind these names: the Python prefix index is reached only by
asking for it (``KvIndexer(use_native=False)``).

The block copies take torch CPU tensors (pinned or not) or numpy arrays and
move whole blocks (rows of axis 0) with ``memcpy`` by pointer and byte
size, so any dtype works, bf16 included.  ``calls`` counts the native
copies made, by direction.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["load", "available", "build_library", "NativeKvIndex", "NativeEventQueue",
           "BlockCopies", "blocks_gather", "blocks_scatter", "calls", "EVENT_STORED", "EVENT_REMOVED", "CXX_FLAGS"]

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared", "-Wall", "-Wextra"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u64p = ctypes.POINTER(ctypes.c_uint64)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_P = ctypes.c_void_p

EVENT_STORED = 0
EVENT_REMOVED = 1


def _declare(lib: ctypes.CDLL) -> None:
    lib.dyn_index_new.restype = _P
    lib.dyn_index_free.argtypes = [_P]
    lib.dyn_index_store.argtypes = [_P, ctypes.c_uint64, _u64p, ctypes.c_size_t]
    lib.dyn_index_remove.argtypes = [_P, ctypes.c_uint64, _u64p, ctypes.c_size_t]
    lib.dyn_index_remove_worker.argtypes = [_P, ctypes.c_uint64]
    lib.dyn_index_clear.argtypes = [_P]
    lib.dyn_index_num_blocks.argtypes = [_P]
    lib.dyn_index_num_blocks.restype = ctypes.c_uint64
    lib.dyn_index_num_workers.argtypes = [_P]
    lib.dyn_index_num_workers.restype = ctypes.c_uint64
    lib.dyn_index_num_worker_blocks.argtypes = [_P, ctypes.c_uint64]
    lib.dyn_index_num_worker_blocks.restype = ctypes.c_uint64
    lib.dyn_index_find_matches.argtypes = [_P, _u64p, ctypes.c_size_t, _u64p, _u32p,
                                           ctypes.c_size_t]
    lib.dyn_index_find_matches.restype = ctypes.c_size_t
    # the pools' pointers as c_void_p: data_ptr() of a tensor, never truncated
    lib.dyn_blocks_gather.argtypes = [_P, ctypes.c_uint64, _i64p, ctypes.c_size_t, _P,
                                      ctypes.c_int]
    lib.dyn_blocks_scatter.argtypes = [_P, ctypes.c_uint64, _i64p, ctypes.c_size_t, _P,
                                       ctypes.c_int]
    lib.dyn_events_new.argtypes = [ctypes.c_size_t]
    lib.dyn_events_new.restype = _P
    lib.dyn_events_free.argtypes = [_P]
    lib.dyn_events_publish.argtypes = [_P, ctypes.c_int32, ctypes.c_uint64, _u64p,
                                       ctypes.c_size_t]
    lib.dyn_events_publish.restype = ctypes.c_int
    lib.dyn_events_drain.argtypes = [_P, _i32p, _u64p, _u64p, ctypes.c_size_t, _u64p,
                                     ctypes.c_size_t]
    lib.dyn_events_drain.restype = ctypes.c_size_t
    lib.dyn_events_dropped.argtypes = [_P]
    lib.dyn_events_dropped.restype = ctypes.c_uint64
    lib.dyn_native_version.restype = ctypes.c_char_p


# ------------------------------------------------------------------ build

def _sources() -> list[Path]:
    return sorted(SRC.glob("*.cpp")) + sorted(SRC.glob("*.h"))


def _source_key() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile and link the host library unless one for these exact sources
    exists; returns its path.  A failed build raises with g++'s log."""
    out = BUILD_DIR / f"libdynamo_host-{_source_key()}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        staged = Path(tmp) / out.name
        cpp = [str(p) for p in _sources() if p.suffix == ".cpp"]
        done = subprocess.run([cxx, *CXX_FLAGS, f"-I{SRC}", *cpp, "-o", str(staged)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode:
            raise RuntimeError(f"g++ failed to build the host library:\n{done.stdout}")
        os.replace(staged, out)  # atomic: a concurrent loader never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The loaded host library, built on first use (call it off the event
    loop: a build takes seconds)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            _declare(lib)
            _lib = lib
        return _lib


def available() -> bool:
    """True once the library is loaded, building it if needed.  A failed
    build raises: there is no fallback to report False for."""
    return load() is not None


def _as_u64(arr: Sequence[int] | np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.uint64)


# ---------------------------------------------------------------- the index

class NativeKvIndex:
    """Handle to a native dyn_index (see KvIndexer for the Python-facing API)."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.dyn_index_new()

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dyn_index_free(self._h)
            self._h = None

    def store(self, worker: int, hashes: Sequence[int]) -> None:
        a = _as_u64(hashes)
        self._lib.dyn_index_store(self._h, worker, a.ctypes.data_as(_u64p), len(a))

    def remove(self, worker: int, hashes: Sequence[int]) -> None:
        a = _as_u64(hashes)
        self._lib.dyn_index_remove(self._h, worker, a.ctypes.data_as(_u64p), len(a))

    def remove_worker(self, worker: int) -> None:
        self._lib.dyn_index_remove_worker(self._h, worker)

    def clear(self) -> None:
        self._lib.dyn_index_clear(self._h)

    @property
    def num_blocks(self) -> int:
        return self._lib.dyn_index_num_blocks(self._h)

    @property
    def num_workers(self) -> int:
        return self._lib.dyn_index_num_workers(self._h)

    def worker_blocks(self, worker: int) -> int:
        """How many blocks the index holds for one worker."""
        return self._lib.dyn_index_num_worker_blocks(self._h, worker)

    def find_matches(self, hashes: Sequence[int]) -> dict[int, int]:
        a = _as_u64(hashes)
        cap = max(16, self.num_workers)
        while True:
            workers = np.empty(cap, dtype=np.uint64)
            scores = np.empty(cap, dtype=np.uint32)
            n = self._lib.dyn_index_find_matches(
                self._h, a.ctypes.data_as(_u64p), len(a),
                workers.ctypes.data_as(_u64p), scores.ctypes.data_as(_u32p), cap)
            if n <= cap:
                return {int(workers[i]): int(scores[i]) for i in range(n)}
            cap = n


# ---------------------------------------------------------- the block copies

def _index(ids) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    return np.ascontiguousarray(ids, dtype=np.int64)


def _check_ids(idx: np.ndarray, n_blocks: int) -> None:
    # the native path is a raw memcpy: bounds are enforced here (no
    # negative-index wrapping), as the indexing path would raise
    if len(idx) and (idx.min() < 0 or idx.max() >= n_blocks):
        raise IndexError(f"block id out of range [0, {n_blocks}): {idx.min()}..{idx.max()}")


def _host(a, what: str) -> torch.Tensor:
    """A torch view of a host array (a numpy array shares its memory)."""
    t = torch.from_numpy(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
    if t.device.type != "cpu":
        raise ValueError(f"{what} is on {t.device}: the block copies are host to host")
    return t


def _block_bytes(t: torch.Tensor) -> int:
    return t[0].numel() * t.element_size()


class BlockCopies:
    """The block copies over the loaded library.  A host pool keeps one,
    made when the pool is, so that no copy it makes can be the one that
    builds the library."""

    def __init__(self) -> None:
        self._lib = load()

    def gather(self, src, ids: Sequence[int], threads: int = 0, out=None):
        """Gather ``src[ids]`` (axis 0) by native memcpy into ``out``, or
        into a new contiguous array of ``src``'s kind (tensor or numpy
        array).  ids are bounds-checked (no negative wrapping); a ``src`` or
        ``out`` that is not contiguous takes the indexing path instead."""
        t = _host(src, "src")
        idx = _index(ids)
        _check_ids(idx, len(t))
        shape = (len(idx),) + tuple(t.shape[1:])
        if out is None:
            dst = torch.empty(shape, dtype=t.dtype)
            result = dst.numpy() if isinstance(src, np.ndarray) else dst
        else:
            dst = _host(out, "out")
            if tuple(dst.shape) != shape or dst.dtype != t.dtype:
                raise ValueError(f"gather out {tuple(dst.shape)}/{dst.dtype} vs "
                                 f"{shape}/{t.dtype}")
            result = out
        if not (t.is_contiguous() and dst.is_contiguous()):
            dst.copy_(t.index_select(0, torch.from_numpy(idx)))
        elif len(idx):
            self._lib.dyn_blocks_gather(t.data_ptr(), _block_bytes(t),
                                        idx.ctypes.data_as(_i64p), len(idx), dst.data_ptr(),
                                        threads)
            calls["gather"] += 1
        return result

    def scatter(self, dst, ids: Sequence[int], src, threads: int = 0) -> None:
        """Scatter ``src`` rows into ``dst[ids]`` (axis 0) in place by
        native memcpy.  The shapes must match (``ValueError``), ids are
        bounds-checked, and duplicate ids resolve last-write-wins (the
        threaded copy would race on them, so they are deduplicated first).
        A ``dst`` that is not contiguous takes the indexing path."""
        idx = _index(ids)
        want = (len(idx),) + tuple(dst.shape[1:])
        if tuple(src.shape) != want:
            raise ValueError(f"scatter shape mismatch: src {tuple(src.shape)} vs {want}")
        d = _host(dst, "dst")
        _check_ids(idx, len(d))
        s = _host(src, "src").to(d.dtype)
        if len(np.unique(idx)) != len(idx):
            last = {int(b): i for i, b in enumerate(idx)}  # each id's LAST occurrence
            keep = np.fromiter(last.values(), dtype=np.int64)
            idx = idx[keep]
            s = s[torch.from_numpy(keep)]
        if not d.is_contiguous():
            d[torch.from_numpy(idx)] = s
        elif len(idx):
            s = s.contiguous()
            self._lib.dyn_blocks_scatter(d.data_ptr(), _block_bytes(d),
                                         idx.ctypes.data_as(_i64p), len(idx), s.data_ptr(),
                                         threads)
            calls["scatter"] += 1


# native copies made, by direction (the indexing paths are not counted)
calls = {"gather": 0, "scatter": 0}


def blocks_gather(src, ids: Sequence[int], threads: int = 0, out=None):
    """``BlockCopies.gather``, building the library on first use."""
    return BlockCopies().gather(src, ids, threads, out)


def blocks_scatter(dst, ids: Sequence[int], src, threads: int = 0) -> None:
    """``BlockCopies.scatter``, building the library on first use."""
    BlockCopies().scatter(dst, ids, src, threads)


# ---------------------------------------------------------- the event queue

class NativeEventQueue:
    """Bounded queue native engines publish KV events into (C bindings parity)."""

    def __init__(self, capacity: int = 1 << 16) -> None:
        self._lib = load()
        self._h = self._lib.dyn_events_new(capacity)

    def __del__(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dyn_events_free(self._h)
            self._h = None

    def publish(self, kind: int, parent_hash: int, hashes: Sequence[int]) -> bool:
        a = _as_u64(hashes)
        return self._lib.dyn_events_publish(self._h, kind, parent_hash,
                                            a.ctypes.data_as(_u64p), len(a)) == 0

    def drain(self, max_events: int = 1024,
              hashes_cap: int = 1 << 16) -> list[tuple[int, int, list[int]]]:
        kinds = np.empty(max_events, dtype=np.int32)
        parents = np.empty(max_events, dtype=np.uint64)
        hashes = np.empty(hashes_cap, dtype=np.uint64)
        offsets = np.empty(max_events + 1, dtype=np.uint64)
        n = self._lib.dyn_events_drain(
            self._h, kinds.ctypes.data_as(_i32p), parents.ctypes.data_as(_u64p),
            hashes.ctypes.data_as(_u64p), hashes_cap, offsets.ctypes.data_as(_u64p),
            max_events)
        out = []
        for i in range(n):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            out.append((int(kinds[i]), int(parents[i]), [int(h) for h in hashes[lo:hi]]))
        return out

    @property
    def dropped(self) -> int:
        return self._lib.dyn_events_dropped(self._h)
