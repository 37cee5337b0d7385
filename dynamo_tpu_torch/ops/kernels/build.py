"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
process per source, all started together), linked into one shared library
with a plain C interface, and loaded with ``ctypes``.  The library lands in
``dynamo_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged tree loads the
existing library.  Nothing here runs at import time: the first kernel launch
builds.  A failed build raises.

:func:`geometry` reads ``csrc/launch_geometry.cuh``, the launch geometry the
redesigned kernels compile with, so the wrappers plan their launches from
the same numbers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["library", "build_library", "check", "geometry", "sm_count", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    # q, cache, block_tables, seq_lens, q0_pos, out, workspace, tickets,
    # B, S, H, Hk, D, N, Bs, M, layer, chunk, n_chunks, rows, row_groups,
    # sm_scale, logit_cap, stream
    "dynamo_decode_attention": [_P] * 8 + [_I] * 13 + [_F, _F, _P],
    # q, k_new, v_new, cache, block_tables, seq_lens, start, out,
    # B, S, H, Hk, D, N, Bs, M, layer, tq, tiles, sm_scale, logit_cap, stream
    "dynamo_prefill_attention": [_P] * 8 + [_I] * 11 + [_F, _F, _P],
    # q, k_new, v_new, cache, block_tables, seq_lens, starts, row_offsets, out,
    # T, H, Hk, D, N, Bs, M, R, layer, tq, span_blocks, sm_scale, logit_cap, stream
    "dynamo_ragged_prefill_attention": [_P] * 9 + [_I] * 11 + [_F, _F, _P],
    # the three over an int8 cache: its scale pool follows the cache
    # pointer, and Hp, Sp (the scale tile) follow the shapes
    # q, cache, scale, block_tables, seq_lens, q0_pos, out, workspace, tickets,
    # B, S, H, Hk, D, N, Bs, M, layer, Hp, Sp, chunk, n_chunks, rows,
    # row_groups, sm_scale, logit_cap, stream
    "dynamo_decode_attention_q8": [_P] * 9 + [_I] * 15 + [_F, _F, _P],
    # q, k_new, v_new, cache, scale, block_tables, seq_lens, start, out,
    # B, S, H, Hk, D, N, Bs, M, layer, Hp, Sp, tq, tiles, sm_scale, logit_cap, stream
    "dynamo_prefill_attention_q8": [_P] * 9 + [_I] * 13 + [_F, _F, _P],
    # q, k_new, v_new, cache, scale, block_tables, seq_lens, starts,
    # row_offsets, out, T, H, Hk, D, N, Bs, M, R, layer, Hp, Sp, tq,
    # span_blocks, sm_scale, logit_cap, stream
    "dynamo_ragged_prefill_attention_q8": [_P] * 10 + [_I] * 13 + [_F, _F, _P],
    # x, w, scale, out, partials, tickets, M, N, K, w_nk, out_f32, grid_n,
    # grid_m, splits, k_steps, stream
    "dynamo_int8_matmul": [_P] * 6 + [_I] * 9 + [_P],
    # x, w, scale, offsets, out, R, N, K, E, quant, rows, grid_n, blocks, stream
    "dynamo_grouped_matmul": [_P] * 5 + [_I] * 8 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


@functools.lru_cache(maxsize=None)
def geometry() -> dict[str, int]:
    """The ``#define DYN_<NAME> <integer>`` lines of
    ``csrc/launch_geometry.cuh``, by NAME."""
    text = (CSRC / "launch_geometry.cuh").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(r"^#define DYN_(\w+) (\d+)\b", text, re.M)}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the planners
    size split work by it)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> tuple[list[Path], list[Path]]:
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_key() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library(verbose: bool = False) -> Path:
    """Compile and link the kernels unless a library for these exact
    sources exists; returns its path."""
    cu, _ = _sources()
    out = BUILD_DIR / f"libdynamo_kernels-{_source_key()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cu]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cu, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src, log) for src, p, log in zip(cu, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {src.name}\n{log}" for src, log in failed))
        if verbose:
            for src, log in zip(cu, logs):
                print(f"--- {src.name}\n{log}", flush=True)
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(staged, out)  # atomic: a reader never sees a partial library
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
