"""Model artifact distribution over the coordinator blob store.

A copy of the JAX package's ``llm/model_store.py`` on the port's
coordinator: the same manifest, blob keys and cache layout, so a model
pushed by either package's CLI is pulled by the other's.

Reference parity: the reference publishes the model card + tokenizer to
the NATS object store so remote workers self-serve their artifacts
(lib/llm/src/model_card/model.rs:150-199 move_to_nats/move_from_nats).
Here the coordinator's blob plane (transports/coordinator.py plane 4)
carries the WHOLE model directory — config, tokenizer, safetensors, a
native checkpoint or a GGUF file — so a multi-host graph needs the weights on one
host only: every other worker boots from a ``dyn://models/<name>`` ref,
pulls once, and caches under a content-addressed local directory.

Layout on the coordinator:

  KV   models/<name>            -> manifest {files: {rel: {size, sha256}},
                                   digest, pushed_at}
  blob models/<name>/<relpath>  -> file bytes (content-addressed on disk)

Pulls are concurrency-safe per host (download to a temp dir, atomic
rename into the cache; a lost race simply reuses the winner's copy) and
idempotent across restarts (the cache key is the manifest digest, so a
re-push with different bytes lands in a fresh directory).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.model_store")

__all__ = ["push_model", "pull_model", "resolve_model", "manifest_key",
           "is_model_ref", "DEFAULT_CACHE", "file_sha256", "verify_files"]

DEFAULT_CACHE = Path(os.environ.get(
    "DYNAMO_MODEL_CACHE", os.path.expanduser("~/.cache/dynamo_tpu_torch/models")
))
_REF_PREFIX = "dyn://models/"
# never shipped: transient HF artifacts and lock/cache noise
_SKIP_PARTS = {".locks", "__pycache__", ".git"}


def file_sha256(path: str | Path, chunk_size: int = 1 << 20) -> str:
    """Streaming sha256 of a file on disk.  Shared integrity primitive:
    model pulls verify manifest hashes with it, and the persistent KV
    tier (llm/kv/persist.py) verifies block-group files against their
    header digest with the same helper."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def verify_files(root: str | Path, files: dict) -> list[str]:
    """Check every manifest entry under ``root`` against its recorded
    sha256.  Returns the rel paths that are missing or corrupt (size
    mismatch short-circuits the hash)."""
    root = Path(root)
    bad: list[str] = []
    for rel, info in files.items():
        p = root / rel
        if not p.is_file():
            bad.append(rel)
            continue
        size = info.get("size")
        if size is not None and p.stat().st_size != size:
            bad.append(rel)
            continue
        if file_sha256(p) != info["sha256"]:
            bad.append(rel)
    return bad


def _check_rel(name: str, rel: str) -> None:
    """The manifest is UNTRUSTED (any coordinator client can write it): a
    '..' segment or absolute path must never escape the cache directory."""
    relp = Path(rel)
    if (not rel or relp.is_absolute()
            or any(part in ("..", "") for part in relp.parts)):
        raise IOError(
            f"model {name!r}: manifest entry {rel!r} is not a "
            "safe relative path"
        )


def manifest_key(name: str) -> str:
    return f"models/{name}"


def _blob_key(name: str, rel: str) -> str:
    """Blob key with the model name slash-quoted: 'meta/llama' +
    'config.json' must never collide with model 'meta' + file
    'llama/config.json'."""
    from urllib.parse import quote

    return f"models/{quote(name, safe='')}/{rel}"


def is_model_ref(ref: str) -> bool:
    return isinstance(ref, str) and ref.startswith(_REF_PREFIX)


def _ref_name(ref: str) -> str:
    name = ref[len(_REF_PREFIX):].strip("/")
    if not name:
        raise ValueError(f"empty model name in ref {ref!r}")
    return name


def _iter_files(root: Path):
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        if any(part in _SKIP_PARTS for part in p.relative_to(root).parts):
            continue
        yield p


async def push_model(coordinator, name: str, model_dir: str | Path) -> dict:
    """Upload every file under ``model_dir`` and publish the manifest.
    Returns the manifest."""
    root = Path(model_dir)
    if not root.is_dir():
        raise FileNotFoundError(f"model dir {root} does not exist")
    files: dict[str, dict] = {}
    for p in _iter_files(root):
        rel = p.relative_to(root).as_posix()
        info = await coordinator.blob_put(
            _blob_key(name, rel), p, meta={"model": name, "rel": rel}
        )
        files[rel] = info
        log.info("pushed %s/%s (%d bytes)", name, rel, info["size"])
    if not files:
        raise FileNotFoundError(f"model dir {root} is empty")
    digest = hashlib.sha256(json.dumps(
        {r: f["sha256"] for r, f in sorted(files.items())},
        sort_keys=True, separators=(",", ":"),
    ).encode()).hexdigest()
    manifest = {"name": name, "files": files, "digest": digest,
                "pushed_at": time.time()}
    await coordinator.kv_put(manifest_key(name), manifest)
    return manifest


async def pull_model(coordinator, name: str,
                     cache_dir: Optional[str | Path] = None) -> Path:
    """Materialise model ``name`` locally; returns the directory.  A
    cache hit (same manifest digest) downloads nothing."""
    manifest = await coordinator.kv_get(manifest_key(name))
    if manifest is None:
        raise FileNotFoundError(
            f"model {name!r} not found in the coordinator store "
            f"(push it with `models push {name} <dir>`)"
        )
    cache = Path(cache_dir) if cache_dir else DEFAULT_CACHE
    cache.mkdir(parents=True, exist_ok=True)
    target = cache / f"{name.replace('/', '--')}-{manifest['digest'][:12]}"
    if target.exists():
        # the cache directory is content-addressed by manifest digest, but
        # the FILES inside are not self-verifying: a torn write or disk
        # fault leaves a directory that exists yet serves corrupt weights.
        # Verify per-file hashes against the manifest and re-pull only the
        # corrupt/missing ones.  Hashing runs in a worker thread — this
        # coroutine may share its loop with live serving.
        import asyncio

        for rel in manifest["files"]:
            _check_rel(name, rel)
        bad = await asyncio.to_thread(verify_files, target, manifest["files"])
        for rel in bad:
            log.warning("model %s: cached file %s corrupt/missing; re-pulling",
                        name, rel)
            dest = target / rel
            dest.parent.mkdir(parents=True, exist_ok=True)
            try:
                await coordinator.blob_get(_blob_key(name, rel), dest)
            except KeyError:
                legacy = f"models/{name}/{rel}"
                if legacy == _blob_key(name, rel):
                    raise
                await coordinator.blob_get(legacy, dest)
        if bad:
            still = await asyncio.to_thread(
                verify_files, target,
                {r: manifest["files"][r] for r in bad})
            if still:
                raise IOError(
                    f"model {name!r}: files {still} still corrupt after "
                    "re-pull (store itself damaged?)")
        return target
    tmp = Path(tempfile.mkdtemp(dir=cache, prefix=".pull-"))
    try:
        for rel, info in manifest["files"].items():
            _check_rel(name, rel)
            dest = tmp / rel
            dest.parent.mkdir(parents=True, exist_ok=True)
            try:
                got = await coordinator.blob_get(_blob_key(name, rel), dest)
            except KeyError:
                # stores written before name-quoting used the raw name
                legacy = f"models/{name}/{rel}"
                if legacy == _blob_key(name, rel):
                    raise
                got = await coordinator.blob_get(legacy, dest)
            if got["sha256"] != info["sha256"]:
                raise IOError(
                    f"blob models/{name}/{rel}: digest mismatch "
                    f"(store re-pushed mid-pull?) — retry the pull"
                )
        try:
            tmp.rename(target)  # atomic publish of the complete dir
        except OSError:
            if not target.exists():  # a real failure, not a lost race
                raise
        return target
    finally:
        if tmp.exists():
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)


async def resolve_model(ref: str, coordinator=None,
                        cache_dir: Optional[str | Path] = None) -> str:
    """``dyn://models/<name>`` -> local cached path (pulling if needed);
    anything else passes through unchanged."""
    if not is_model_ref(ref):
        return ref
    if coordinator is None:
        raise ValueError(
            f"model ref {ref!r} needs a coordinator connection "
            "(--coordinator) to pull from"
        )
    return str(await pull_model(coordinator, _ref_name(ref), cache_dir))


def resolve_model_sync(ref: str, coordinator_url: Optional[str],
                       cache_dir: Optional[str | Path] = None) -> str:
    """Blocking :func:`resolve_model` for synchronous callers (the engine
    builders): the pull runs on a private event loop in a worker thread,
    safe whether or not a loop is already running in this thread.

    Caveat: this BLOCKS the calling thread — do not call it from the very
    event loop that serves the target coordinator (an in-process server
    could never answer the pull; production coordinators are separate
    processes, so worker engine builders are fine)."""
    if not is_model_ref(ref):
        return ref
    if not coordinator_url:
        raise ValueError(
            f"model ref {ref!r} needs a coordinator URL (--coordinator / "
            "DYNTPU_COORDINATOR) to pull from"
        )

    async def go() -> str:
        from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorClient

        c = await CoordinatorClient(coordinator_url).connect()
        try:
            return await resolve_model(ref, c, cache_dir)
        finally:
            await c.close()

    import asyncio
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        return ex.submit(lambda: asyncio.run(go())).result()
