"""Packaged serving graphs: build / inspect / unpack (the "bento" flow).

A copy of the JAX package's ``deploy/packaging.py``: the same archive
layout, manifest fields, digests and checks, so either package unpacks
the other's archives.

Reference parity: the reference's api-store + CLI package a serving graph
(code + config + manifest) into a versioned archive that the operator and
``dynamo serve`` deploy from (deploy/dynamo/api-store, ~3k LoC Postgres +
S3).  Lean shape: a deterministic tar.gz of the graph's Python
sources plus a JSON manifest, stored versioned by an api-store
(components/api_store.py; the JAX package's store speaks the same REST
surface and either package's client talks to either store) —
weights do NOT ride in the package (a worker's model-path names them).

A package contains:

  manifest.json       {"format": 1, "name", "entry": "module:Service",
                       "files": {relpath: sha256}}
  src/<relpath...>    the graph's source tree (python + yaml configs)

``unpack_package`` verifies every hash and refuses path traversal, then
returns the src root — add it to sys.path / PYTHONPATH and hand
``manifest["entry"]`` to ServeSupervisor (cli: ``python -m
dynamo_tpu_torch serve --package name[:version]``).
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import shutil
import tarfile
from pathlib import Path
from typing import Optional

__all__ = ["build_package", "read_manifest", "unpack_package",
           "cache_lookup", "cached_unpack", "PackageError"]

FORMAT = 1
# what rides in a package: graph code + configs, nothing else (weights
# go through the model store; caches/VCS noise never ship)
_INCLUDE_SUFFIXES = {".py", ".yaml", ".yml", ".json", ".txt", ".md"}
_SKIP_PARTS = {"__pycache__", ".git", ".locks"}


class PackageError(ValueError):
    """Malformed, unverifiable, or unsafe package archive."""


def _iter_files(root: Path):
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = p.relative_to(root)
        if _SKIP_PARTS.intersection(rel.parts):
            continue
        if p.suffix.lower() in _INCLUDE_SUFFIXES:
            yield rel.as_posix(), p


def build_package(src_dir: str | Path, entry: str, name: str,
                  out_path: str | Path) -> dict:
    """Archive ``src_dir``'s graph sources into ``out_path`` (tar.gz).

    ``entry`` is the serve target relative to the package root, e.g.
    ``graphs.agg:Frontend`` — validated for shape here and resolved at
    deploy time (the build host may lack the runtime deps).  Returns the
    manifest.  The archive is deterministic (sorted members, zeroed
    mtimes) so re-building unchanged sources yields identical bytes —
    version bumps in the store then reflect real changes.
    """
    src = Path(src_dir)
    if not src.is_dir():
        raise PackageError(f"source dir {src} does not exist")
    if ":" not in entry:
        raise PackageError(
            f"entry {entry!r} must be 'module:Service' (relative to the "
            "package root)")
    files: dict[str, str] = {}
    members: list[tuple[str, Path]] = []
    for rel, p in _iter_files(src):
        files[rel] = hashlib.sha256(p.read_bytes()).hexdigest()
        members.append((rel, p))
    if not files:
        raise PackageError(f"no packageable sources under {src}")
    mod = entry.partition(":")[0]
    cand = mod.replace(".", "/")
    if f"{cand}.py" not in files and not any(
            r.startswith(f"{cand}/") for r in files):
        raise PackageError(
            f"entry module {mod!r} not found in the package sources")
    # no timestamp in the archive: the api-store stamps created_at on
    # push, and a build-time stamp would break byte-determinism
    manifest = {
        "format": FORMAT, "name": name, "entry": entry, "files": files,
    }
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    # mtime=0 + filename="" in the gzip header: tarfile's "w:gz" stamps
    # build time there, and GzipFile embeds the OUTPUT filename from the
    # fileobj — both would break the byte-determinism promised above
    with open(out, "wb") as fh, \
            gzip.GzipFile(fileobj=fh, mode="wb", mtime=0,
                          filename="") as gz, \
            tarfile.open(fileobj=gz, mode="w") as tf:
        mdata = json.dumps(manifest, sort_keys=True).encode()
        info = tarfile.TarInfo("manifest.json")
        info.size = len(mdata)
        tf.addfile(info, io.BytesIO(mdata))
        for rel, p in members:
            info = tarfile.TarInfo(f"src/{rel}")
            data = p.read_bytes()
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return manifest


def _open_archive(pkg) -> tarfile.TarFile:
    """Archive from a path OR raw bytes (the api-store keeps archives as
    sqlite blobs and never touches disk)."""
    try:
        if isinstance(pkg, (bytes, bytearray)):
            return tarfile.open(fileobj=io.BytesIO(pkg), mode="r:gz")
        return tarfile.open(pkg, "r:gz")
    except (tarfile.TarError, OSError) as e:
        raise PackageError(f"not a package archive: {e}") from None


def _load_manifest(tf: tarfile.TarFile) -> dict:
    try:
        f = tf.extractfile("manifest.json")
        manifest = json.loads(f.read())
    except KeyError:
        raise PackageError("archive has no manifest.json") from None
    except (ValueError, AttributeError) as e:
        # invalid JSON, or a directory member (extractfile -> None) —
        # both must surface as a 422-able PackageError, not a 500
        raise PackageError(f"bad manifest.json: {e}") from None
    _check_manifest(manifest)
    return manifest


def read_manifest(pkg) -> dict:
    """The manifest of a package archive (path or bytes), validated."""
    with _open_archive(pkg) as tf:
        return _load_manifest(tf)


def _check_manifest(manifest: dict) -> None:
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT:
        raise PackageError(f"unsupported package format: "
                           f"{manifest.get('format')!r}")
    for k in ("name", "entry", "files"):
        if not manifest.get(k):
            raise PackageError(f"manifest missing {k!r}")
    for rel in manifest["files"]:
        parts = Path(rel).parts
        if Path(rel).is_absolute() or ".." in parts:
            raise PackageError(f"manifest path escapes the package: {rel!r}")


def unpack_package(pkg_path: str | Path, dest: str | Path) -> tuple[dict, Path]:
    """Extract a package into ``dest`` (hash-verified, traversal-safe).

    Returns ``(manifest, src_root)``; put ``src_root`` on sys.path /
    PYTHONPATH and serve ``manifest['entry']``.
    """
    dest = Path(dest)
    # extract into a sibling temp dir and swap: extracting OVER an
    # existing dest would leave stale files from a prior unpack on the
    # importable src root — code outside the verified package
    tmp = dest.with_name(dest.name + ".extract-tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    with _open_archive(pkg_path) as tf:
        manifest = _load_manifest(tf)
        src_root = tmp / "src"
        for rel, want_sha in manifest["files"].items():
            member = f"src/{rel}"
            try:
                data = tf.extractfile(member).read()
            except (KeyError, AttributeError):
                raise PackageError(f"archive missing {member!r}") from None
            got = hashlib.sha256(data).hexdigest()
            if got != want_sha:
                raise PackageError(
                    f"hash mismatch for {rel!r}: manifest {want_sha[:12]} "
                    f"vs archive {got[:12]}")
            target = src_root / rel
            # rel was validated non-escaping, but belt-and-braces against
            # symlinked intermediates
            if not str(target.resolve()).startswith(str(tmp.resolve())):
                raise PackageError(f"unsafe extraction path {rel!r}")
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(data)
    (tmp / "manifest.json").write_text(json.dumps(manifest, sort_keys=True))
    if dest.exists():
        shutil.rmtree(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp.rename(dest)
    return manifest, dest / "src"


def cache_lookup(cache_root: str | Path, name: str,
                 version: int) -> Optional[tuple[dict, Path]]:
    """An existing verified unpack of (name, version), or None.  Lets
    callers skip the archive transfer entirely on a cache hit."""
    dest = Path(cache_root) / f"{name}-{version}"
    mf = dest / "manifest.json"
    if not mf.exists():
        return None
    try:
        manifest = json.loads(mf.read_text())
        _check_manifest(manifest)
        return manifest, dest / "src"
    except (ValueError, PackageError):
        return None  # damaged cache: caller re-extracts


def cached_unpack(pkg_path: str | Path, cache_root: str | Path,
                  name: str, version: int) -> tuple[dict, Path]:
    """Unpack into the per-(name, version) cache dir, reusing an existing
    verified unpack (the model-store cache idiom).  ``version`` is
    required: an unversioned "latest" cache dir would pin the first pull
    forever across newer pushes."""
    hit = cache_lookup(cache_root, name, version)
    if hit is not None:
        return hit
    return unpack_package(pkg_path, Path(cache_root) / f"{name}-{version}")
