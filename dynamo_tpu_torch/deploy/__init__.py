"""Deployment tooling: packaged serving graphs (``deploy/packaging.py``).

The JAX package's manifest renderer and operator are not ported (ROADMAP
A17).
"""

from dynamo_tpu_torch.deploy.packaging import (
    PackageError,
    build_package,
    cache_lookup,
    cached_unpack,
    read_manifest,
    unpack_package,
)

__all__ = ["build_package", "read_manifest", "unpack_package", "cache_lookup",
           "cached_unpack", "PackageError"]
