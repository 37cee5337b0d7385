"""Deployment tooling: packaged serving graphs (``deploy/packaging.py``),
k8s manifest rendering for GPU serving graphs (``deploy/renderer.py``) and
the operator that reconciles them (``deploy/operator.py``).

The counterpart of ``dynamo_tpu/deploy/``; the renderer's three
translations for the GPU are listed in its module docstring.
"""

from dynamo_tpu_torch.deploy.packaging import (
    PackageError,
    build_package,
    cache_lookup,
    cached_unpack,
    read_manifest,
    unpack_package,
)
from dynamo_tpu_torch.deploy.renderer import DeploymentSpec, render_manifests

__all__ = ["DeploymentSpec", "render_manifests", "build_package", "read_manifest",
           "unpack_package", "cache_lookup", "cached_unpack", "PackageError"]
