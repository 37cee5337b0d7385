"""DynamoTpuDeployment spec → Kubernetes manifests.

The counterpart of ``dynamo_tpu/deploy/renderer.py``, field for field,
with three translations for the GPU:

* a service's accelerator block is ``gpu: {count, product}``: it renders
  ``nvidia.com/gpu`` requests and limits, plus a ``nvidia.com/gpu.product``
  nodeSelector (the GPU operator's feature-discovery label) when
  ``product`` is given;
* a ``tpu:`` block is refused by name when the spec is loaded;
* the containers this module writes (coordinator, frontend, metrics) start
  the port's own CLI, ``python3 -m dynamo_tpu_torch``, where the JAX
  package's start ``dynamo-tpu``.

Everything else — object names, labels, the coordinator URL, environment,
ports, the autoscale block the operator reads — is the JAX package's, so
the two renderers' manifests differ only in those places.  Reference
parity: deploy/dynamo/operator/api/v1alpha1/dynamodeployment_types.go:31
(DynamoDeployment CRD → per-service Deployments, Services, autoscaling);
the coordinator replaces etcd+NATS as one lightweight Deployment.

Spec shape (YAML):

    name: llama-disagg
    namespace: default
    image: dynamo-tpu:latest
    coordinator: {}                      # optional overrides
    frontend: {replicas: 1, port: 8080}
    services:
      decode:
        command: ["python3", "-m", "dynamo_tpu_torch", "run",
                  "in=dyn://dynamo.decode.generate", "out=gpu"]
        replicas: 2
        gpu: {count: 1, product: NVIDIA-H100-80GB-HBM3}
      prefill:
        command: [...]
        replicas: 4
        gpu: {count: 1}
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import yaml

__all__ = ["DeploymentSpec", "ServiceSpec", "render_manifests", "render_to_dir", "CLI"]

_GPU_RESOURCE = "nvidia.com/gpu"
_GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"
# the port's command line, as a container starts it
CLI = ["python3", "-m", "dynamo_tpu_torch"]


@dataclass
class ServiceSpec:
    name: str
    command: list[str]
    replicas: int = 1
    gpu_count: int = 0
    gpu_product: Optional[str] = None   # e.g. "NVIDIA-H100-80GB-HBM3"
    env: dict[str, str] = field(default_factory=dict)
    port: Optional[int] = None
    # autoscale block the operator levels on (deploy/operator.py):
    # {min, max, target_per_replica, queue?, signal?, target_usage?}.  The operator levels replicas toward
    # ceil(depth / target_per_replica) within [min, max]; ``queue``
    # defaults to the service's dyn:// namespace prefill queue.
    autoscale: Optional[dict] = None


@dataclass
class DeploymentSpec:
    name: str
    image: str
    namespace: str = "default"
    services: list[ServiceSpec] = field(default_factory=list)
    frontend_port: int = 8080
    frontend_replicas: int = 1
    coordinator_port: int = 6180
    metrics_port: int = 9091

    @classmethod
    def from_yaml(cls, path_or_text: str | Path) -> "DeploymentSpec":
        p = Path(path_or_text)
        text = p.read_text() if p.exists() else str(path_or_text)
        return cls.from_dict(yaml.safe_load(text))

    @classmethod
    def from_dict(cls, d: dict) -> "DeploymentSpec":
        services = []
        for name, s in (d.get("services") or {}).items():
            if "tpu" in s:
                raise ValueError(
                    f"service {name!r}: a tpu: block is the JAX package's (GKE TPU node "
                    "pools); this renderer places GPU services, gpu: {count, product}")
            gpu = s.get("gpu") or {}
            services.append(
                ServiceSpec(
                    name=name,
                    command=list(s["command"]),
                    replicas=int(s.get("replicas", 1)),
                    gpu_count=int(gpu.get("count", 0)),
                    gpu_product=gpu.get("product"),
                    env={k: str(v) for k, v in (s.get("env") or {}).items()},
                    port=s.get("port"),
                    autoscale=s.get("autoscale"),
                )
            )
        fe = d.get("frontend") or {}
        return cls(
            name=d["name"],
            image=d["image"],
            namespace=d.get("namespace", "default"),
            services=services,
            frontend_port=int(fe.get("port", 8080)),
            frontend_replicas=int(fe.get("replicas", 1)),
            coordinator_port=int((d.get("coordinator") or {}).get("port", 6180)),
            metrics_port=int((d.get("metrics") or {}).get("port", 9091)),
        )


def _labels(spec: DeploymentSpec, component: str) -> dict:
    return {
        "app.kubernetes.io/name": "dynamo-tpu",
        "app.kubernetes.io/instance": spec.name,
        "app.kubernetes.io/component": component,
    }


def _deployment(
    spec: DeploymentSpec,
    component: str,
    command: list[str],
    replicas: int,
    env: dict[str, str],
    port: Optional[int] = None,
    svc: Optional[ServiceSpec] = None,
) -> dict:
    labels = _labels(spec, component)
    container: dict[str, Any] = {
        "name": component,
        "image": spec.image,
        "command": command,
        "env": [{"name": k, "value": v} for k, v in env.items()],
    }
    if port:
        container["ports"] = [{"containerPort": port}]
    pod_spec: dict[str, Any] = {"containers": [container]}
    if svc is not None and svc.gpu_count > 0:
        container["resources"] = {
            "requests": {_GPU_RESOURCE: str(svc.gpu_count)},
            "limits": {_GPU_RESOURCE: str(svc.gpu_count)},
        }
        if svc.gpu_product:
            pod_spec["nodeSelector"] = {_GPU_PRODUCT_LABEL: svc.gpu_product}
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": f"{spec.name}-{component}",
            "namespace": spec.namespace,
            "labels": labels,
        },
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": labels},
            "template": {
                "metadata": {"labels": labels},
                "spec": pod_spec,
            },
        },
    }


def _service(spec: DeploymentSpec, component: str, port: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"{spec.name}-{component}",
            "namespace": spec.namespace,
            "labels": _labels(spec, component),
        },
        "spec": {
            "selector": _labels(spec, component),
            "ports": [{"port": port, "targetPort": port}],
        },
    }


def render_manifests(spec: DeploymentSpec) -> list[dict]:
    """All k8s objects for a deployment: coordinator, frontend, metrics,
    and one Deployment per worker service."""
    coord_url = f"tcp://{spec.name}-coordinator.{spec.namespace}.svc:{spec.coordinator_port}"
    base_env = {"DYNTPU_COORDINATOR": coord_url}

    out = [
        _deployment(
            spec, "coordinator",
            [*CLI, "coordinator", "--port", str(spec.coordinator_port)],
            1, {}, port=spec.coordinator_port,
        ),
        _service(spec, "coordinator", spec.coordinator_port),
        _deployment(
            spec, "frontend",
            [*CLI, "http", "--host", "0.0.0.0",
             "--http-port", str(spec.frontend_port),
             "--coordinator", coord_url],
            spec.frontend_replicas, base_env, port=spec.frontend_port,
        ),
        _service(spec, "frontend", spec.frontend_port),
        _deployment(
            spec, "metrics",
            [*CLI, "metrics", "--host", "0.0.0.0",
             "--port", str(spec.metrics_port), "--coordinator", coord_url],
            1, base_env, port=spec.metrics_port,
        ),
        _service(spec, "metrics", spec.metrics_port),
    ]
    for svc in spec.services:
        env = dict(base_env)
        env.update(svc.env)
        cmd = list(svc.command)
        if "--coordinator" not in cmd:
            cmd += ["--coordinator", coord_url]
        out.append(
            _deployment(spec, svc.name, cmd, svc.replicas, env, port=svc.port, svc=svc)
        )
        if svc.port:
            out.append(_service(spec, svc.name, svc.port))
    return out


def render_to_dir(spec: DeploymentSpec, out_dir: str | Path) -> list[Path]:
    """Write one YAML file per object; returns the paths."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for obj in render_manifests(spec):
        kind = obj["kind"].lower()
        name = obj["metadata"]["name"]
        p = out / f"{name}-{kind}.yaml"
        p.write_text(yaml.safe_dump(obj, sort_keys=False))
        paths.append(p)
    return paths
