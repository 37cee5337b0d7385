"""Endpoint addressing — dyn:// URL parsing.

A copy of the JAX package's ``runtime/protocols.py``.

Reference parity: lib/runtime/src/protocols.rs:33-49 (Endpoint
{namespace, component, name} parsed from "dyn://ns.component.endpoint",
with dotted shorthand variants).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["EndpointAddress", "parse_endpoint_url"]

SCHEME = "dyn://"


@dataclass(frozen=True)
class EndpointAddress:
    namespace: str
    component: str
    name: str

    @property
    def url(self) -> str:
        return f"{SCHEME}{self.namespace}.{self.component}.{self.name}"

    def __iter__(self):
        """Unpack as (namespace, component, name)."""
        return iter((self.namespace, self.component, self.name))


def parse_endpoint_url(url: str, default_namespace: str = "dynamo") -> EndpointAddress:
    """Parse "dyn://ns.component.endpoint"; "component.endpoint" gets the
    default namespace (the reference accepts the same shorthand)."""
    body = url[len(SCHEME):] if url.startswith(SCHEME) else url
    parts = [p for p in body.split(".") if p]
    if len(parts) == 2:
        parts = [default_namespace, *parts]
    if len(parts) != 3:
        raise ValueError(
            f"bad endpoint url {url!r}: want dyn://namespace.component.endpoint"
        )
    return EndpointAddress(*parts)
