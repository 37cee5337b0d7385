"""The @service component model.

A copy of the JAX package's ``sdk/service.py`` on the port's runtime
(``runtime/engine.py``, ``runtime/distributed.py``): the same decorators,
the same component names (the class name lowercased) and the same
link-edge scoping, so a graph's services discover each other as they do
under the JAX package.

Reference parity: deploy/dynamo/sdk/src/dynamo/sdk/lib/service.py:71,220
(DynamoService), lib/decorators.py (@dynamo_endpoint), lib/dependency.py
(depends()), lib/bento.py (.link() graph edges + pruning, tested by
tests/test_link.py).

A service is a plain class; the decorator wraps it in a
:class:`DynamoService` carrying its namespace, endpoints, dependencies and
resource asks.  ``depends(Other)`` declares a cross-service client that is
injected at startup as a :class:`ServiceClient` (remote endpoint proxies
over the distributed runtime).  ``A.link(B)`` narrows a dependency edge to
a concrete provider and returns the linked graph entry.
"""

from __future__ import annotations

import inspect
import logging
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context

log = logging.getLogger("dynamo_tpu_torch.sdk")

__all__ = [
    "service",
    "dynamo_endpoint",
    "async_on_start",
    "depends",
    "Dependency",
    "DynamoService",
    "ServiceClient",
    "EndpointAdapter",
]


# ------------------------------------------------------------- decorators ----


def dynamo_endpoint(fn: Optional[Callable] = None, *, name: Optional[str] = None):
    """Mark an async method as a served endpoint (ref decorators.py:80)."""

    def wrap(f: Callable) -> Callable:
        f._dynamo_endpoint = name or f.__name__
        return f

    return wrap(fn) if fn is not None else wrap


def async_on_start(fn: Callable) -> Callable:
    """Mark an async method to run at worker startup (engine boot etc.)."""
    fn._dynamo_on_start = True
    return fn


class Dependency:
    """Declared with ``depends(Other)`` at class scope; resolved to a
    :class:`ServiceClient` when the worker starts."""

    def __init__(self, target: "DynamoService"):
        if not isinstance(target, DynamoService):
            raise TypeError("depends() takes a @service-decorated class")
        self.target = target
        self.attr: str = ""

    def __set_name__(self, owner, name):
        self.attr = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            return obj.__dict__[f"_dep_{self.attr}"]
        except KeyError:
            raise RuntimeError(
                f"dependency {self.attr!r} not wired — is the service running "
                "under serve_graph()/serve_worker?"
            ) from None


def depends(target: "DynamoService") -> Dependency:
    return Dependency(target)


def service(
    cls=None,
    *,
    dynamo: Optional[dict] = None,
    resources: Optional[dict] = None,
    workers: int = 1,
):
    """Class decorator: ``@service(dynamo={"namespace": ...},
    resources={"gpu": 1}, workers=2)`` (ref service.py:220)."""

    def wrap(c) -> DynamoService:
        return DynamoService(
            c, dynamo=dynamo or {}, resources=resources or {}, workers=workers
        )

    return wrap(cls) if cls is not None else wrap


# ---------------------------------------------------------------- service ----


@dataclass
class _EndpointSpec:
    name: str
    method: str  # attribute name on the inner class


class DynamoService:
    def __init__(self, inner: type, dynamo: dict, resources: dict, workers: int):
        self.inner = inner
        self.name = dynamo.get("name", inner.__name__)
        self.namespace = dynamo.get("namespace", "default")
        self.resources = resources
        self.workers = workers
        self.endpoints: list[_EndpointSpec] = [
            _EndpointSpec(ep, attr)
            for attr, member in vars(inner).items()
            if (ep := getattr(member, "_dynamo_endpoint", None))
        ]
        self.on_start_hooks: list[str] = [
            attr
            for attr, member in vars(inner).items()
            if getattr(member, "_dynamo_on_start", False)
        ]
        self.dependencies: list[Dependency] = [
            m for m in vars(inner).values() if isinstance(m, Dependency)
        ]
        # link edges carry the MODULE that created them: graph modules all
        # mutate these shared class objects at import, so a process that
        # imported several graphs holds their UNION — serving one graph
        # must be able to scope the closure to its own module's edges
        # (production `dynamo serve` imports one graph per process, but
        # in-process serving/tests import many)
        self._links: list[tuple[DynamoService, Optional[str]]] = []

    # component name in the runtime (Namespace→Component→Endpoint)
    @property
    def component(self) -> str:
        return self.name.lower()

    def __call__(self, *args, **kwargs):
        return self.inner(*args, **kwargs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"DynamoService({self.name}, ns={self.namespace})"

    # ------------------------------------------------------------------ graph
    def link(self, other: "DynamoService") -> "DynamoService":
        """Add an edge to the serving graph (ref bento.py .link); chainable:
        ``Frontend.link(Processor).link(Worker)`` returns the tail so the
        conventional one-liner builds a path graph from the entry.  The
        edge remembers the calling module, so a serve can scope to ONE
        graph module's edges (see ``closure``)."""
        import sys

        mod = sys._getframe(1).f_globals.get("__name__")
        self._links.append((other, mod))
        return other

    def closure(self, graph: Optional[str] = None) -> list["DynamoService"]:
        """Every service reachable from this entry via links and
        dependencies — the set `serve` actually deploys (unlinked services
        defined in the module are pruned, ref test_link.py).

        ``graph``: follow only link edges created by that module.  Graph
        modules mutate the SHARED component classes at import, so without
        scoping, a process that imported graphs A and B would deploy
        their union when serving either."""
        seen: dict[int, DynamoService] = {}

        def visit(svc: DynamoService) -> None:
            if id(svc) in seen:
                return
            seen[id(svc)] = svc
            for dep in svc.dependencies:
                visit(dep.target)
            for linked, mod in svc._links:
                if graph is None or mod == graph:
                    visit(linked)

        visit(self)
        return list(seen.values())

    def boot_order(self, graph: Optional[str] = None) -> list["DynamoService"]:
        """Closure in reverse-topological order (postorder DFS): every
        service appears after its dependencies/links, so booting in list
        order guarantees endpoints exist before their dependents start."""
        seen: set[int] = set()
        order: list[DynamoService] = []

        def visit(svc: DynamoService) -> None:
            if id(svc) in seen:
                return
            seen.add(id(svc))
            for dep in svc.dependencies:
                visit(dep.target)
            for linked, mod in svc._links:
                if graph is None or mod == graph:
                    visit(linked)
            order.append(svc)

        visit(self)
        return order


# ------------------------------------------------------- runtime adapters ----


class EndpointAdapter(AsyncEngine):
    """Bound endpoint method → AsyncEngine.  The method receives the
    request payload; async generators stream, plain coroutines yield one
    item."""

    def __init__(self, bound: Callable):
        self.bound = bound

    def generate(self, request: Context) -> AsyncIterator[Any]:
        return self._run(request)

    async def _run(self, request: Context) -> AsyncIterator[Any]:
        result = self.bound(request.data)
        if inspect.isasyncgen(result):
            async for item in result:
                if request.is_killed:
                    return
                yield item
        else:
            yield await result


class RemoteEndpoint:
    """Callable proxy for one endpoint of a dependency: ``dep.generate(x)``
    returns the response stream; ``.direct(x, instance_id)`` pins an
    instance (router modes, ref component/client.rs:52)."""

    def __init__(self, client_factory, endpoint: str):
        self._factory = client_factory
        self.endpoint = endpoint

    def __call__(self, payload: Any) -> AsyncIterator[Any]:
        return self._stream(payload, None)

    def direct(self, payload: Any, instance_id: int) -> AsyncIterator[Any]:
        return self._stream(payload, instance_id)

    async def _stream(self, payload: Any, instance_id: Optional[int]):
        client = await self._factory(self.endpoint)
        # one retry on a connection that breaks BEFORE the first item —
        # idempotent at that point (nothing was streamed), and exactly
        # the window where a stale pooled connection surfaces
        for attempt in (0, 1):
            ctx = Context(payload)
            stream = (
                client.direct(ctx, instance_id)
                if instance_id is not None
                else client.generate(ctx)
            )
            got_any = False
            try:
                async for item in stream:
                    got_any = True
                    yield item
                return
            except OSError:
                # ConnectionError plus gaierror/unreachable-host failures
                if got_any or attempt == 1:
                    raise

    async def instance_ids(self) -> list[int]:
        client = await self._factory(self.endpoint)
        return client.instance_ids()


class ServiceClient:
    """What a ``depends()`` attribute resolves to at runtime: attribute
    access gives a :class:`RemoteEndpoint` for that endpoint name."""

    def __init__(self, runtime, target: DynamoService):
        self._runtime = runtime
        self._target = target
        self._clients: dict[str, Any] = {}

    async def _client(self, endpoint: str):
        if endpoint not in self._clients:
            ep = (
                self._runtime.namespace(self._target.namespace)
                .component(self._target.component)
                .endpoint(endpoint)
            )
            self._clients[endpoint] = await ep.client()
        return self._clients[endpoint]

    def __getattr__(self, name: str) -> RemoteEndpoint:
        if name.startswith("_"):
            raise AttributeError(name)
        return RemoteEndpoint(self._client, name)

    async def close(self) -> None:
        for c in self._clients.values():
            await c.close()
